"""K1: fused European call/put Monte Carlo (``csrc/vanilla.cu``).

Counterpart of :mod:`mctpu.kernels.vanilla`.  Per simulation block: seed the
stream with ``(seed, block_offset + b)``, draw one normal pair per tile
element and iteration, take one terminal GBM step per branch, and sum the
payoffs and their squares.  :func:`partials` launches the CUDA kernel for a
CUDA operand and runs :func:`plain_partials`, the same function in plain
PyTorch over the same stream, for a CPU operand.
"""
from __future__ import annotations

import ctypes

import torch

from mctpu_torch import _build
from mctpu_torch.kernels.common import (LANES, Plan, acc_add, acc_final,
                                        acc_init, block_keys, check_operand,
                                        draw_normal_pair, tile_index)
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import VanillaOption

__all__ = ["make_plan", "params", "plain_partials", "partials", "LAUNCHES"]

# Launches of the CUDA kernel in this process, by kernel name.
LAUNCHES = {"vanilla": 0}


def make_plan(n_paths: int, num_blocks: int, rows: int, antithetic: bool,
              kahan: bool = True) -> Plan:
    units = 2 * rows * LANES  # both Box-Muller branches per iteration
    paths = units * (2 if antithetic else 1)
    return Plan.plan(n_paths, num_blocks, rows, paths, units, antithetic,
                     kahan)


def params(opt: VanillaOption, device) -> torch.Tensor:
    """``[s0, k, mu, sig]`` in float32, formed in float32 on the CPU in the
    JAX kernel's expression order, then moved to ``device``."""
    s, k, r, v, t = (torch.tensor(float(x), dtype=torch.float32)
                     for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
    mu = (r - 0.5 * v * v) * t
    sig = v * torch.sqrt(t)
    return torch.stack([s, k, mu, sig]).to(device)


def _payoffs(s0, k, mu, sig, z, antithetic: bool, put: bool):
    if put:
        def pay(zz):
            return torch.clamp(k - s0 * torch.exp(mu + sig * zz), min=0.0)
    else:
        def pay(zz):
            return torch.clamp(s0 * torch.exp(mu + sig * zz) - k, min=0.0)
    if antithetic:
        return 0.5 * (pay(z) + pay(-z))
    return pay(z)


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, put: bool) -> torch.Tensor:
    """Per-block ``[sum_p, sum_p2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``par``'s device; one ``(n_blocks, rows * 128)`` tile per
    iteration."""
    dev = par.device
    s0, k, mu, sig = par[0], par[1], par[2], par[3]
    key = block_keys(seed, [block_offset + b for b in range(n_blocks)], dev)
    idx = tile_index(plan.rows * LANES, dev)
    carry = acc_init(n_blocks, dev)
    for i in range(plan.iters):
        z1, z2 = draw_normal_pair(key, idx, i)
        p1 = _payoffs(s0, k, mu, sig, z1, plan.antithetic, put)
        p2 = _payoffs(s0, k, mu, sig, z2, plan.antithetic, put)
        cs = p1.sum(1) + p2.sum(1)
        cs2 = (p1 * p1).sum(1) + (p2 * p2).sum(1)
        carry = acc_add(carry, cs, cs2, plan.kahan)
    return acc_final(carry)


def _cuda_partials(par, seed, block_offset, plan, n_blocks, put):
    check_operand("par", par, (4,), par.device)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    lib = _build.library()
    with torch.cuda.device(par.device):
        out = torch.empty((n_blocks, 2), dtype=torch.float32,
                          device=par.device)
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mctpu_vanilla(
            par.data_ptr(), wrap_int32(seed), wrap_int32(block_offset),
            n_blocks, plan.rows, plan.iters, int(plan.antithetic), int(put),
            int(plan.kahan), out.data_ptr(), ctypes.c_void_p(stream))
    _build.check(status, "vanilla")
    LAUNCHES["vanilla"] += 1
    return out


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, put: bool) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: the CUDA kernel for a CUDA
    ``par``, the plain version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        return _cuda_partials(par, seed, block_offset, plan, n_blocks, put)
    if par.device.type == "cpu":
        return plain_partials(par, seed, block_offset, plan, n_blocks, put)
    raise ValueError(f"unsupported device {par.device}")
