"""K4: fused CVA Monte Carlo — exposure walk over a time grid (``csrc/cva.cu``).

Counterpart of :mod:`mctpu.kernels.cva` (the price kernel; its Greeks come
later).  Each path walks a log-space GBM over ``n_grid`` steps; at node
``j`` the netted exposure ``max(sum_m w_m BS(S_j, k_m, T - t_j), 0)`` (Hastings
CDF, intrinsic at the last node) is weighted by the default mass ``dp_j``
(or a path-dependent wrong-way hazard), giving the per-path default leg
``lgd * sum_j dp_j ee_j``; the per-node exposure sums form the EE profile.

The node constants are computed once here, in float32 on the CPU in the JAX
kernel's expression order, and moved to the device, so the kernel and its
plain version read identical tables.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mctpu_torch import _build
from mctpu_torch import math as mcmath
from mctpu_torch.kernels.common import (LANES, Plan, acc_add, acc_final,
                                        acc_init, block_keys, tile_index,
                                        walk_pairwise)
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import CvaPortfolioSpec
from mctpu_torch.utils.accum import ds_add

__all__ = ["make_plan", "Operands", "node_constants", "bs_node_constants",
           "wwr_node_constants", "operands", "plain_partials", "partials",
           "LAUNCHES"]

# Launches of the CUDA kernel in this process, by kernel name.
LAUNCHES = {"cva": 0}


def make_plan(n_paths: int, num_blocks: int, rows: int, antithetic: bool,
              kahan: bool = True, ds: bool = False) -> Plan:
    units = rows * LANES  # one (rows, 128) tile walks the grid per iteration
    paths = units * (2 if antithetic else 1)
    return Plan.plan(n_paths, num_blocks, rows, paths, units, antithetic,
                     kahan, ds)


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32)


def _grid(port: CvaPortfolioSpec):
    g = port.n_grid
    return g, _f32(port.t), torch.arange(1, g + 1, dtype=torch.float32)


def node_constants(port: CvaPortfolioSpec):
    """``(dp, t_rem, drift, vol)``: default-leg masses and remaining
    maturities per node, and the per-step GBM drift and vol (float32)."""
    g, t, j = _grid(port)
    r, v = _f32(port.r), _f32(port.v)
    dp = mcmath.default_leg_weights(port.intensity, port.t, g,
                                    dtype=torch.float32)
    t_rem = t * (g - j) / g
    dt = t / g
    drift = (r - 0.5 * v * v) * dt
    vol = v * torch.sqrt(dt)
    return dp, t_rem, drift, vol


def bs_node_constants(port: CvaPortfolioSpec):
    """``(c1, isig, vsig, disc)`` per node: ``d1 = (log s - log k + c1) *
    isig``, ``d2 = d1 - vsig``, price ``s N(d1) - k disc N(d2)``; the last
    node (zero remaining maturity) is clamped and takes the intrinsic."""
    g, t, j = _grid(port)
    r, v = _f32(port.r), _f32(port.v)
    t_rem = t * (g - j) / g
    t_safe = torch.clamp(t_rem, min=float(np.float32(1e-12)))
    vsig = v * torch.sqrt(t_safe)
    c1 = (r + 0.5 * v * v) * t_safe
    isig = 1.0 / vsig
    disc = torch.exp(-r * t_safe)
    return c1, isig, vsig, disc


def wwr_node_constants(port: CvaPortfolioSpec):
    """``(mu, inv_sig)`` standardizing ``ln(S_j / S_0)`` per node."""
    g, t, j = _grid(port)
    r, v = _f32(port.r), _f32(port.v)
    t_j = t * j / g
    mu = (r - 0.5 * v * v) * t_j
    inv_sig = 1.0 / (v * torch.sqrt(t_j))
    return mu, inv_sig


@dataclasses.dataclass(frozen=True)
class Operands:
    """Kernel operands, all float32: ``scal`` ``(10,)`` = s, r, v, lgd,
    drift, vol, intensity, wwr_b, dt, log s0; ``opts`` ``(3, M)`` =
    strikes, weights, log strikes; ``nodes`` ``(7, n_grid)`` = dp, c1,
    isig_bs, vsig, disc, mu, isig."""

    scal: torch.Tensor
    opts: torch.Tensor
    nodes: torch.Tensor

    @property
    def n_options(self) -> int:
        return self.opts.shape[1]

    @property
    def n_grid(self) -> int:
        return self.nodes.shape[1]

    @property
    def device(self) -> torch.device:
        return self.scal.device


def operands(port: CvaPortfolioSpec, device) -> Operands:
    """The kernel operands of ``port``, formed on the CPU, on ``device``."""
    dp, _, drift, vol = node_constants(port)
    c1, isig_bs, vsig, disc = bs_node_constants(port)
    mu, isig = wwr_node_constants(port)
    strikes, weights = _f32(port.strikes), _f32(port.weights)
    s, t = _f32(port.s), _f32(port.t)
    scal = torch.stack([s, _f32(port.r), _f32(port.v), _f32(port.lgd), drift,
                        vol, _f32(port.intensity), _f32(port.wwr_b),
                        t / port.n_grid, torch.log(s)])
    opts = torch.stack([strikes, weights, torch.log(strikes)])
    nodes = torch.stack([dp, c1, isig_bs, vsig, disc, mu, isig])
    return Operands(scal=scal.to(device), opts=opts.contiguous().to(device),
                    nodes=nodes.contiguous().to(device))


def _wwr_hazard_step(log_rel, surv, mu_j, isig_j, lam, bw, dt):
    """Wrong-way hazard ``h = lam exp(bw z - bw^2/2)`` at one node: new
    survival and this node's default mass (series form for small ``h dt``,
    the JAX kernel's guard against cancellation)."""
    zstd = (log_rel - mu_j) * isig_j
    h = lam * torch.exp(bw * zstd - 0.5 * bw * bw)
    y = h * dt
    series = y * (1.0 + y * (-0.5 + y * (1.0 / 6.0)))
    dp = surv * torch.where(y < 0.01, series, 1.0 - torch.exp(-y))
    return surv - dp, dp


def _exposure_log(s, log_s, opts, c1_j, isig_j, vsig_j, disc_j, last: bool,
                  log_lo=None):
    """Netted exposure at one node from the log-space walk state;
    ``log_lo`` is the double-single low word (``F32_DS``)."""
    strikes, weights, log_k = opts
    value = None
    for m in range(opts.shape[1]):
        if last:
            v_m = torch.clamp(s - strikes[m], min=0.0)
        else:
            d1 = (log_s - log_k[m] + c1_j) * isig_j
            if log_lo is not None:
                d1 = d1 + log_lo * isig_j
            d2 = d1 - vsig_j
            v_m = s * mcmath.norm_cdf_hastings(d1) \
                - strikes[m] * disc_j * mcmath.norm_cdf_hastings(d2)
        term = weights[m] * v_m
        value = term if value is None else value + term
    return torch.clamp(value, min=0.0)


def plain_partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
                   n_blocks: int, wwr: bool):
    """``((n_blocks, 2) [sum, sum2], (n_blocks, n_grid) exposure sums)`` in
    plain PyTorch on the operands' device; one ``(n_blocks, rows * 128)``
    tile walks the grid per iteration."""
    dev = ops.device
    g = ops.n_grid
    _, _, _, lgd, drift, vol, lam, bw, dt, log_s0 = ops.scal.unbind()
    dp, c1, isig_bs, vsig, disc, mu, isig = ops.nodes.unbind()
    shape = (n_blocks, plan.rows * LANES)
    idx = tile_index(shape[1], dev)
    prof = torch.zeros((n_blocks, g, LANES), dtype=torch.float32, device=dev)
    comp = torch.zeros_like(prof)
    sgn_half = 0.5 if plan.antithetic else 1.0
    carry = acc_init(n_blocks, dev)

    def step(j, z, state, sgn):
        log_st, surv, acc = state
        inc = drift + vol * (sgn * z)
        last = j == g - 1
        if plan.ds:
            hi, lo = ds_add(log_st[0], log_st[1], inc)
            log_st = (hi, lo)
            s = torch.exp(hi) * (1.0 + lo)
            ee = _exposure_log(s, hi, ops.opts, c1[j], isig_bs[j], vsig[j],
                               disc[j], last, log_lo=lo)
            log_rel = (hi - log_s0) + lo
        else:
            log_st = log_st + inc
            s = torch.exp(log_st)
            ee = _exposure_log(s, log_st, ops.opts, c1[j], isig_bs[j],
                               vsig[j], disc[j], last)
            log_rel = log_st - log_s0
        if wwr:
            surv, dp_j = _wwr_hazard_step(log_rel, surv, mu[j], isig[j], lam,
                                          bw, dt)
        else:
            dp_j = dp[j]
        acc = acc + dp_j * ee
        # Exposure profile: per-lane row sums, Kahan-added over iterations
        # exactly as the TPU kernel does (its fold adds the compensation).
        row = sgn_half * ee.view(n_blocks, plan.rows, LANES).sum(1)
        if plan.kahan:
            y = row - comp[:, j]
            acc_j = prof[:, j]
            t = acc_j + y
            comp[:, j] = (t - acc_j) - y
            prof[:, j] = t
        else:
            prof[:, j] += row
        return log_st, surv, acc

    def walk(key, sgn):
        full = log_s0.expand(shape)
        zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
        init = ((full, zeros) if plan.ds else full,
                torch.ones(shape, dtype=torch.float32, device=dev), zeros)
        _, _, acc = walk_pairwise(
            key, idx, g, lambda j, z, st: step(j, z, st, sgn), init)
        return lgd * acc

    for i in range(plan.iters):
        words = [wrap_int32((block_offset + b) * plan.iters + i)
                 for b in range(n_blocks)]
        key = block_keys(seed, words, dev)
        if plan.antithetic:
            cva_tile = 0.5 * (walk(key, 1.0) + walk(key, -1.0))
        else:
            cva_tile = walk(key, 1.0)
        carry = acc_add(carry, cva_tile.sum(1), (cva_tile * cva_tile).sum(1),
                        plan.kahan)
    return acc_final(carry), (prof + comp).sum(-1)


def _check(ops: Operands):
    m, g = ops.n_options, ops.n_grid
    for name, x, shape in (("scal", ops.scal, (10,)),
                           ("opts", ops.opts, (3, m)),
                           ("nodes", ops.nodes, (7, g))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous() or x.device != ops.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"shape {shape} on {ops.device}")


def _cuda_partials(ops: Operands, seed, block_offset, plan, n_blocks, wwr):
    _check(ops)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    g = ops.n_grid
    lib = _build.library()
    with torch.cuda.device(ops.device):
        out = torch.empty((n_blocks, 2), dtype=torch.float32,
                          device=ops.device)
        ee = torch.empty((n_blocks, g), dtype=torch.float32, device=ops.device)
        scratch = torch.empty(n_blocks * lib.mctpu_cva_scratch_floats(g),
                              dtype=torch.float32, device=ops.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        status = lib.mctpu_cva(
            ops.scal.data_ptr(), ops.opts.data_ptr(), ops.nodes.data_ptr(),
            ops.n_options, g, wrap_int32(seed), wrap_int32(block_offset),
            n_blocks, plan.rows, plan.iters, int(plan.antithetic),
            int(plan.kahan), int(plan.ds), int(wwr), scratch.data_ptr(),
            out.data_ptr(), ee.data_ptr(), stream)
    _build.check(status, "cva")
    LAUNCHES["cva"] += 1
    return out, ee


def partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, wwr: bool):
    """``((n_blocks, 2), (n_blocks, n_grid))`` partials: K4 for CUDA
    operands, the plain version for CPU operands; other devices raise.
    ``wwr`` selects the wrong-way hazard leg (set iff ``wwr_b != 0``)."""
    if ops.device.type == "cuda":
        return _cuda_partials(ops, seed, block_offset, plan, n_blocks, wwr)
    if ops.device.type == "cpu":
        return plain_partials(ops, seed, block_offset, plan, n_blocks, wwr)
    raise ValueError(f"unsupported device {ops.device}")
