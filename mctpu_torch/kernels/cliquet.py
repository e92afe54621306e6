"""K17 and K18: fused cliquet Monte Carlo and its pathwise Greeks
(``csrc/cliquet.cu``).

Counterpart of :mod:`mctpu.kernels.cliquet`.  Each unit draws ``n_periods``
i.i.d. period log-returns ``lr = mu_dt + vol z`` on the walk kernels'
stream (as K9's, the periods in place of the dates) and sums the clipped
returns ``min(max(exp(lr) - 1, floor), cap)``; no spot is carried.  The
scalars are formed in float32 on the CPU in the JAX kernels' expression
order and moved to the device.
"""
from __future__ import annotations

import torch

from mctpu_torch.kernels.common import (Plan, f32, launch_walk,
                                        walk_pairwise, walk_partials)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.models import asian as masian
from mctpu_torch.types import CliquetOption

__all__ = ["make_plan", "params", "plain_partials", "partials",
           "N_GREEK_SUMS", "GREEK_SCAL", "greek_params",
           "greek_plain_partials", "greek_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"cliquet": 0, "cliquet_greeks": 0}

N_GREEK_SUMS = 8  # (sum, sum^2) of: payoff, vega, rho, theta
# Entries of greek_params(), in the JAX kernel's scal order.
GREEK_SCAL = ("mu_dt", "vol", "cap", "floor", "dt", "t", "r", "inv_v")


def params(opt: CliquetOption, device) -> torch.Tensor:
    """``[mu_dt, vol, cap, floor]`` in float32 (K17's ``scal``)."""
    mu_dt, vol = masian.step_constants(opt, opt.n_periods)
    cap, floor = f32(opt.cap, opt.floor)
    return torch.stack([mu_dt, vol, cap, floor]).to(device)


def _clip(ret, floor, cap):
    """``jnp.clip``: ``min(max(ret, floor), cap)``."""
    return torch.minimum(torch.maximum(ret, floor), cap)


def _walk(par, n_periods: int, key, idx, shape, sgn):
    """One pricing walk of a ``(n_blocks, rows * 128)`` tile -> payoffs."""
    mu_dt, vol, cap, floor = par.unbind()

    def step(j, z, acc):
        lr = mu_dt + vol * (sgn * z)
        return acc + _clip(torch.exp(lr) - 1.0, floor, cap)

    init = torch.zeros(shape, dtype=torch.float32, device=par.device)
    return [walk_pairwise(key, idx, n_periods, step, init)]


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int,
                   n_periods: int) -> torch.Tensor:
    """Per-block ``[sum_p, sum_p2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``par``'s device."""
    return walk_partials(
        lambda key, idx, shape, sgn: _walk(par, n_periods, key, idx, shape,
                                           sgn),
        seed, block_offset, plan, n_blocks, par.device)


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, n_periods: int) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K17 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        out = launch_walk("mctpu_cliquet", par, 4, 2, seed, block_offset,
                          plan, n_blocks, n_periods, 0)
        LAUNCHES["cliquet"] += 1
        return out
    if par.device.type == "cpu":
        return plain_partials(par, seed, block_offset, plan, n_blocks,
                              n_periods)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K18: pathwise vega, rho and theta
# ---------------------------------------------------------------------------
# The clip's corners have measure zero, so the pathwise derivative of the
# payoff is unbiased: each period adds m_j e^{lr_j} times the derivative of
# lr_j, with the band mask m_j = 1{floor < ret_j < cap}.  Vega recovers
# sqrt(dt) z from lr; rho and theta fold in the discount's -t p and -r p.
# The arithmetic is the JAX kernel's as written (exp(lr) - 1 and not expm1,
# the vega term's order).


def greek_params(opt: CliquetOption, device) -> torch.Tensor:
    """K18's float32 ``scal`` (:data:`GREEK_SCAL`), formed in the JAX
    kernel's expression order."""
    mu_dt, vol = masian.step_constants(opt, opt.n_periods)
    cap, floor, r, v, t = f32(opt.cap, opt.floor, opt.r, opt.v, opt.t)
    dt = t / opt.n_periods
    return torch.stack([mu_dt, vol, cap, floor, dt, t, r,
                        1.0 / v]).to(device)


def _greek_walk(gp, n_periods: int, key, idx, shape, sgn):
    """One Greeks walk of a ``(n_blocks, rows * 128)`` tile -> the four
    per-path integrands ``[p, vega, rho, theta]`` (``mctpu``'s
    ``_greek_step`` and ``_greek_finalize``)."""
    sc = dict(zip(GREEK_SCAL, gp.unbind()))
    mu_dt, vol, cap, floor = sc["mu_dt"], sc["vol"], sc["cap"], sc["floor"]
    inv_v, dt, t, r = sc["inv_v"], sc["dt"], sc["t"], sc["r"]
    vv = vol * inv_v * vol

    def step(j, z, carry):
        acc, gv, grr, gtr = carry
        lr = mu_dt + vol * (sgn * z)
        e = torch.exp(lr)
        ret = e - 1.0
        me = ((ret > floor) & (ret < cap)).to(e.dtype) * e
        return (acc + _clip(ret, floor, cap),
                gv + me * ((lr - mu_dt) * inv_v - vv),
                grr + me, gtr + me * (lr + mu_dt))

    zero = torch.zeros(shape, dtype=torch.float32, device=gp.device)
    acc, gv, grr, gtr = walk_pairwise(key, idx, n_periods, step,
                                      (zero, zero, zero, zero))
    # 0.5 / t as an IEEE division by the device scalar, as the kernel's.
    half_over_t = torch.full((), 0.5, dtype=torch.float32,
                             device=gp.device) / t
    return [acc, gv, grr * dt - t * acc, gtr * half_over_t - r * acc]


def greek_plain_partials(gp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int,
                         n_periods: int) -> torch.Tensor:
    """Per-block ``(n_blocks, 8)`` Greek partials in plain PyTorch on
    ``gp``'s device, over K17's stream."""
    return walk_partials(
        lambda key, idx, shape, sgn: _greek_walk(gp, n_periods, key, idx,
                                                 shape, sgn),
        seed, block_offset, plan, n_blocks, gp.device)


def greek_partials(gp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int,
                   n_periods: int) -> torch.Tensor:
    """``(n_blocks, 8)`` Greek partials: K18 for a CUDA ``gp``, the plain
    version for a CPU ``gp``; other devices raise."""
    if gp.device.type == "cuda":
        out = launch_walk("mctpu_cliquet_greeks", gp, len(GREEK_SCAL),
                          N_GREEK_SUMS, seed, block_offset, plan, n_blocks,
                          n_periods, 0)
        LAUNCHES["cliquet_greeks"] += 1
        return out
    if gp.device.type == "cpu":
        return greek_plain_partials(gp, seed, block_offset, plan, n_blocks,
                                    n_periods)
    raise ValueError(f"unsupported device {gp.device}")
