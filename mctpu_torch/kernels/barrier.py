"""K12 and K13: fused knock-out barrier-call Monte Carlo and its
likelihood-ratio Greeks (``csrc/barrier.cu``).

Counterpart of :mod:`mctpu.kernels.barrier`.  Each unit walks a log-space
GBM over ``n_obs`` dates on the walk kernels' stream (as K9's) with a 0/1
``alive`` flag that drops to 0 the first time the log-spot touches the log
barrier (``>=`` up-and-out, ``<=`` down-and-out); the terminal call payoff
is masked by it.  The scalars are formed in float32 on the CPU in the JAX
kernels' expression order and moved to the device.
"""
from __future__ import annotations

import torch

from mctpu_torch.kernels.common import (Plan, f32, launch_walk,
                                        walk_pairwise, walk_partials)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.models import asian as masian
from mctpu_torch.types import BarrierOption

__all__ = ["make_plan", "params", "plain_partials", "partials",
           "N_GREEK_SUMS", "GREEK_SCAL", "greek_params",
           "greek_plain_partials", "greek_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"barrier": 0, "barrier_greeks": 0}

N_GREEK_SUMS = 8  # (sum, sum^2) of: payoff, delta, vega, rho
# Entries of greek_params(), in the JAX kernel's scal order.
GREEK_SCAL = ("log_s0", "k", "log_h", "drift", "vol", "c_d", "inv_v", "sqdt",
              "n_over_v", "c_r", "t")


def params(opt: BarrierOption, device) -> torch.Tensor:
    """``[log s0, k, log H, drift, vol]`` in float32 (K12's ``scal``)."""
    s, k, h = f32(opt.s, opt.k, opt.barrier)
    drift, vol = masian.step_constants(opt)
    return torch.stack([torch.log(s), k, torch.log(h), drift, vol]).to(device)


def _alive_update(alive, log_s, log_h, up: bool):
    hit = log_s >= log_h if up else log_s <= log_h
    return alive * (~hit).to(alive.dtype)


def _walk(par, n_obs: int, up: bool, key, idx, shape, sgn):
    """One pricing walk of a ``(n_blocks, rows * 128)`` tile -> payoffs."""
    log_s0, k, log_h, drift, vol = par.unbind()

    def step(j, z, carry):
        log_s, alive = carry
        log_s = log_s + drift + vol * (sgn * z)
        return log_s, _alive_update(alive, log_s, log_h, up)

    init = (log_s0.expand(shape),
            torch.ones(shape, dtype=torch.float32, device=par.device))
    log_s, alive = walk_pairwise(key, idx, n_obs, step, init)
    return [alive * torch.clamp(torch.exp(log_s) - k, min=0.0)]


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int,
                   up: bool) -> torch.Tensor:
    """Per-block ``[sum_p, sum_p2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``par``'s device."""
    return walk_partials(
        lambda key, idx, shape, sgn: _walk(par, n_obs, up, key, idx, shape,
                                           sgn),
        seed, block_offset, plan, n_blocks, par.device)


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, n_obs: int, up: bool) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K12 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        out = launch_walk("mctpu_barrier", par, 5, 2, seed, block_offset,
                          plan, n_blocks, n_obs, up)
        LAUNCHES["barrier"] += 1
        return out
    if par.device.type == "cpu":
        return plain_partials(par, seed, block_offset, plan, n_blocks, n_obs,
                              up)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K13: likelihood-ratio delta, vega and rho
# ---------------------------------------------------------------------------
# The knock-out indicator is discontinuous in (s0, v, r), so pathwise
# differentiation is biased; the likelihood-ratio scores differentiate the
# density of the draws zeta_j instead (Glasserman 2004, sec. 7.3): delta
# zeta_1 / (s0 sigma), vega sum_j [(zeta_j^2 - 1) / v - zeta_j sqrt(dt)],
# rho sum_j zeta_j sqrt(dt) / v (plus the -t p discount term).  The walk
# carries zeta_1, sum zeta and sum zeta^2 beside the log-spot and the flag.


def greek_params(opt: BarrierOption, device) -> torch.Tensor:
    """K13's float32 ``scal`` (:data:`GREEK_SCAL`), formed in the JAX
    kernel's expression order (``_greek_scalars``)."""
    n = opt.n_obs
    s, k, h, r, v, t = f32(opt.s, opt.k, opt.barrier, opt.r, opt.v, opt.t)
    dt = t / n
    vol = v * torch.sqrt(dt)
    drift = (r - 0.5 * v * v) * dt
    return torch.stack([
        torch.log(s), k, torch.log(h), drift, vol, 1.0 / (s * vol), 1.0 / v,
        torch.sqrt(dt), n / v, torch.sqrt(dt) / v, t]).to(device)


def _greek_walk(gp, n_obs: int, up: bool, key, idx, shape, sgn):
    """One LR Greeks walk of a ``(n_blocks, rows * 128)`` tile -> the four
    per-path integrands ``[p, gd, gv, gr]``."""
    sc = dict(zip(GREEK_SCAL, gp.unbind()))
    drift, vol, log_h = sc["drift"], sc["vol"], sc["log_h"]

    def step(j, z, carry):
        log_s, alive, z1, zs, z2s = carry
        zeta = sgn * z
        log_s = log_s + drift + vol * zeta
        alive = _alive_update(alive, log_s, log_h, up)
        if j == 0:
            z1 = zeta
        return log_s, alive, z1, zs + zeta, z2s + zeta * zeta

    zero = torch.zeros(shape, dtype=torch.float32, device=gp.device)
    init = (sc["log_s0"].expand(shape),
            torch.ones(shape, dtype=torch.float32, device=gp.device),
            zero, zero, zero)
    log_s, alive, z1, zs, z2s = walk_pairwise(key, idx, n_obs, step, init)
    p = alive * torch.clamp(torch.exp(log_s) - sc["k"], min=0.0)
    gd = p * z1 * sc["c_d"]
    gv = p * (z2s * sc["inv_v"] - zs * sc["sqdt"] - sc["n_over_v"])
    gr = p * (zs * sc["c_r"] - sc["t"])
    return [p, gd, gv, gr]


def greek_plain_partials(gp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int, n_obs: int,
                         up: bool) -> torch.Tensor:
    """Per-block ``(n_blocks, 8)`` LR Greek partials in plain PyTorch on
    ``gp``'s device, over K12's stream."""
    return walk_partials(
        lambda key, idx, shape, sgn: _greek_walk(gp, n_obs, up, key, idx,
                                                 shape, sgn),
        seed, block_offset, plan, n_blocks, gp.device)


def greek_partials(gp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int,
                   up: bool) -> torch.Tensor:
    """``(n_blocks, 8)`` LR Greek partials: K13 for a CUDA ``gp``, the plain
    version for a CPU ``gp``; other devices raise."""
    if gp.device.type == "cuda":
        out = launch_walk("mctpu_barrier_greeks", gp, len(GREEK_SCAL),
                          N_GREEK_SUMS, seed, block_offset, plan, n_blocks,
                          n_obs, up)
        LAUNCHES["barrier_greeks"] += 1
        return out
    if gp.device.type == "cpu":
        return greek_plain_partials(gp, seed, block_offset, plan, n_blocks,
                                    n_obs, up)
    raise ValueError(f"unsupported device {gp.device}")
