"""K12, K13 and K14: fused knock-out barrier-call Monte Carlo, its
likelihood-ratio Greeks and the multilevel (MLMC) level correction of the
monitoring count (``csrc/barrier.cu``).

Counterpart of :mod:`mctpu.kernels.barrier`.  Each unit walks a log-space
GBM over ``n_obs`` dates on the walk kernels' stream (as K9's) with a 0/1
``alive`` flag that drops to 0 the first time the log-spot touches the log
barrier (``>=`` up-and-out, ``<=`` down-and-out); the terminal call payoff
is masked by it.  The scalars are formed in float32 on the CPU in the JAX
kernels' expression order and moved to the device.
"""
from __future__ import annotations

import torch

from mctpu_torch.kernels.common import (Plan, check_level, f32,
                                        launch_split_walk, launch_walk,
                                        walk_pairwise, walk_partials,
                                        walk_steps)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.models import asian as masian
from mctpu_torch.types import BarrierOption

__all__ = ["make_plan", "params", "plain_partials", "partials",
           "N_GREEK_SUMS", "GREEK_SCAL", "greek_params",
           "greek_plain_partials", "greek_partials", "LAUNCHES",
           "level_params", "level_plain_partials", "level_partials"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"barrier": 0, "barrier_greeks": 0, "barrier_level": 0}

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
             n_blocks: int, n_obs: int, up: bool,
             scratch_cap: int = 0) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K12 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises.
    ``scratch_cap``: K12's scratch in floats at most (0: 256 MB), past which
    it splits and folds simulation blocks and iterations in groups; the
    outputs do not depend on it."""
    if par.device.type == "cuda":
        out = launch_split_walk("mctpu_barrier", par, 5, 2, seed,
                                block_offset, plan, n_blocks, n_obs, up,
                                scratch_cap)
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


# ---------------------------------------------------------------------------
# K14: the MLMC level l >= 1 of the monitoring count.  Each unit walks one
# exact log-space path over nf = n0 2^l dates on K11's stream (one pair per
# coarse step, the cosine on the odd date, the sine on the shared date) with
# two knock-out flags: the fine flag checks both dates, the coarse flag the
# shared date only.  d = (alive_f - alive_c) max(e^{log s_T} - k, 0) <= 0.
# Level 0 is K12 itself at n_obs = n0.
# ---------------------------------------------------------------------------

def level_params(opt: BarrierOption, n_fine: int, device) -> torch.Tensor:
    """``[log s0, k, log H, drift, vol]`` in float32 at ``dt = t / n_fine``
    (K14's ``scal``, ``mctpu``'s expression order)."""
    s, k, h = f32(opt.s, opt.k, opt.barrier)
    drift, vol = masian.step_constants(opt, n_fine)
    return torch.stack([torch.log(s), k, torch.log(h), drift, vol]).to(device)


def _level_walk(lp, n_fine: int, up: bool, key, idx, shape, sgn):
    """One coupled walk of a ``(n_blocks, rows * 128)`` tile -> ``[d]``."""
    log_s0, k, log_h, drift, vol = lp.unbind()

    def step(j, z1, z2, carry):
        log_s, af, ac = carry
        log_s = log_s + drift + vol * (sgn * z1)
        af = _alive_update(af, log_s, log_h, up)  # odd (fine-only) date
        log_s = log_s + drift + vol * (sgn * z2)
        af = _alive_update(af, log_s, log_h, up)  # shared date
        ac = _alive_update(ac, log_s, log_h, up)
        return log_s, af, ac

    one = torch.ones(shape, dtype=torch.float32, device=lp.device)
    log_s, af, ac = walk_steps(key, idx, n_fine // 2, step,
                               (log_s0.expand(shape), one, one))
    return [(af - ac) * torch.clamp(torch.exp(log_s) - k, min=0.0)]



def level_plain_partials(lp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int, n_fine: int,
                         up: bool) -> torch.Tensor:
    """Per-block ``[sum_d, sum_d2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``lp``'s device."""
    check_level(n_fine)
    return walk_partials(
        lambda key, idx, shape, sgn: _level_walk(lp, n_fine, up, key, idx,
                                                 shape, sgn),
        seed, block_offset, plan, n_blocks, lp.device)


def level_partials(lp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_fine: int,
                   up: bool) -> torch.Tensor:
    """Per-block level partials ``(n_blocks, 2)``: K14 for a CUDA ``lp``,
    the plain version for a CPU ``lp``; any other device raises."""
    check_level(n_fine)
    if lp.device.type == "cuda":
        out = launch_walk("mctpu_barrier_level", lp, 5, 2, seed, block_offset,
                          plan, n_blocks, n_fine, up)
        LAUNCHES["barrier_level"] += 1
        return out
    if lp.device.type == "cpu":
        return level_plain_partials(lp, seed, block_offset, plan, n_blocks,
                                    n_fine, up)
    raise ValueError(f"unsupported device {lp.device}")
