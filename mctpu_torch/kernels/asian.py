"""K9, K10 and K11: fused Asian-call Monte Carlo, its Greeks and the
multilevel (MLMC) level correction of the observation count, serial walks
over the observation grid (``csrc/asian.cu``).

Counterpart of :mod:`mctpu.kernels.asian`.  Each unit walks a log-space
GBM over ``n_obs`` dates on the walk kernels' stream (reseeded per (block,
iteration), both Box-Muller branches per draw, the antithetic mirror
replaying the same draws): the pricer carries the running sum of the
spots (of the log-spots for the geometric average) and pays ``max(avg -
k, 0)``; the Greeks walk carries the pathwise tangents and the Stein-tilt
gamma's sums (:func:`_greek_quants`).  The scalars are formed in float32
on the CPU in the JAX kernels' expression order and moved to the device,
so a kernel and its plain version read the same bits.
"""
from __future__ import annotations

import torch

from mctpu_torch.kernels.common import (Plan, check_level, f32,
                                        launch_split_walk, launch_walk,
                                        walk_pairwise, walk_partials,
                                        walk_steps)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.models import asian as masian
from mctpu_torch.types import AsianOption

__all__ = ["make_plan", "params", "plain_partials", "partials",
           "N_GREEK_SUMS", "GREEK_SCAL", "greek_params",
           "greek_plain_partials", "greek_partials", "LAUNCHES",
           "level_params", "level_plain_partials", "level_partials"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"asian": 0, "asian_greeks": 0, "asian_level": 0}

N_GREEK_SUMS = 10  # (sum, sum^2) of: payoff, delta, vega, rho, gamma
# Entries of greek_params(), in the JAX kernel's scal order.
GREEK_SCAL = ("log_s0", "s0", "k", "drift", "vol", "inv_v", "c1", "dt", "t",
              "tbar", "zc0", "ivst")


def params(opt: AsianOption, device) -> torch.Tensor:
    """``[log s0, k, drift, vol]`` in float32 (K9's ``scal``)."""
    s, k = (torch.tensor(float(x), dtype=torch.float32) for x in (opt.s,
                                                                  opt.k))
    drift, vol = masian.step_constants(opt)
    return torch.stack([torch.log(s), k, drift, vol]).to(device)


def _walk(par, n_obs: int, geometric: bool, key, idx, shape, sgn):
    """One pricing walk of a ``(n_blocks, rows * 128)`` tile -> payoffs."""
    log_s0, k, drift, vol = par.unbind()

    def step(j, z, carry):
        log_s, acc = carry
        log_s = log_s + drift + vol * (sgn * z)
        acc = acc + (log_s if geometric else torch.exp(log_s))
        return log_s, acc

    init = (log_s0.expand(shape),
            torch.zeros(shape, dtype=torch.float32, device=par.device))
    _, acc = walk_pairwise(key, idx, n_obs, step, init)
    return [_avg_payoff(acc, n_obs, k, geometric)]


def _avg_payoff(acc, n: int, k, geometric: bool):
    """``max(avg - k, 0)`` of a running sum over ``n`` dates.  IEEE
    division, as the kernels': on CUDA PyTorch divides by a Python scalar
    as a multiply by its reciprocal, so divide by a device tensor."""
    avg = acc / torch.full((), n, dtype=torch.float32, device=acc.device)
    if geometric:
        avg = torch.exp(avg)
    return torch.clamp(avg - k, min=0.0)


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int,
                   geometric: bool) -> torch.Tensor:
    """Per-block ``[sum_p, sum_p2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``par``'s device."""
    return walk_partials(
        lambda key, idx, shape, sgn: _walk(par, n_obs, geometric, key, idx,
                                           shape, sgn),
        seed, block_offset, plan, n_blocks, par.device)


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, n_obs: int, geometric: bool) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K9 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        out = launch_walk("mctpu_asian", par, 4, 2, seed, block_offset, plan,
                          n_blocks, n_obs, geometric)
        LAUNCHES["asian"] += 1
        return out
    if par.device.type == "cpu":
        return plain_partials(par, seed, block_offset, plan, n_blocks, n_obs,
                              geometric)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K10: pathwise delta, vega and rho, and the Stein-tilt gamma
# ---------------------------------------------------------------------------
# d(log s_j)/dv = (log s_j - log s0) / v + c1 * (j + 1) with c1 = -(r +
# v^2/2) dt / v, so the vega tangent is one multiply-add on the carried
# log-spot; the running scalars cj = c1 (j + 1) and tj = t_j are carried as
# sums, as the JAX kernel carries them (their rounding is part of the
# result).  The geometric walk needs neither an exp per step nor racc/r2acc.


def greek_params(opt: AsianOption, device) -> torch.Tensor:
    """K10's float32 ``scal`` (:data:`GREEK_SCAL`), formed in the JAX
    kernel's expression order."""
    g = opt.n_obs
    s, k, r, v, t = (torch.tensor(float(x), dtype=torch.float32)
                     for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
    drift, vol = masian.step_constants(opt)
    dt = t / g
    inv_v = 1.0 / v
    c1 = -(r + 0.5 * v * v) * dt * inv_v
    tbar = dt * (g + 1) / 2.0
    zc0 = (r - 0.5 * v * v) * t
    ivst = 1.0 / (v * torch.sqrt(t))
    return torch.stack([torch.log(s), s, k, drift, vol, inv_v, c1, dt, t,
                        tbar, zc0, ivst]).to(device)


def _greek_quants(sc, n_obs: int, geometric: bool, log_s, avg_acc, g_acc,
                  r_acc, r2_acc):
    """``[p, gd, gv, gr, gg]`` tiles from the walk's sums (``mctpu``'s
    ``_greek_quants``): ``gr`` folds in the ``-t * p`` discount term, ``gg``
    is the Stein-tilt gamma along the standardized total normal ``z``."""
    inv_n = 1.0 / n_obs
    avg = avg_acc * inv_n
    if geometric:
        avg = torch.exp(avg)
    ind = (avg > sc["k"]).to(avg.dtype)
    p = torch.clamp(avg - sc["k"], min=0.0)
    gd = ind * avg / sc["s0"]
    gv = ind * ((avg * g_acc * inv_n) if geometric else (g_acc * inv_n))
    davg_dr = (avg * sc["tbar"]) if geometric else (r_acc * inv_n)
    gr = ind * davg_dr - sc["t"] * p
    z = (log_s - sc["log_s0"] - sc["zc0"]) * sc["ivst"]
    sqt_v = sc["t"] * sc["ivst"]  # sqrt(T) / v
    inv_s02 = 1.0 / (sc["s0"] * sc["s0"])
    if geometric:
        gg = ind * (avg * inv_s02) * ((sqt_v / sc["tbar"]) * z - 1.0)
    else:
        m = r_acc * inv_n
        r2n = r2_acc * inv_n
        h = sqt_v * (avg * avg) * inv_s02 / m
        dh = inv_s02 * (2.0 * avg - (avg * avg) * r2n / (m * m))
        gg = ind * (h * z - dh)
    return [p, gd, gv, gr, gg]


def _greek_walk(gp, n_obs: int, geometric: bool, key, idx, shape, sgn):
    """One Greeks walk of a ``(n_blocks, rows * 128)`` tile -> the five
    per-path integrands (``mctpu``'s ``_greek_step``)."""
    sc = dict(zip(GREEK_SCAL, gp.unbind()))
    log_s0, drift, vol = sc["log_s0"], sc["drift"], sc["vol"]
    inv_v, c1, dt = sc["inv_v"], sc["c1"], sc["dt"]

    def step(j, z, carry):
        log_s, acc, gacc, racc, r2acc, cj, tj = carry
        log_s = log_s + drift + vol * (sgn * z)
        f = (log_s - log_s0) * inv_v + cj
        if geometric:
            return (log_s, acc + log_s, gacc + f, racc, r2acc, cj + c1, tj)
        s = torch.exp(log_s)
        st = s * tj
        return (log_s, acc + s, gacc + s * f, racc + st, r2acc + st * tj,
                cj + c1, tj + dt)

    zero = torch.zeros(shape, dtype=torch.float32, device=gp.device)
    init = (log_s0.expand(shape), zero, zero, zero, zero, c1, dt)
    log_s, acc, gacc, racc, r2acc, _, _ = walk_pairwise(key, idx, n_obs,
                                                        step, init)
    return _greek_quants(sc, n_obs, geometric, log_s, acc, gacc, racc, r2acc)


def greek_plain_partials(gp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int, n_obs: int,
                         geometric: bool) -> torch.Tensor:
    """Per-block ``(n_blocks, 10)`` Greek partials in plain PyTorch on
    ``gp``'s device, over K9's stream."""
    return walk_partials(
        lambda key, idx, shape, sgn: _greek_walk(gp, n_obs, geometric, key,
                                                 idx, shape, sgn),
        seed, block_offset, plan, n_blocks, gp.device)


def greek_partials(gp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int, geometric: bool,
                   scratch_cap: int = 0) -> torch.Tensor:
    """``(n_blocks, 10)`` Greek partials: K10 for a CUDA ``gp``, the plain
    version for a CPU ``gp``; other devices raise.  ``scratch_cap``: K10's
    scratch in floats at most (0: 256 MB; 5 floats a path element), past
    which it splits and folds simulation blocks and iterations in groups;
    the outputs do not depend on it."""
    if gp.device.type == "cuda":
        out = launch_split_walk("mctpu_asian_greeks", gp, len(GREEK_SCAL),
                                N_GREEK_SUMS, seed, block_offset, plan,
                                n_blocks, n_obs, geometric, scratch_cap)
        LAUNCHES["asian_greeks"] += 1
        return out
    if gp.device.type == "cpu":
        return greek_plain_partials(gp, seed, block_offset, plan, n_blocks,
                                    n_obs, geometric)
    raise ValueError(f"unsupported device {gp.device}")


# ---------------------------------------------------------------------------
# K11: the MLMC level l >= 1 of the observation count.  Each unit walks one
# exact log-space path over nf = n0 2^l dates and averages it twice: every
# date (fine) and every second date (coarse, nc = nf / 2).  Coarse step j
# takes one Box-Muller pair at counter j: the cosine drives the odd,
# fine-only date, the sine the shared date (the walk_steps map over nc
# steps, the normals K9 draws at nf dates).  d = pay(accf / nf) -
# pay(accc / nc).  Level 0 is K9 itself at n_obs = n0.  K11 is a split
# walk (a thread per path element, then a fold in the simple design's
# order).
# ---------------------------------------------------------------------------

def level_params(opt: AsianOption, n_fine: int, device) -> torch.Tensor:
    """``[log s0, k, drift, vol]`` in float32 at ``dt = t / n_fine`` (K11's
    ``scal``, ``mctpu``'s expression order)."""
    s, k = f32(opt.s, opt.k)
    drift, vol = masian.step_constants(opt, n_fine)
    return torch.stack([torch.log(s), k, drift, vol]).to(device)


def _level_walk(lp, n_fine: int, geometric: bool, key, idx, shape, sgn):
    """One coupled walk of a ``(n_blocks, rows * 128)`` tile -> ``[d]``."""
    log_s0, k, drift, vol = lp.unbind()
    nc = n_fine // 2

    def step(j, z1, z2, carry):
        log_s, accf, accc = carry
        log_s = log_s + drift + vol * (sgn * z1)
        x = log_s if geometric else torch.exp(log_s)
        accf = accf + x
        log_s = log_s + drift + vol * (sgn * z2)
        x = log_s if geometric else torch.exp(log_s)
        return log_s, accf + x, accc + x

    zero = torch.zeros(shape, dtype=torch.float32, device=lp.device)
    _, accf, accc = walk_steps(key, idx, nc, step,
                               (log_s0.expand(shape), zero, zero))
    return [_avg_payoff(accf, n_fine, k, geometric)
            - _avg_payoff(accc, nc, k, geometric)]



def level_plain_partials(lp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int, n_fine: int,
                         geometric: bool) -> torch.Tensor:
    """Per-block ``[sum_d, sum_d2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``lp``'s device."""
    check_level(n_fine)
    return walk_partials(
        lambda key, idx, shape, sgn: _level_walk(lp, n_fine, geometric, key,
                                                 idx, shape, sgn),
        seed, block_offset, plan, n_blocks, lp.device)


def level_partials(lp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_fine: int, geometric: bool,
                   scratch_cap: int = 0) -> torch.Tensor:
    """Per-block level partials ``(n_blocks, 2)``: K11 for a CUDA ``lp``,
    the plain version for a CPU ``lp``; any other device raises.
    ``scratch_cap``: K11's scratch in floats at most (0: 256 MB; a float a
    path element), past which it splits and folds simulation blocks and
    iterations in groups; the outputs do not depend on it."""
    check_level(n_fine)
    if lp.device.type == "cuda":
        out = launch_split_walk("mctpu_asian_level", lp, 4, 2, seed,
                                block_offset, plan, n_blocks, n_fine,
                                geometric, scratch_cap)
        LAUNCHES["asian_level"] += 1
        return out
    if lp.device.type == "cpu":
        return level_plain_partials(lp, seed, block_offset, plan, n_blocks,
                                    n_fine, geometric)
    raise ValueError(f"unsupported device {lp.device}")
