"""K27, K28 and K29: Heston Monte Carlo (full-truncation Euler or Andersen's
QE), its pathwise Greeks and the multilevel (MLMC) level correction of the
Euler walk, one serial walk per unit (``csrc/heston.cu``).

Counterpart of :mod:`mctpu.kernels.heston`.  Each unit walks the log-spot
ratio ``x = log(S / S0)`` and the variance ``v`` over ``n_steps`` steps.
The stream is the walk kernels' reseed per (block, iteration), but each
step takes one Box-Muller pair of its own (:func:`walk_steps`): the cosine
branch is ``z_v``, the sine branch ``z_perp``; the antithetic mirror
replays the same draws with ``-z``.  K27 pays ``max(s0 e^x - k, 0)``; K28
walks the Euler scheme with four forward-mode tangent pairs ``(d x / dp,
d v / dp)`` for ``p`` in ``(v0, theta, kappa, xi)`` and sums price, delta,
the four variance-parameter sensitivities and rho (:func:`_greek_quants`).
The scalars are formed in float32 on the CPU in the JAX kernels' expression
order (roots correctly rounded, as ``jnp.sqrt``) and moved to the device.

``mctpu`` forms the Greeks' ``d sqrt(vp) / d vp`` factor as ``(0.5 sqdt)
rsqrt(vp)``.  Here it is ``(0.5 sqdt) (1 / sqrt(vp))``, an IEEE root and an
IEEE division, in the plain version and in the kernel alike, so that the
two agree path by path on the card (``rsqrtf`` is not correctly rounded);
against ``mctpu`` that is an ulp in some steps, within the tests' bound.
"""
from __future__ import annotations

import torch

from mctpu_torch import math as mcmath
from mctpu_torch.kernels.common import (Plan, check_level, draw_normal_pair,
                                        f32, launch_split_walk, launch_walk,
                                        sqrt32, walk_partials, walk_steps)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.models import heston as mheston
from mctpu_torch.types import HestonOption

__all__ = ["make_plan", "params", "plain_partials", "partials",
           "N_GREEK_SUMS", "EULER_SCAL", "GREEK_SCAL", "greek_params",
           "greek_plain_partials", "greek_partials", "LAUNCHES",
           "LEVEL_SCAL", "level_params", "level_plain_partials",
           "level_partials"]

# Launches of the CUDA kernels in this process, by kernel and scheme.
LAUNCHES = {"heston": 0, "heston_qe": 0, "heston_greeks": 0,
            "heston_level": 0}

N_GREEK_SUMS = 14  # (sum, sum^2) of: payoff, delta, vega (v0), rho, dtheta,
#                    dkappa, dxi
# The Euler scalars, in the JAX kernel's scal order; K27's operand is these
# and then the QE constants (models.heston.QE_KEYS), K28's these and then
# half_dt, t_k = t * k and dt.
EULER_SCAL = ("s0", "k", "v0", "k_dt", "th", "xi", "rho_c", "rho_s", "r_dt",
              "sqdt")
GREEK_SCAL = EULER_SCAL + ("half_dt", "t_k", "dt")
N_SCAL = len(EULER_SCAL) + len(mheston.QE_KEYS)


def _euler_scalars(opt: HestonOption, n_steps: int):
    s, k, v0, kappa, theta, xi, rho, r, t = f32(
        opt.s, opt.k, opt.v0, opt.kappa, opt.theta, opt.xi, opt.rho, opt.r,
        opt.t)
    dt, sqdt = mheston.step_constants(opt, n_steps)
    return [s, k, v0, kappa * dt, theta, xi, rho, sqrt32(1.0 - rho * rho),
            r * dt, sqdt], t, dt


def params(opt: HestonOption, n_steps: int, qe: bool,
           device) -> torch.Tensor:
    """K27's 20 float32 scalars: :data:`EULER_SCAL`, then the QE constants
    (zeros for the Euler scheme, which never reads them: ``kappa`` or
    ``xi`` may be 0, which makes them inf or NaN)."""
    euler, _, _ = _euler_scalars(opt, n_steps)
    if qe:
        c = mheston.qe_constants(opt, n_steps)
        tail = [c[name] for name in mheston.QE_KEYS]
    else:
        tail = [torch.zeros((), dtype=torch.float32)] * len(mheston.QE_KEYS)
    return torch.stack(euler + tail).to(device)


def _heston_step(x, v, z_v, z_perp, k_dt, th, xi, rho_c, rho_s, r_dt, sqdt):
    """One full-truncation Euler step of ``(x, v)`` (``mctpu``'s
    ``_heston_step``)."""
    vp = torch.clamp(v, min=0.0)
    sq_v = torch.sqrt(vp) * sqdt
    z_s = rho_c * z_v + rho_s * z_perp
    x = x + r_dt - 0.5 * vp * (sqdt * sqdt) + sq_v * z_s
    v = v + k_dt * (th - vp) + xi * sq_v * z_v
    return x, v


def _walk(par, n_steps: int, qe: bool, key, idx, shape, sgn):
    """One pricing walk of a ``(n_blocks, rows * 128)`` tile -> payoffs."""
    sc = par.unbind()
    s0, k, v0 = sc[:3]
    qe_c = dict(zip(mheston.QE_KEYS, sc[len(EULER_SCAL):]))

    def step(j, z_v, z_perp, carry):
        x, v = carry
        if qe:
            return mheston.qe_step(x, v, sgn * z_v, sgn * z_perp, qe_c,
                                   mcmath.norm_cdf_hastings)
        return _heston_step(x, v, sgn * z_v, sgn * z_perp, *sc[3:10])

    init = (torch.zeros(shape, dtype=torch.float32, device=par.device),
            v0.expand(shape))
    x, _ = walk_steps(key, idx, n_steps, step, init)
    return [torch.clamp(s0 * torch.exp(x) - k, min=0.0)]


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_steps: int,
                   qe: bool) -> torch.Tensor:
    """Per-block ``[sum_p, sum_p2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``par``'s device."""
    return walk_partials(
        lambda key, idx, shape, sgn: _walk(par, n_steps, qe, key, idx, shape,
                                           sgn),
        seed, block_offset, plan, n_blocks, par.device)


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, n_steps: int, qe: bool,
             scratch_cap: int = 0) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K27 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises.
    ``scratch_cap``: K27's scratch in floats at most (0: 256 MB), past which
    it splits and folds simulation blocks and iterations in groups; the
    outputs do not depend on it."""
    if par.device.type == "cuda":
        out = launch_split_walk("mctpu_heston", par, N_SCAL, 2, seed,
                                block_offset, plan, n_blocks, n_steps, qe,
                                scratch_cap)
        LAUNCHES["heston_qe" if qe else "heston"] += 1
        return out
    if par.device.type == "cpu":
        return plain_partials(par, seed, block_offset, plan, n_blocks,
                              n_steps, qe)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K28: per step, with vp = max(v, 0), m = 1{v > 0} and dsq = d sqrt(vp) dt /
# d vp, the tangent pairs share cA = z_s dsq - dt/2 and cB = xi z_v dsq -
# kappa dt: dvp = m av;  al += dvp cA;  av += dvp cB + e_p, with e_p the
# explicit derivative of the v update (0, kappa dt, dt (theta - vp),
# sqrt(vp dt) z_v).  Integrands with I = 1{S_T > K}: delta I e^x, vega_p
# I S_T al_p, rho t K I (exact: dx/dr = t, after the -t P discount term).
# ---------------------------------------------------------------------------

def greek_params(opt: HestonOption, n_steps: int, device) -> torch.Tensor:
    """K28's 13 float32 scalars (:data:`GREEK_SCAL`)."""
    euler, t, dt = _euler_scalars(opt, n_steps)
    (k,) = f32(opt.k)
    return torch.stack(euler + [0.5 * dt, t * k, dt]).to(device)


def _greek_step(x, v, tg, z_v, z_perp, k_dt, th, xi, rho_c, rho_s, r_dt,
                sqdt, half_dt, dt):
    """One Euler step of ``(x, v)`` and the tangent tuple ``tg = (al_v0,
    av_v0, al_th, av_th, al_ka, av_ka, al_xi, av_xi)`` (``mctpu``'s
    ``_greek_step``, with ``1 / sqrt(vp)`` for its ``rsqrt(vp)``)."""
    vp = torch.clamp(v, min=0.0)
    sq = torch.sqrt(vp)
    sq_v = sq * sqdt
    dsq = torch.where(vp > 0.0, (0.5 * sqdt) * (1.0 / sq), 0.0)
    m = v > 0.0
    z_s = rho_c * z_v + rho_s * z_perp
    x = x + r_dt - half_dt * vp + sq_v * z_s
    c_a = z_s * dsq - half_dt
    c_b = xi * dsq * z_v - k_dt
    extras = (0.0, k_dt, dt * (th - vp), sq_v * z_v)
    out = []
    for i, e in enumerate(extras):
        al, av = tg[2 * i], tg[2 * i + 1]
        dvp = torch.where(m, av, 0.0)
        out.append(al + dvp * c_a)
        out.append(av + dvp * c_b + e)
    v = v + k_dt * (th - vp) + xi * sq_v * z_v
    return x, v, tuple(out)


def _greek_quants(x, tg, s0, k, t_k):
    """``[p, delta, vega_v0, rho, dtheta, dkappa, dxi]`` integrand tiles."""
    e_x = torch.exp(x)
    st = s0 * e_x
    ind = (st > k).to(st.dtype)
    p = torch.clamp(st - k, min=0.0)
    ist = ind * st
    return [p, ind * e_x, ist * tg[0], t_k * ind, ist * tg[2], ist * tg[4],
            ist * tg[6]]


def tangent_init(shape, device):
    """The tangents at step 0: ``d v0 / d v0 = 1``, every other 0."""
    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    return (zero, torch.ones_like(zero), zero, zero, zero, zero, zero, zero)


def _greek_walk(gp, n_steps: int, key, idx, shape, sgn):
    """One Greeks walk of a ``(n_blocks, rows * 128)`` tile -> the seven
    per-path integrands."""
    sc = gp.unbind()
    s0, k, v0 = sc[:3]
    consts = sc[3:10] + (sc[10], sc[12])  # ..., sqdt, half_dt, dt
    t_k = sc[11]

    def step(j, z_v, z_perp, carry):
        x, v, tg = carry
        return _greek_step(x, v, tg, sgn * z_v, sgn * z_perp, *consts)

    init = (torch.zeros(shape, dtype=torch.float32, device=gp.device),
            v0.expand(shape), tangent_init(shape, gp.device))
    x, _, tg = walk_steps(key, idx, n_steps, step, init)
    return _greek_quants(x, tg, s0, k, t_k)


def greek_plain_partials(gp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int,
                         n_steps: int) -> torch.Tensor:
    """Per-block ``(n_blocks, 14)`` Greek partials in plain PyTorch on
    ``gp``'s device, over K27's stream."""
    return walk_partials(
        lambda key, idx, shape, sgn: _greek_walk(gp, n_steps, key, idx,
                                                 shape, sgn),
        seed, block_offset, plan, n_blocks, gp.device)


def greek_partials(gp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_steps: int) -> torch.Tensor:
    """``(n_blocks, 14)`` Greek partials: K28 for a CUDA ``gp``, the plain
    version for a CPU ``gp``; other devices raise."""
    if gp.device.type == "cuda":
        out = launch_walk("mctpu_heston_greeks", gp, len(GREEK_SCAL),
                          N_GREEK_SUMS, seed, block_offset, plan, n_blocks,
                          n_steps, 0)
        LAUNCHES["heston_greeks"] += 1
        return out
    if gp.device.type == "cpu":
        return greek_plain_partials(gp, seed, block_offset, plan, n_blocks,
                                    n_steps)
    raise ValueError(f"unsupported device {gp.device}")


# ---------------------------------------------------------------------------
# K29: the MLMC level l >= 1 of the Euler walk (Giles 2008).  Each unit walks
# a fine path of n_fine = n0 2^l steps and a coarse path of n_fine / 2 steps
# on the same Brownian increments: coarse step j draws the pairs at counters
# 2j and 2j + 1 (one Philox block per fine step, as K27 at n_fine steps),
# takes the two fine steps on them and one coarse step on zc = (z1 + z2) /
# sqrt(2) for z_v and z_perp alike, the mirror's sign applied after the sum.
# The unit's sample is the payoff difference d = P_fine - P_coarse.  Level 0
# is K27 itself at n_steps = n0.  On the card K27 and K29 are split walks
# (one thread per path element, both signs on one draw) and a fold in the
# simple design's order of additions (csrc/heston.cu).
# ---------------------------------------------------------------------------

# K29's 13 scalars, in the JAX kernel's scal order (level_pallas_partials).
LEVEL_SCAL = ("s0", "k", "v0", "th", "xi", "rho_c", "rho_s", "k_dt_f",
              "r_dt_f", "sq_f", "k_dt_c", "r_dt_c", "sq_c")
# 1 / sqrt(2) in float32, as mctpu's jnp.float32(_INV_SQRT2).
INV_SQRT2 = 0.7071067811865476


def level_params(opt: HestonOption, n_fine: int, device) -> torch.Tensor:
    """K29's 13 float32 scalars (:data:`LEVEL_SCAL`) for a fine grid of
    ``n_fine`` steps, in ``mctpu``'s expression order: ``dt_f = t /
    n_fine``, ``dt_c = 2 dt_f``, the roots correctly rounded."""
    s, k, v0, kappa, theta, xi, rho, r, t = f32(
        opt.s, opt.k, opt.v0, opt.kappa, opt.theta, opt.xi, opt.rho, opt.r,
        opt.t)
    dt_f = t / n_fine
    dt_c = 2.0 * dt_f
    return torch.stack([s, k, v0, theta, xi, rho, sqrt32(1.0 - rho * rho),
                        kappa * dt_f, r * dt_f, sqrt32(dt_f), kappa * dt_c,
                        r * dt_c, sqrt32(dt_c)]).to(device)


def _level_walk(lp, n_fine: int, key, idx, shape, sgn):
    """One coupled walk of a ``(n_blocks, rows * 128)`` tile -> ``[d]``."""
    s0, k, v0, th, xi, rho_c, rho_s, kf, rf, sf, kc, rc, sc = lp.unbind()
    inv = torch.tensor(INV_SQRT2, dtype=torch.float32, device=lp.device)
    zero = torch.zeros(shape, dtype=torch.float32, device=lp.device)
    xf, vf, xc, vc = zero, v0.expand(shape), zero, v0.expand(shape)
    for j in range(n_fine // 2):
        z1v, z1p = draw_normal_pair(key, idx, 2 * j)
        z2v, z2p = draw_normal_pair(key, idx, 2 * j + 1)
        xf, vf = _heston_step(xf, vf, sgn * z1v, sgn * z1p, kf, th, xi,
                              rho_c, rho_s, rf, sf)
        xf, vf = _heston_step(xf, vf, sgn * z2v, sgn * z2p, kf, th, xi,
                              rho_c, rho_s, rf, sf)
        zcv = (z1v + z2v) * inv
        zcp = (z1p + z2p) * inv
        xc, vc = _heston_step(xc, vc, sgn * zcv, sgn * zcp, kc, th, xi,
                              rho_c, rho_s, rc, sc)

    def pay(x):
        return torch.clamp(s0 * torch.exp(x) - k, min=0.0)

    return [pay(xf) - pay(xc)]



def level_plain_partials(lp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int,
                         n_fine: int) -> torch.Tensor:
    """Per-block ``[sum_d, sum_d2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``lp``'s device."""
    check_level(n_fine)
    return walk_partials(
        lambda key, idx, shape, sgn: _level_walk(lp, n_fine, key, idx, shape,
                                                 sgn),
        seed, block_offset, plan, n_blocks, lp.device)


def level_partials(lp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_fine: int,
                   scratch_cap: int = 0) -> torch.Tensor:
    """Per-block level partials ``(n_blocks, 2)``: K29 for a CUDA ``lp``,
    the plain version for a CPU ``lp``; any other device raises.
    ``scratch_cap``: K29's scratch in floats at most (0: 256 MB), past which
    it splits and folds simulation blocks and iterations in groups; the
    outputs do not depend on it."""
    check_level(n_fine)
    if lp.device.type == "cuda":
        out = launch_split_walk("mctpu_heston_level", lp, len(LEVEL_SCAL),
                                2, seed, block_offset, plan, n_blocks,
                                n_fine, None, scratch_cap)
        LAUNCHES["heston_level"] += 1
        return out
    if lp.device.type == "cpu":
        return level_plain_partials(lp, seed, block_offset, plan, n_blocks,
                                    n_fine)
    raise ValueError(f"unsupported device {lp.device}")
