"""K19 and K20: the variance swap's fair strike and its sensitivities, one
realized-variance walk per unit (``csrc/varswap.cu``), under GBM or Heston.

Counterpart of :mod:`mctpu.kernels.varswap`.  The GBM leg walks ``n_obs``
log-returns ``lr = drift + vol z`` on the walk kernels' stream (as K9's and
K12's: reseeded per (block, iteration), both Box-Muller branches per draw,
the antithetic mirror replaying the same draws with ``-z``) and pays the
annualized realized variance ``(1/T) sum lr^2``, whose mean is the fair
strike, exactly ``v^2 + (r - v^2/2)^2 T / n``.  Its Greeks walk also carries
``sum lr``: vega, rho and theta (d/dT) are functions of the two sums alone
(:func:`_greek_quants`), and delta is identically zero.  The Heston leg
walks K27's Euler step on K27's stream (one Box-Muller pair per date) and
takes each log-return as the step's increment of ``x``; its Greeks walk
carries K28's tangents and sums ``d (lr^2) / dp = 2 lr d lr / dp`` for ``p``
in ``(v0, theta, kappa, xi)``, with rho ``(2 dt / T) sum lr``.  The leg is
told by the scalar count (3 or 10 for K19, 5 or 11 for K20).  The scalars
are formed in float32 on the CPU in the JAX kernels' expression order and
moved to the device.
"""
from __future__ import annotations

import torch

from mctpu_torch.kernels import heston as kheston
from mctpu_torch.kernels.common import (Plan, f32, launch_split_walk,
                                        sqrt32, walk_pairwise, walk_partials,
                                        walk_steps)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.models import asian as masian
from mctpu_torch.models import heston as mheston
from mctpu_torch.types import HestonOption, VanillaOption

__all__ = ["make_plan", "params", "heston_params", "plain_partials",
           "partials", "N_GREEK_SUMS_GBM", "N_GREEK_SUMS_HESTON",
           "greek_params", "heston_greek_params", "greek_plain_partials",
           "greek_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name and leg.
LAUNCHES = {"varswap": 0, "varswap_greeks": 0, "varswap_heston": 0,
            "varswap_heston_greeks": 0}

N_GREEK_SUMS_GBM = 8  # (sum, sum^2) of: rv, vega, rho, theta
N_GREEK_SUMS_HESTON = 12  # (sum, sum^2) of: rv, dv0, dtheta, dkappa, dxi,
#                           rho
# The scalars of each leg, in the JAX kernels' scal order.
GBM_SCAL = ("inv_t", "drift", "vol")
HESTON_SCAL = ("inv_t", "s0", "v0", "k_dt", "th", "xi", "rho_c", "rho_s",
               "r_dt", "sqdt")  # s0 is not read: the walk is log-relative
GBM_GREEK_SCAL = ("inv_t", "drift", "vol", "v", "dt")
HESTON_GREEK_SCAL = ("inv_t", "v0", "k_dt", "th", "xi", "rho_c", "rho_s",
                     "r_dt", "sqdt", "half_dt", "dt")


def params(opt: VanillaOption, n_obs: int, device) -> torch.Tensor:
    """``[1/t, drift, vol]`` of one step ``dt = t / n_obs`` in float32
    (K19's ``scal``)."""
    (t,) = f32(opt.t)
    drift, vol = masian.step_constants(opt, n_obs)
    return torch.stack([1.0 / t, drift, vol]).to(device)


def _heston_scalars(opt: HestonOption, n_obs: int):
    """``1/t``, the Heston inputs and one date's Euler constants in
    float32."""
    s, v0, kappa, theta, xi, rho, r, t = f32(
        opt.s, opt.v0, opt.kappa, opt.theta, opt.xi, opt.rho, opt.r, opt.t)
    dt, sqdt = mheston.step_constants(opt, n_obs)
    return (1.0 / t, s, v0, kappa * dt, theta, xi, rho,
            sqrt32(1.0 - rho * rho), r * dt, sqdt, dt)


def heston_params(opt: HestonOption, n_obs: int, device) -> torch.Tensor:
    """K19's Heston scalars (:data:`HESTON_SCAL`) in float32."""
    return torch.stack(_heston_scalars(opt, n_obs)[:10]).to(device)


def _walk(par, n_obs: int, key, idx, shape, sgn):
    """One walk of a ``(n_blocks, rows * 128)`` tile -> realized variance."""
    inv_t, drift, vol = par.unbind()

    def step(j, z, acc):
        lr = drift + vol * (sgn * z)
        return acc + lr * lr

    zero = torch.zeros(shape, dtype=torch.float32, device=par.device)
    return [walk_pairwise(key, idx, n_obs, step, zero) * inv_t]


def _heston_walk(par, n_obs: int, key, idx, shape, sgn):
    """One Heston walk of a tile -> realized variance: K27's Euler step,
    the log-return the step's increment of ``x``."""
    inv_t, _, v0, *consts = par.unbind()

    def step(j, z_v, z_perp, carry):
        x, v, acc = carry
        x_new, v_new = kheston._heston_step(x, v, sgn * z_v, sgn * z_perp,
                                            *consts)
        lr = x_new - x
        return x_new, v_new, acc + lr * lr

    zero = torch.zeros(shape, dtype=torch.float32, device=par.device)
    _, _, acc = walk_steps(key, idx, n_obs, step,
                           (zero, v0.expand(shape), zero))
    return [acc * inv_t]


def _is_heston(par: torch.Tensor, names) -> bool:
    return par.numel() == len(names)


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int) -> torch.Tensor:
    """Per-block ``[sum rv, sum rv^2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``par``'s device; the leg by ``par``'s length."""
    walk = _heston_walk if _is_heston(par, HESTON_SCAL) else _walk
    return walk_partials(
        lambda key, idx, shape, sgn: walk(par, n_obs, key, idx, shape, sgn),
        seed, block_offset, plan, n_blocks, par.device)


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, n_obs: int, scratch_cap: int = 0) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K19 (the Heston leg for the 10
    scalars of :func:`heston_params`, else GBM; a split walk and its fold,
    ``scratch_cap`` floats of scratch at most, 0 for 256 MB, the outputs
    the same) for a CUDA ``par``, the plain version for a CPU ``par``
    whatever the cap; any other device raises."""
    if par.device.type == "cuda":
        heston = _is_heston(par, HESTON_SCAL)
        names = HESTON_SCAL if heston else GBM_SCAL
        out = launch_split_walk("mctpu_varswap", par, len(names), 2, seed,
                                block_offset, plan, n_blocks, n_obs,
                                int(heston), scratch_cap)
        LAUNCHES["varswap_heston" if heston else "varswap"] += 1
        return out
    if par.device.type == "cpu":
        return plain_partials(par, seed, block_offset, plan, n_blocks, n_obs)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K20: with A = sum lr^2, B = sum lr and drift = (r - v^2/2) dt,
#   dRV/dv = (2/T) ((A - drift B) / v - v dt B),  dRV/dr = (2 dt / T) B,
#   dRV/dT = (drift / T^2) B,  dRV/ds0 = 0,
# in mctpu's _gbm_greek_quants expression order.
# ---------------------------------------------------------------------------

def greek_params(opt: VanillaOption, n_obs: int, device) -> torch.Tensor:
    """``[1/t, drift, vol, v, dt]`` in float32 (K20's ``scal``)."""
    r, v, t = f32(opt.r, opt.v, opt.t)
    dt = t / n_obs
    return torch.stack([1.0 / t, (r - 0.5 * v * v) * dt, v * torch.sqrt(dt),
                        v, dt]).to(device)


def _greek_quants(a2, a1, gp):
    """The per-path ``[rv, vega, rho, theta]`` of the two carried sums."""
    inv_t, drift, _, v, dt = gp.unbind()
    rv = a2 * inv_t
    gv = (2.0 * inv_t) * ((a2 - drift * a1) * (1.0 / v) - (v * dt) * a1)
    gr = ((2.0 * dt) * inv_t) * a1
    gt = ((drift * inv_t) * inv_t) * a1
    return [rv, gv, gr, gt]


def _greek_walk(gp, n_obs: int, key, idx, shape, sgn):
    """One Greeks walk of a ``(n_blocks, rows * 128)`` tile."""
    _, drift, vol, _, _ = gp.unbind()

    def step(j, z, carry):
        a2, a1 = carry
        lr = drift + vol * (sgn * z)
        return a2 + lr * lr, a1 + lr

    zero = torch.zeros(shape, dtype=torch.float32, device=gp.device)
    a2, a1 = walk_pairwise(key, idx, n_obs, step, (zero, zero))
    return _greek_quants(a2, a1, gp)


# ---------------------------------------------------------------------------
# K20, Heston leg: K28's tangent step; per date d(lr^2)/dp = 2 lr (al_p,new -
# al_p), summed per parameter (mctpu's _heston_greek_walk).
# ---------------------------------------------------------------------------

def heston_greek_params(opt: HestonOption, n_obs: int,
                        device) -> torch.Tensor:
    """K20's Heston scalars (:data:`HESTON_GREEK_SCAL`) in float32."""
    inv_t, _, v0, *consts, dt = _heston_scalars(opt, n_obs)
    return torch.stack([inv_t, v0, *consts, 0.5 * dt, dt]).to(device)


def _heston_greek_walk(gp, n_obs: int, key, idx, shape, sgn):
    """One Heston Greeks walk of a tile -> ``[rv, dv0, dtheta, dkappa,
    dxi, rho]``."""
    inv_t, v0, *consts = gp.unbind()
    dt = consts[-1]

    def step(j, z_v, z_perp, carry):
        x, v, tg, acc2, acc1, dacc = carry
        x_new, v_new, tg_new = kheston._greek_step(
            x, v, tg, sgn * z_v, sgn * z_perp, *consts)
        lr = x_new - x
        two_lr = 2.0 * lr
        dacc = tuple(d + two_lr * (tg_new[2 * i] - tg[2 * i])
                     for i, d in enumerate(dacc))
        return x_new, v_new, tg_new, acc2 + lr * lr, acc1 + lr, dacc

    zero = torch.zeros(shape, dtype=torch.float32, device=gp.device)
    init = (zero, v0.expand(shape), kheston.tangent_init(shape, gp.device),
            zero, zero, (zero,) * 4)
    _, _, _, acc2, acc1, dacc = walk_steps(key, idx, n_obs, step, init)
    return ([acc2 * inv_t] + [d * inv_t for d in dacc]
            + [((2.0 * dt) * inv_t) * acc1])


def greek_plain_partials(gp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int,
                         n_obs: int) -> torch.Tensor:
    """Per-block Greek partials in plain PyTorch on ``gp``'s device, over
    K19's stream: ``(n_blocks, 8)`` GBM, ``(n_blocks, 12)`` Heston (by
    ``gp``'s length)."""
    walk = (_heston_greek_walk if _is_heston(gp, HESTON_GREEK_SCAL)
            else _greek_walk)
    return walk_partials(
        lambda key, idx, shape, sgn: walk(gp, n_obs, key, idx, shape, sgn),
        seed, block_offset, plan, n_blocks, gp.device)


def greek_partials(gp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int,
                   scratch_cap: int = 0) -> torch.Tensor:
    """Greek partials, ``(n_blocks, 8)`` GBM or ``(n_blocks, 12)`` Heston:
    K20 for a CUDA ``gp`` (the Heston leg a split walk and its fold,
    ``scratch_cap`` floats of scratch at most, 0 for 256 MB, the outputs
    the same; the GBM leg takes no scratch), the plain version for a CPU
    ``gp`` whatever the cap; other devices raise."""
    if gp.device.type == "cuda":
        heston = _is_heston(gp, HESTON_GREEK_SCAL)
        names = HESTON_GREEK_SCAL if heston else GBM_GREEK_SCAL
        n_sums = N_GREEK_SUMS_HESTON if heston else N_GREEK_SUMS_GBM
        out = launch_split_walk("mctpu_varswap_greeks", gp, len(names),
                                n_sums, seed, block_offset, plan, n_blocks,
                                n_obs, int(heston), scratch_cap,
                                scratch_floats=None if heston else 0)
        LAUNCHES["varswap_heston_greeks" if heston else "varswap_greeks"] += 1
        return out
    if gp.device.type == "cpu":
        return greek_plain_partials(gp, seed, block_offset, plan, n_blocks,
                                    n_obs)
    raise ValueError(f"unsupported device {gp.device}")
