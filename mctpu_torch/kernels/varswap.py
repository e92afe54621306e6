"""K19 and K20, GBM leg: the variance swap's fair strike and its
sensitivities, one realized-variance walk per unit (``csrc/varswap.cu``).

Counterpart of the GBM branch of :mod:`mctpu.kernels.varswap`.  Each unit
walks ``n_obs`` log-returns ``lr = drift + vol z`` on the walk kernels'
stream (as K9's and K12's: reseeded per (block, iteration), both Box-Muller
branches per draw, the antithetic mirror replaying the same draws with
``-z``) and pays the annualized realized variance ``(1/T) sum lr^2``,
whose mean is the fair strike, exactly ``v^2 + (r - v^2/2)^2 T / n``.  The
Greeks walk also carries ``sum lr``: vega, rho and theta (d/dT) are
functions of the two sums alone (:func:`_greek_quants`), and delta is
identically zero.  The scalars are formed in float32 on the CPU in the JAX
kernels' expression order and moved to the device.  The Heston leg of both
kernels is not here.
"""
from __future__ import annotations

import torch

from mctpu_torch.kernels.common import (Plan, f32, launch_walk,
                                        walk_pairwise, walk_partials)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.models import asian as masian
from mctpu_torch.types import VanillaOption

__all__ = ["make_plan", "params", "plain_partials", "partials",
           "N_GREEK_SUMS_GBM", "greek_params", "greek_plain_partials",
           "greek_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"varswap": 0, "varswap_greeks": 0}

N_GREEK_SUMS_GBM = 8  # (sum, sum^2) of: rv, vega, rho, theta


def params(opt: VanillaOption, n_obs: int, device) -> torch.Tensor:
    """``[1/t, drift, vol]`` of one step ``dt = t / n_obs`` in float32
    (K19's ``scal``)."""
    (t,) = f32(opt.t)
    drift, vol = masian.step_constants(opt, n_obs)
    return torch.stack([1.0 / t, drift, vol]).to(device)


def _walk(par, n_obs: int, key, idx, shape, sgn):
    """One walk of a ``(n_blocks, rows * 128)`` tile -> realized variance."""
    inv_t, drift, vol = par.unbind()

    def step(j, z, acc):
        lr = drift + vol * (sgn * z)
        return acc + lr * lr

    zero = torch.zeros(shape, dtype=torch.float32, device=par.device)
    return [walk_pairwise(key, idx, n_obs, step, zero) * inv_t]


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int) -> torch.Tensor:
    """Per-block ``[sum rv, sum rv^2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``par``'s device."""
    return walk_partials(
        lambda key, idx, shape, sgn: _walk(par, n_obs, key, idx, shape, sgn),
        seed, block_offset, plan, n_blocks, par.device)


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, n_obs: int) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K19 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        out = launch_walk("mctpu_varswap", par, 3, 2, seed, block_offset,
                          plan, n_blocks, n_obs, 0)
        LAUNCHES["varswap"] += 1
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


def greek_plain_partials(gp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int,
                         n_obs: int) -> torch.Tensor:
    """Per-block ``(n_blocks, 8)`` Greek partials in plain PyTorch on
    ``gp``'s device, over K19's stream."""
    return walk_partials(
        lambda key, idx, shape, sgn: _greek_walk(gp, n_obs, key, idx, shape,
                                                 sgn),
        seed, block_offset, plan, n_blocks, gp.device)


def greek_partials(gp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int) -> torch.Tensor:
    """``(n_blocks, 8)`` Greek partials: K20 for a CUDA ``gp``, the plain
    version for a CPU ``gp``; other devices raise."""
    if gp.device.type == "cuda":
        out = launch_walk("mctpu_varswap_greeks", gp, 5, N_GREEK_SUMS_GBM,
                          seed, block_offset, plan, n_blocks, n_obs, 0)
        LAUNCHES["varswap_greeks"] += 1
        return out
    if gp.device.type == "cpu":
        return greek_plain_partials(gp, seed, block_offset, plan, n_blocks,
                                    n_obs)
    raise ValueError(f"unsupported device {gp.device}")
