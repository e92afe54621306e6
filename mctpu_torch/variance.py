"""Control-variate and importance-sampling pricers (counterpart of
:mod:`mctpu.variance`'s ``price_vanilla_cv``, ``price_asian_cv``,
``price_basket_cv``, ``optimal_tilt`` and ``price_vanilla_is``).

The regression-adjusted estimator

    Y_i = P_i - beta (C_i - E[C]),   beta* = Cov(P, C) / Var(C)

is unbiased for any fixed ``beta``.  ``beta`` is estimated on a disjoint
pilot run and applied to the main run, in two stages through the same
kernel (K45-K48, :mod:`mctpu_torch.kernels.varred`):

1. pilot: at most 8 blocks sized to ``pilot_frac`` of the main run's work,
   on the pilot seed, centered at the a-priori ``(p0, m)``; the float64
   pairwise combine regresses ``d`` on ``cc`` for ``db = beta - 1`` and
   takes the pilot mean ``mu_p`` of ``d - db cc``;
2. main: every block on the seed, re-centered at ``p0 + mu_p`` (rounded
   to float32), so every quadratic sum is O(n sigma^2) with no
   cancellation; ``sum_y = sum d - db sum cc`` and ``sum_y2`` follow from
   the five sums, the reference estimator runs on them, and the price is
   shifted back by the discounted center.

Each call synchronizes once between its two launches (the main stage's
center needs the pilot's combine).  ``m`` is the control's exact mean and
``p0`` a proxy for the payoff's, both formed in float64 on the CPU.

Seeds: ``mctpu`` draws its pilot from ``fold_in(key, 0x9E37)``, a Threefry
hash of its key.  The port takes an int32 seed and derives the pilot's
with :func:`pilot_seed`, so its price at a seed differs from ``mctpu``'s
at the matching key only in the pilot's draws; the main stage draws the
same stream.

:func:`price_vanilla_is` tilts K1's draw (K49): one launch on K1's plan and
seed, no pilot, so its price at a seed matches ``mctpu``'s at the key
whose ``key_to_seed`` is that seed.  Imports neither jax nor mctpu.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from mctpu_torch import estimator as mcest
from mctpu_torch import math as mcmath
from mctpu_torch.engine import (EngineConfig, _basket_plan, _discount,
                                _price, _terminal_plan, _walk_plan)
from mctpu_torch.kernels import varred as kvr
from mctpu_torch.kernels.common import Plan, seed_key
from mctpu_torch.parallel.reduce import pairwise_tree_sum
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import (AsianOption, BasketOption, McResult,
                               VanillaOption)

__all__ = ["price_vanilla_cv", "price_asian_cv", "price_basket_cv",
           "pilot_seed", "CvSetup", "cv_setup", "PILOT_WORD", "optimal_tilt",
           "price_vanilla_is", "level_seed"]

# The word mctpu folds into its key for the pilot stage
# (mctpu/variance.py, fold_in(key, 0x9E37)).
PILOT_WORD = 0x9E37


def pilot_seed(seed: int) -> int:
    """The pilot stage's int32 seed: the murmur3 fold of ``(seed,
    PILOT_WORD)`` that keys the kernels' streams (its first key word), as
    int32; never ``seed`` itself."""
    s = wrap_int32(seed_key(wrap_int32(seed), PILOT_WORD)[0])
    return s if s != wrap_int32(seed) else wrap_int32(s ^ PILOT_WORD)


def level_seed(seed: int, level: int, n_so_far: int) -> int:
    """The int32 seed of an MLMC level's run (:mod:`mctpu_torch.mlmc`): the
    murmur3 fold of ``(seed, level, n_so_far mod 2^32)`` that keys the
    kernels' streams, its first key word as int32.  ``n_so_far`` is the
    level's path count before the run, so each top-up draws afresh."""
    return wrap_int32(seed_key(wrap_int32(seed), level,
                               n_so_far % (1 << 32))[0])


def _pilot_plan(plan: Plan, pilot_frac: float) -> Plan:
    """The pilot's plan: ``min(8, num_blocks)`` blocks sized to about
    ``pilot_frac`` of the main run's work (``mctpu``'s, Python ``round``
    included)."""
    if not 0.0 < pilot_frac < 1.0:
        raise ValueError(f"pilot_frac must be in (0, 1), got {pilot_frac}")
    nb = min(8, plan.num_blocks)
    iters = max(1, round(plan.iters * plan.num_blocks * pilot_frac / nb))
    return dataclasses.replace(plan, num_blocks=nb, iters=iters)


class CvSetup(NamedTuple):
    """One CV pricer's launch: the main ``plan``, the float64 centers
    ``(p0, m)``, ``operands(center32)`` (the kernel's operands at float32
    centers, a ``(2,)`` CPU tensor) and the kernel wrapper and its plain
    version ``(ops, seed, block_offset, plan, n_blocks) -> (n_blocks, 5)``."""

    plan: Plan
    center: tuple
    operands: Callable
    partials: Callable
    plain_partials: Callable


def _recentered(x: torch.Tensor, center32: torch.Tensor) -> torch.Tensor:
    """``x`` with its last two entries (the centers) replaced."""
    return torch.cat([x[:-2], center32.to(x.device)])


def _vanilla_center(opt: VanillaOption):
    """``p0 = e^{rT} BS call`` (the exact undiscounted mean) and ``m = E[S_T]
    = s0 e^{rT}``, float64."""
    grow = torch.exp(torch.tensor(float(opt.r), dtype=torch.float64)
                     * torch.tensor(float(opt.t), dtype=torch.float64))
    p0 = grow * mcmath.bs_call(opt.s, opt.k, opt.r, opt.v, opt.t)
    return float(p0), float(torch.tensor(float(opt.s),
                                         dtype=torch.float64) * grow)


def _asian_center(opt: AsianOption):
    """``p0 = m = e^{rT}`` times the geometric Asian's exact price (the
    geometric mean is also the best cheap proxy of the arithmetic one)."""
    grow = torch.exp(torch.tensor(float(opt.r), dtype=torch.float64)
                     * torch.tensor(float(opt.t), dtype=torch.float64))
    m = float(grow * mcmath.geometric_asian_call(opt.s, opt.k, opt.r, opt.v,
                                                 opt.t, opt.n_obs))
    return m, m


def _basket_center(opt: BasketOption):
    """``m = sum_j w_j s0_j e^{rT + v_j sqrt(T) d_j}`` exactly, and ``p0``
    by Levy's moment matching: a lognormal with the basket's first two
    moments, priced by Black-76 (within a few percent; a centering
    shift)."""
    f64 = functools.partial(torch.as_tensor, dtype=torch.float64)
    s = f64(np.asarray(opt.s, np.float64))
    t, r, k = f64(float(opt.t)), f64(float(opt.r)), f64(float(opt.k))
    v = torch.broadcast_to(f64(np.asarray(opt.v, np.float64)), s.shape)
    fwd = s * torch.exp(r * t + v * torch.sqrt(t)
                        * f64(np.asarray(opt.d, np.float64)))
    wf = f64(np.asarray(opt.w, np.float64)) * fwd
    m1 = torch.sum(wf)
    cov = f64(np.asarray(opt.corr, np.float64)) * torch.outer(v, v) * t
    m2 = torch.sum(torch.outer(wf, wf) * torch.exp(cov))
    s2t = torch.log(torch.clamp(m2 / (m1 * m1), min=1.0 + 1e-12))
    sig = torch.sqrt(s2t)
    d1 = (torch.log(m1 / k) + 0.5 * s2t) / sig
    p0 = m1 * mcmath.norm_cdf(d1) - k * mcmath.norm_cdf(d1 - sig)
    return float(p0), float(m1)


def cv_setup(opt, n_paths: int, config: EngineConfig) -> CvSetup:
    """The launch a CV pricer makes for ``opt`` (a call
    :class:`VanillaOption`, an arithmetic :class:`AsianOption` or a
    :class:`BasketOption`): the engine's plan for its parent kernel (K1,
    K9, K2/K3), so the main run draws that kernel's stream."""
    dev = config.torch_device()
    if isinstance(opt, VanillaOption):
        center = _vanilla_center(opt)
        base = kvr.vanilla_cv_params(opt, center, dev)
        return CvSetup(_terminal_plan(n_paths, config), center,
                       functools.partial(_recentered, base),
                       kvr.vanilla_cv_partials,
                       kvr.vanilla_cv_plain_partials)
    if isinstance(opt, AsianOption):
        center = _asian_center(opt)
        base = kvr.asian_cv_params(opt, center, dev)
        n_obs = opt.n_obs
        return CvSetup(_walk_plan(n_paths, config), center,
                       functools.partial(_recentered, base),
                       functools.partial(kvr.asian_cv_partials, n_obs=n_obs),
                       functools.partial(kvr.asian_cv_plain_partials,
                                         n_obs=n_obs))
    if isinstance(opt, BasketOption):
        center = _basket_center(opt)
        base = kvr.basket_cv_operands(opt, mcmath.cholesky_lower(opt.corr),
                                      center, dev)

        def operands(c32):
            return dataclasses.replace(base,
                                       scal=_recentered(base.scal, c32))

        return CvSetup(_basket_plan(opt, n_paths, config), center, operands,
                       kvr.basket_cv_partials, kvr.basket_cv_plain_partials)
    raise TypeError(f"no control variate for {type(opt).__name__}")


def _combine(partials: torch.Tensor) -> torch.Tensor:
    """``(n_blocks, 5)`` sums -> float64 totals on the CPU (the fixed-order
    pairwise tree)."""
    return pairwise_tree_sum(partials.to(torch.float64), dim=0).cpu()


def _run_cv(opt, n_paths: int, seeds, config: EngineConfig,
            pilot_frac: float) -> McResult:
    """The two-stage estimator on the seed pair ``seeds = (main, pilot)``.

    The pilot runs at block offset 0 on its own seed, so the main run
    keeps every requested path.  The estimate is unbiased for any pilot
    outcome: ``Y = shift + d - db cc`` has ``E[Y] = E[p]`` for every
    ``(db, shift)``, and the main sample is independent of the pilot.
    """
    opt.validate()
    setup = cv_setup(opt, n_paths, config)
    plan = setup.plan
    pplan = _pilot_plan(plan, pilot_frac)
    seed, seed_p = (wrap_int32(s) for s in seeds)
    p0_w = torch.tensor(setup.center[0], dtype=torch.float64)
    center0 = kvr.center32(setup.center)

    # Stage 1: the pilot, centered at the a-priori (p0, m).
    pp = _combine(setup.partials(setup.operands(center0), seed_p, 0, pplan,
                                 pplan.num_blocks))
    n_p = float(pplan.total_units)
    tiny = torch.finfo(torch.float64).tiny
    db = (pp[4] - pp[0] * pp[2] / n_p) / (pp[3] - pp[2] * pp[2] / n_p + tiny)
    mu_p = (pp[0] - db * pp[2]) / n_p

    # Stage 2: every block, re-centered at the float32-rounded p0 + mu_p;
    # that same rounded value is the shift taken back below, so the algebra
    # is exact.
    center1 = torch.stack([(p0_w + mu_p).float(), center0[1]])
    shift = center1[0].double()
    mm = _combine(setup.partials(setup.operands(center1), seed, 0, plan,
                                 plan.num_blocks))
    sum_y = mm[0] - db * mm[2]
    sum_y2 = mm[1] - 2.0 * db * mm[4] + db * db * mm[3]
    disc = _discount(opt.r, opt.t)
    n_main = plan.total_units
    est = mcest.estimate(sum_y, sum_y2, n_main, discount=disc,
                         n_paths=plan.total_paths + pplan.total_paths)
    # Un-shift: Y = shift + yhat moves the price by disc * shift and leaves
    # the standard error as it is; report the uncentered sums of Y.
    nf = torch.tensor(float(n_main), dtype=torch.float64)
    return dataclasses.replace(
        est, price=est.price + disc * shift, sum_p=sum_y + nf * shift,
        sum_p2=sum_y2 + 2.0 * shift * sum_y + nf * shift * shift)


def price_vanilla_cv(opt: VanillaOption, n_paths: int, seed: int,
                     config: EngineConfig = EngineConfig(),
                     pilot_frac: float = 0.1) -> McResult:
    """European call price with the terminal spot as control variate
    (K45; ``E[S_T] = s0 e^{rT}`` exactly)."""
    if getattr(opt, "kind", "call") != "call":
        raise ValueError("price_vanilla_cv prices calls")
    return _run_cv(opt, n_paths, (seed, pilot_seed(seed)), config,
                   pilot_frac)


def price_asian_cv(opt: AsianOption, n_paths: int, seed: int,
                   config: EngineConfig = EngineConfig(),
                   pilot_frac: float = 0.1) -> McResult:
    """Arithmetic Asian call price with the geometric Asian call as control
    variate (K46; its mean is the exact closed form grown at the risk-free
    rate, about 99% correlated with the payoff)."""
    if opt.average != "arithmetic":
        raise ValueError("the geometric control variate prices the "
                         "arithmetic average")
    return _run_cv(opt, n_paths, (seed, pilot_seed(seed)), config,
                   pilot_frac)


def price_basket_cv(opt: BasketOption, n_paths: int, seed: int,
                    config: EngineConfig = EngineConfig(),
                    pilot_frac: float = 0.1) -> McResult:
    """Basket call price with the terminal basket value as control variate
    (K47 up to 8 assets, K48 beyond; ``E[C] = sum_j w_j s0_j e^{rT + v_j
    sqrt(T) d_j}`` exactly, the Brownian offset ``d`` included)."""
    return _run_cv(opt, n_paths, (seed, pilot_seed(seed)), config,
                   pilot_frac)


# ---------------------------------------------------------------------------
# Importance sampling (exponential tilting)
# ---------------------------------------------------------------------------

def optimal_tilt(opt: VanillaOption) -> float:
    """Drift shift that centers the sampler on the strike, in float64:
    under ``z ~ N(theta, 1)`` the spot's median lands on ``K`` when
    ``theta = (ln(K/S) - (r - v^2/2) T) / (v sqrt(T))``, floored at 0 (the
    standard heuristic, near-optimal for out-of-the-money calls)."""
    s, k, r, v, t = (float(x) for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
    return max((math.log(k / s) - (r - 0.5 * v * v) * t)
               / (v * math.sqrt(t)), 0.0)


def price_vanilla_is(opt: VanillaOption, n_paths: int, seed: int,
                     config: EngineConfig = EngineConfig(),
                     theta: float | None = None) -> McResult:
    """Importance-sampled European call (K49): samples ``z ~ N(theta, 1)``
    and reweights each payoff by the likelihood ratio ``exp(-theta z +
    theta^2 / 2)``, unbiased for any ``theta`` (default
    :func:`optimal_tilt`); deep out of the money, where plain Monte Carlo
    spends almost every path on a zero payoff, the variance drops by
    orders of magnitude.  One launch on K1's plan, discounted by
    ``exp(-rT)`` in float64."""
    opt.validate()
    if getattr(opt, "kind", "call") != "call":
        raise ValueError("importance sampling implemented for calls "
                         "(OTM puts: tilt negative via put-call parity)")
    if theta is None:
        theta = optimal_tilt(opt)
    dev = config.torch_device()
    plan = _terminal_plan(n_paths, config)
    par = kvr.is_params(opt, theta, dev)
    partials = kvr.is_partials(par, wrap_int32(seed), 0, plan,
                               plan.num_blocks)
    return _price(partials, plan, opt.r, opt.t)
