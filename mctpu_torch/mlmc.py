"""Multilevel Monte Carlo (Giles 2008) on the port's kernels (counterpart of
:mod:`mctpu.mlmc`).

    E[P_L] = E[P_0] + sum_{l=1..L} E[P_l - P_{l-1}]

Level 0 is the plain pricing kernel on the coarsest grid of ``n0`` steps or
dates (K27 Euler, K9, K12); each correction level ``l`` runs a coupled
kernel whose fine and coarse legs share their Brownian increments (K29 for
the Heston Euler walk, K11 for the Asian observation count, K14 for the
barrier monitoring count, :mod:`mctpu_torch.kernels`), so the level's
variance decays and the deep levels need few paths.  A level's sums go
through the engine's pipeline: per-block ``(sum_d, sum_d2)`` partials, the
fixed-order float64 pairwise combine, one host sync.

The Giles loop (:func:`_giles_price`) runs on the host: pilots on levels
0-2, the optimal allocation ``N_l ~ sqrt(V_l / C_l) sum_l sqrt(V_l C_l) /
(eps / sqrt(2))^2``, top-ups, and a new level until the weak-error estimate
``|mean_L| / (2^gamma - 1)`` falls under the bias budget.  Each top-up is a
setup, a launch, a combine and a ``float()``; the path count of a launch is
rounded up to whole tiles and a power-of-two iteration count
(:func:`_pow2_iters`), as ``mctpu`` rounds it.

Seeds: ``mctpu`` draws a level's run from ``fold_in(fold_in(key, level),
n_so_far)``, a Threefry hash of its key.  The port takes an int32 seed and
derives each run's seed with :func:`mctpu_torch.variance.level_seed`, the
murmur3 fold of ``(seed, level, n_so_far)``; so the port's MLMC price at a
seed differs from ``mctpu``'s at a key only in which streams the levels
draw: a level run at one seed draws what ``mctpu``'s draws at the key whose
``key_to_seed`` is that seed (:func:`level_partials`).  Imports neither jax
nor mctpu.
"""
from __future__ import annotations

import dataclasses
import math as pymath

import numpy as np

from mctpu_torch.engine import EngineConfig
from mctpu_torch.kernels import asian as kasian
from mctpu_torch.kernels import barrier as kbarrier
from mctpu_torch.kernels import heston as kheston
from mctpu_torch.kernels.common import LANES, Plan, walk_plan
from mctpu_torch.math import wide_dtype
from mctpu_torch.parallel.reduce import pairwise_tree_sum
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import (AsianOption, BarrierOption, HestonOption,
                               MlmcLevel, MlmcResult)
from mctpu_torch.variance import level_seed

__all__ = ["MlmcLevel", "MlmcResult", "price_heston_mlmc",
           "price_barrier_mlmc", "barrier_level_partials",
           "price_asian_mlmc", "level_partials", "asian_level_partials"]

_DEFAULT = EngineConfig(num_blocks=8, rows=8)  # mctpu's MLMC default


def _pow2_iters(plan: Plan) -> Plan:
    """Round the trip count up to a power of two (``mctpu``'s bound on
    compilations per level; paths are counted exactly either way)."""
    iters = 1 << (plan.iters - 1).bit_length()
    return dataclasses.replace(plan, iters=iters)


def _level_plan(n_paths: int, cfg: EngineConfig) -> Plan:
    """A level run's plan: ``layout_for(n_paths, 128)``, the walk plan,
    then :func:`_pow2_iters` (``mctpu.mlmc``'s)."""
    blocks, rows = cfg.layout_for(n_paths, LANES)
    return _pow2_iters(walk_plan(n_paths, blocks, rows, cfg.antithetic,
                                 cfg.precision.kahan))


def _combine(partials, plan: Plan):
    """``(sum, sum2, n)`` of a run's ``(n_blocks, 2)`` partials, through the
    fixed-order float64 pairwise tree."""
    total = pairwise_tree_sum(partials.to(wide_dtype()), dim=0).cpu()
    return float(total[0]), float(total[1]), plan.total_units


def level_partials(opt: HestonOption, seed: int, level: int, n0: int,
                   n_paths: int, cfg: EngineConfig):
    """``(sum_d, sum_d2, n)`` of the Heston level-``level`` correction:
    level 0 is K27's Euler walk over ``n0`` steps, level ``l`` K29's coupled
    walk over ``n0 2^l`` fine steps."""
    dev = cfg.torch_device()
    plan = _level_plan(n_paths, cfg)
    seed = wrap_int32(seed)
    if level == 0:
        par = kheston.params(opt, n0, False, dev)
        out = kheston.partials(par, seed, 0, plan, plan.num_blocks, n0, False)
    else:
        n_fine = n0 * 2 ** level
        lp = kheston.level_params(opt, n_fine, dev)
        out = kheston.level_partials(lp, seed, 0, plan, plan.num_blocks,
                                     n_fine)
    return _combine(out, plan)


def asian_level_partials(opt: AsianOption, seed: int, level: int, n0: int,
                         n_paths: int, cfg: EngineConfig):
    """``(sum_d, sum_d2, n)`` of the Asian level-``level`` correction:
    level 0 is K9 over ``n0`` dates, level ``l`` K11 over ``n0 2^l``
    (``opt.n_obs`` is ignored)."""
    dev = cfg.torch_device()
    plan = _level_plan(n_paths, cfg)
    seed = wrap_int32(seed)
    geometric = opt.average == "geometric"
    if level == 0:
        par = kasian.params(dataclasses.replace(opt, n_obs=n0), dev)
        out = kasian.partials(par, seed, 0, plan, plan.num_blocks, n0,
                              geometric)
    else:
        n_fine = n0 * 2 ** level
        lp = kasian.level_params(opt, n_fine, dev)
        out = kasian.level_partials(lp, seed, 0, plan, plan.num_blocks,
                                    n_fine, geometric)
    return _combine(out, plan)


def barrier_level_partials(opt: BarrierOption, seed: int, level: int,
                           n0: int, n_paths: int, cfg: EngineConfig):
    """``(sum_d, sum_d2, n)`` of the knock-out level-``level`` monitoring
    correction: level 0 is K12 over ``n0`` dates, level ``l`` K14 over
    ``n0 2^l`` (``opt.n_obs`` is ignored)."""
    dev = cfg.torch_device()
    plan = _level_plan(n_paths, cfg)
    seed = wrap_int32(seed)
    up = opt.kind == "up-and-out"
    if level == 0:
        par = kbarrier.params(dataclasses.replace(opt, n_obs=n0), dev)
        out = kbarrier.partials(par, seed, 0, plan, plan.num_blocks, n0, up)
    else:
        n_fine = n0 * 2 ** level
        lp = kbarrier.level_params(opt, n_fine, dev)
        out = kbarrier.level_partials(lp, seed, 0, plan, plan.num_blocks,
                                      n_fine, up)
    return _combine(out, plan)


def _giles_price(level_fn, level_cost, eps, seed, cfg: EngineConfig,
                 n_pilot: int, max_levels: int, bias_tol_factor: float,
                 discount: float, n_steps_of,
                 seed_of=None) -> MlmcResult:
    """The Giles allocation loop (pilot -> optimal N_l -> bias test), in
    ``mctpu``'s float order, so the same level sums give the same table to
    the bit.

    ``level_fn(lseed, level, n_paths) -> (sum, sum2, n)`` runs one level
    chunk; ``level_cost(level)`` is the per-path work; ``n_steps_of(level)``
    labels the level table; ``seed_of(level, n_so_far)`` gives a run's seed
    (default :func:`mctpu_torch.variance.level_seed` of ``seed``).
    """
    if seed_of is None:
        def seed_of(level, n_so_far):
            return level_seed(seed, level, n_so_far)

    min_chunk = cfg.num_blocks * 8 * LANES  # smallest level launch

    stats = {}   # level -> [sum, sum2, n]

    def add_paths(level: int, n_extra: int):
        if n_extra <= 0 and level in stats:
            return
        # A distinct seed per top-up: the level's current path count.
        lseed = seed_of(level, stats.get(level, [0, 0, 0])[2])
        s, s2, n = level_fn(lseed, level, max(n_extra, min_chunk))
        if level in stats:
            stats[level][0] += s
            stats[level][1] += s2
            stats[level][2] += n
        else:
            stats[level] = [s, s2, n]

    def mean_var(level: int):
        s, s2, n = stats[level]
        m = s / n
        v = max(s2 / n - m * m, 1e-30)
        return m, v, n

    levels = [0, 1, 2]
    for lv in levels:
        add_paths(lv, n_pilot)

    stat_budget2 = (eps * bias_tol_factor) ** 2
    for _ in range(32):  # outer allocation loop (bounded)
        terms = []
        for lv in levels:
            _, v, _ = mean_var(lv)
            terms.append(pymath.sqrt(v * level_cost(lv)))
        lam = sum(terms) / stat_budget2
        need = False
        for lv, t in zip(levels, terms):
            _, v, n = mean_var(lv)
            n_opt = int(pymath.ceil(lam * pymath.sqrt(v / level_cost(lv))))
            if n < n_opt:
                add_paths(lv, n_opt - n)
                need = True
        if need:
            continue
        if len(levels) >= 3:
            m_prev = abs(mean_var(levels[-2])[0])
            m_last = abs(mean_var(levels[-1])[0])
            gamma = 1.0
            if m_last > 0 and m_prev > 0:
                gamma = max(0.5, pymath.log2(m_prev / m_last))
            bias = m_last / (2.0 ** gamma - 1.0)
            if bias <= eps * pymath.sqrt(1.0 - bias_tol_factor ** 2):
                break
        if len(levels) >= max_levels:
            break
        nxt = levels[-1] + 1
        levels.append(nxt)
        add_paths(nxt, n_pilot)

    price = 0.0
    se2 = 0.0
    total_steps = 0.0
    table = []
    for lv in levels:
        m, v, n = mean_var(lv)
        price += m
        se2 += v / n
        total_steps += level_cost(lv) * n
        table.append(MlmcLevel(level=lv, n_steps=n_steps_of(lv), n_paths=n,
                               mean=m, var=v, cost=level_cost(lv)))
    se = discount * pymath.sqrt(se2)
    return MlmcResult(price=discount * price, ci=1.96 * se, std_error=se,
                      levels=tuple(table),
                      total_path_steps=total_steps).validate()


def _run(opt, level_partials_fn, eps: float, seed: int, config, n0: int,
         max_levels: int, n_pilot: int,
         bias_tol_factor: float) -> MlmcResult:
    """One product's Giles run: the level cost ``n0 2^l`` (level 0) or
    ``1.5 n0 2^l`` (fine + coarse), the level table labelled by the fine
    grid, the discount ``e^{-rT}``."""
    opt.validate()

    def level_fn(lseed, level, n_paths):
        return level_partials_fn(opt, lseed, level, n0, n_paths, config)

    def level_cost(level: int) -> float:
        return n0 * (2 ** level) * (1.0 if level == 0 else 1.5)

    disc = float(np.exp(-float(opt.r) * float(opt.t)))
    return _giles_price(level_fn, level_cost, eps, seed, config, n_pilot,
                        max_levels, bias_tol_factor, disc,
                        lambda lv: n0 * 2 ** lv)


def price_heston_mlmc(opt: HestonOption, eps: float, seed: int,
                      config: EngineConfig = _DEFAULT, n0: int = 8,
                      max_levels: int = 8, n_pilot: int = 1 << 14,
                      bias_tol_factor: float = 1.0 / np.sqrt(2.0),
                      ) -> MlmcResult:
    """Giles MLMC price of a European call under Heston (full-truncation
    Euler), to a root-mean-square error ``eps``: the statistical budget is
    ``eps bias_tol_factor`` and levels are added until the weak-error
    estimate falls under the rest.  Returns the discounted price with a 95%
    CI over the statistical part and the level table; the
    characteristic-function price
    (:func:`mctpu_torch.models.heston.cf_call_price`) is its oracle."""
    return _run(opt, level_partials, eps, seed, config, n0, max_levels,
                n_pilot, bias_tol_factor)


def price_asian_mlmc(opt: AsianOption, eps: float, seed: int,
                     config: EngineConfig = _DEFAULT, n0: int = 4,
                     max_levels: int = 10, n_pilot: int = 1 << 14,
                     bias_tol_factor: float = 1.0 / np.sqrt(2.0),
                     ) -> MlmcResult:
    """Giles MLMC price of the continuously monitored Asian call: level
    ``l`` averages over ``n0 2^l`` dates of one exact GBM path, targeting
    the continuous-monitoring limit (``opt.n_obs`` is ignored)."""
    return _run(opt, asian_level_partials, eps, seed, config, n0, max_levels,
                n_pilot, bias_tol_factor)


def price_barrier_mlmc(opt: BarrierOption, eps: float, seed: int,
                       config: EngineConfig = _DEFAULT, n0: int = 8,
                       max_levels: int = 12, n_pilot: int = 1 << 14,
                       bias_tol_factor: float = 1.0 / np.sqrt(2.0),
                       ) -> MlmcResult:
    """Giles MLMC price of the continuously monitored knock-out call: level
    ``l`` checks the barrier at ``n0 2^l`` dates, targeting the continuous
    limit (:func:`mctpu_torch.math.up_and_out_call` for an up-and-out);
    ``opt.n_obs`` is ignored."""
    return _run(opt, barrier_level_partials, eps, seed, config, n0,
                max_levels, n_pilot, bias_tol_factor)
