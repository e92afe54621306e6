"""Engine-tier randomized QMC on Sobol nets (counterpart of
:mod:`mctpu.qmc_engine`).

Replicates are the block unit: each of ``R`` digitally shifted replicates
of the net is one simulation block, shifted by the Philox words of its
replicate id under the key words ``(0, seed)`` (``mctpu``'s
``key_data(PRNGKey(seed))`` for an int32 ``seed``, with no murmur3 fold).
Points stream in chunks through the fused kernels K52-K55
(:mod:`mctpu_torch.kernels.rqmc`), which emit per-replicate unfolded
Neumaier quads ``[s, c, s2, c2]``; the float64 estimator folds them and
forms the replicate-mean price and the replicate-spread CI, floored at the
float32 evaluation's accuracy.  ``n`` is the replicate count (the i.i.d.
unit), ``n_paths`` the total point count.
"""
from __future__ import annotations

import torch

from mctpu_torch import math as mcmath
from mctpu_torch.engine import EngineConfig, _discount
from mctpu_torch.kernels import basket as kbasket
from mctpu_torch.kernels import rqmc as krqmc
from mctpu_torch.kernels.common import LANES, Plan
from mctpu_torch.parallel.reduce import pairwise_tree_sum
from mctpu_torch.rng import M32
from mctpu_torch.sobol import MAX_DIM
from mctpu_torch.types import (AsianOption, BasketOption, GreeksResult,
                               McResult, VanillaOption)

__all__ = ["price_vanilla_rqmc", "price_basket_rqmc", "price_asian_rqmc",
           "greeks_vanilla_rqmc", "rqmc_plan", "rqmc_key",
           "F32_ACCURACY_FLOOR", "F32_GREEK_ACCURACY_FLOOR",
           "vanilla_rqmc_setup", "basket_rqmc_setup", "asian_rqmc_setup"]

# Relative accuracy floor of a float32 net evaluation: the normal quantile,
# exp and payoff in float32 carry a ~1e-5-relative systematic error, so a
# replicate spread below it is not real accuracy; the reported CI is
# floored.
F32_ACCURACY_FLOOR = 1e-5
# The Greek integrands amplify the quantile's error (the indicator-only
# outputs, rho and the likelihood-ratio gamma): a wider floor.
F32_GREEK_ACCURACY_FLOOR = 2e-4


def rqmc_key(seed: int) -> tuple[int, int]:
    """The replicate shifts' Philox key words of ``seed``: ``(0, seed mod
    2^32)``, the words of ``jax.random.PRNGKey(seed)``."""
    return 0, int(seed) & M32


def rqmc_plan(n_points: int, replicates: int, rows: int,
              pts_per_chunk: int | None = None) -> Plan:
    """``replicates`` blocks x ``iters`` chunks of ``pts_per_chunk`` points
    (default ``rows * 128``); ``n_points`` per replicate is rounded up to
    whole chunks."""
    ppc = rows * LANES if pts_per_chunk is None else pts_per_chunk
    return Plan(num_blocks=replicates, iters=max(1, -(-n_points // ppc)),
                rows=rows, paths_per_iter=ppc, units_per_iter=ppc,
                antithetic=False, kahan=False)


def _rqmc_layout(cfg: EngineConfig, n_points: int, replicates: int) -> int:
    """The chunk's rows: ``cfg.rows`` halved (not below 8) while a chunk of
    ``rows * 128`` points exceeds ``n_points``."""
    if replicates < 2:
        raise ValueError(
            f"replicates={replicates}: the RQMC randomization CI is the "
            "spread over >= 2 digitally-shifted replicates (1 replicate "
            "has no spread — its CI would be 0/0)")
    rows = cfg.rows
    if cfg.auto_shrink:
        while rows > 8 and rows * LANES > n_points:
            rows //= 2
    return rows


def _rqmc_estimate(partials: torch.Tensor, n_pts: int, disc,
                   floor: float = F32_ACCURACY_FLOOR) -> McResult:
    """Replicate-spread estimator of ``(R, 4)`` quads in float64: price =
    the replicate mean, CI = 1.96 x the two-pass replicate spread over
    sqrt(R), floored at ``floor`` times the price; the sums combine in the
    fixed pairwise order."""
    wide = mcmath.wide_dtype()
    p4 = partials.to(wide).cpu()
    p = torch.stack([p4[:, 0] + p4[:, 1], p4[:, 2] + p4[:, 3]], dim=1)
    r = p.shape[0]
    means = p[:, 0] / n_pts
    mean = pairwise_tree_sum(means, 0) / r
    dev = means - mean
    var = pairwise_tree_sum(dev * dev, 0) / (r - 1.0)
    disc = torch.as_tensor(disc, dtype=wide)
    se = disc * torch.sqrt(var / r)
    se = torch.maximum(se, floor * torch.abs(disc * mean))
    sums = pairwise_tree_sum(p, 0)
    return McResult(price=disc * mean, ci=1.96 * se, std_error=se,
                    sum_p=sums[0], sum_p2=sums[1], n=r, n_paths=r * n_pts)


def vanilla_rqmc_setup(opt: VanillaOption, n_points: int,
                       config: EngineConfig, replicates: int,
                       greeks: bool = False):
    """``(plan, operands)``: the launch :func:`price_vanilla_rqmc` (K52) or
    :func:`greeks_vanilla_rqmc` (K53) makes."""
    dev = config.torch_device()
    rows = _rqmc_layout(config, n_points, replicates)
    build = krqmc.greek_operands if greeks else krqmc.vanilla_operands
    return rqmc_plan(n_points, replicates, rows), build(opt, dev)


def basket_rqmc_setup(opt: BasketOption, n_points: int,
                      config: EngineConfig, replicates: int):
    """``(plan, operands)`` of :func:`price_basket_rqmc` (K54): ``c``
    packed paths a row, ``rows * c`` points a chunk."""
    dev = config.torch_device()
    _, c, _ = kbasket.pack_factor(opt.n_assets)
    rows = max(8, _rqmc_layout(config, -(-n_points // c) * LANES,
                               replicates))
    plan = rqmc_plan(n_points, replicates, rows, pts_per_chunk=rows * c)
    chol = mcmath.cholesky_lower(opt.corr)
    return plan, krqmc.basket_operands(opt, chol, dev)


def asian_rqmc_setup(opt: AsianOption, n_points: int, config: EngineConfig,
                     replicates: int):
    """``(plan, operands)`` of :func:`price_asian_rqmc` (K55): rows capped
    at ``max(8, 8192 // n_obs)``, as ``mctpu`` caps its VMEM scratch."""
    if opt.n_obs > MAX_DIM:
        raise ValueError(f"sobol asian supports n_obs <= {MAX_DIM}")
    dev = config.torch_device()
    rows = _rqmc_layout(config, n_points, replicates)
    rows = min(rows, max(8, 8192 // opt.n_obs))
    return (rqmc_plan(n_points, replicates, rows),
            krqmc.asian_operands(opt, dev))


def price_vanilla_rqmc(opt: VanillaOption, n_points: int, seed: int,
                       config: EngineConfig = EngineConfig(),
                       replicates: int = 16) -> McResult:
    """Sobol-RQMC European call or put price (K52): ``n_points`` per
    replicate, rounded up to whole ``rows * 128`` chunks; ``replicates``
    digital-shift copies give the CI."""
    opt.validate()
    plan, ops = vanilla_rqmc_setup(opt, n_points, config, replicates)
    partials = krqmc.vanilla_partials(ops, rqmc_key(seed), 0, plan,
                                      replicates, opt.kind == "put")
    return _rqmc_estimate(partials, plan.paths_per_block,
                          _discount(opt.r, opt.t))


def greeks_vanilla_rqmc(opt: VanillaOption, n_points: int, seed: int,
                        config: EngineConfig = EngineConfig(),
                        replicates: int = 16) -> GreeksResult:
    """The vanilla Greek surface (price, delta, vega, rho, theta, gamma,
    vanna, volga) on digitally shifted Sobol nets (K53), each output with
    its replicate-spread CI (floored at ``F32_GREEK_ACCURACY_FLOOR``)."""
    opt.validate()
    plan, ops = vanilla_rqmc_setup(opt, n_points, config, replicates,
                                   greeks=True)
    partials = krqmc.greek_partials(ops, rqmc_key(seed), 0, plan,
                                    replicates, opt.kind == "put")
    disc = _discount(opt.r, opt.t)

    def est(i):
        return _rqmc_estimate(partials[:, 4 * i:4 * i + 4],
                              plan.paths_per_block, disc,
                              floor=F32_GREEK_ACCURACY_FLOOR)

    return GreeksResult(price=est(0), delta=est(1), vega=est(2),
                        rho=est(3), theta=est(4), gamma=est(5),
                        vanna=est(6), volga=est(7))


def price_basket_rqmc(opt: BasketOption, n_points: int, seed: int,
                      config: EngineConfig = EngineConfig(),
                      replicates: int = 16) -> McResult:
    """Sobol-RQMC basket call (K54): the ``n_assets``-dim net, one point
    per lane-packed path."""
    opt.validate()
    plan, ops = basket_rqmc_setup(opt, n_points, config, replicates)
    partials = krqmc.basket_partials(ops, rqmc_key(seed), 0, plan,
                                     replicates)
    return _rqmc_estimate(partials, plan.paths_per_block,
                          _discount(opt.r, opt.t))


def price_asian_rqmc(opt: AsianOption, n_points: int, seed: int,
                     config: EngineConfig = EngineConfig(),
                     replicates: int = 16) -> McResult:
    """Sobol-RQMC Asian call via the Brownian bridge (K55): net dimension
    ``n_obs`` (up to 2048), streamed chunk by chunk."""
    opt.validate()
    plan, ops = asian_rqmc_setup(opt, n_points, config, replicates)
    partials = krqmc.asian_partials(ops, rqmc_key(seed), 0, plan,
                                    replicates, opt.average == "geometric")
    return _rqmc_estimate(partials, plan.paths_per_block,
                          _discount(opt.r, opt.t))
