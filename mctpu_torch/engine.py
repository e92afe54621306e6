"""The Monte Carlo engine of the port: pricing and Greeks drivers on one
device.

Counterpart of the main path of :mod:`mctpu.engine`:

    kernel (per-block partials, on the device)
      -> fixed-order float64 pairwise combine across blocks
        -> estimator (price, standard error, 95% CI) in float64

:func:`price_vanilla`, :func:`price_basket`, :func:`price_cva`,
:func:`price_cva_portfolio`, :func:`price_asian`, :func:`price_barrier`,
:func:`price_lookback`, :func:`price_cliquet`, :func:`price_heston`,
:func:`price_basket_asian`, :func:`price_basket_barrier`,
:func:`price_rainbow`, :func:`price_cva_multi`, :func:`price_xva` and
:func:`fair_variance_strike` take an int32
``seed`` word (the value ``mctpu.rng.key_to_seed`` gives a JAX key; see
:func:`mctpu_torch.rng.seed_from_generator`) and draw the same streams as the
JAX package's kernels in interpret mode, so a run here matches that run
block by block; so do :func:`price_vanilla_ladder`, :func:`price_book` and
:func:`price_barrier_book`, which return vector results.  :func:`greeks` and
the ``greeks_*`` drivers run the Greek kernels over the pricers' paths
(common random numbers with ``price_*``).  PyTorch runs eagerly: there is
no jit cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mctpu_torch import estimator as mcest
from mctpu_torch import math as mcmath
from mctpu_torch.kernels import asian as kasian
from mctpu_torch.kernels import barrier as kbarrier
from mctpu_torch.kernels import barrier_book as kbb
from mctpu_torch.kernels import basket as kbasket
from mctpu_torch.kernels import book as kbook
from mctpu_torch.kernels import cliquet as kcliquet
from mctpu_torch.kernels import cva as kcva
from mctpu_torch.kernels import cva_multi as kcm
from mctpu_torch.kernels import greeks as kgreeks
from mctpu_torch.kernels import heston as kheston
from mctpu_torch.kernels import ladder as kladder
from mctpu_torch.kernels import lookback as klookback
from mctpu_torch.kernels import lsm as klsm
from mctpu_torch.kernels import multi_walk as kmw
from mctpu_torch.kernels import rainbow as krainbow
from mctpu_torch.kernels import vanilla as kvanilla
from mctpu_torch.kernels import varswap as kvarswap
from mctpu_torch.kernels.common import LANES, walk_plan
from mctpu_torch.parallel.reduce import pairwise_tree_sum
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import (AmericanOption, AsianOption, BarrierBook,
                               BarrierOption,
                               BasketAsianOption, BasketBarrierOption,
                               BasketOption, CliquetOption, CvaGreeksResult,
                               CvaMultiSpec, CvaPortfolioSpec, CvaResult,
                               CvaSpec,
                               GreeksResult, HestonGreeksResult,
                               HestonOption, LookbackOption, McResult,
                               Precision, RainbowOption, VanillaBook,
                               VanillaOption, XvaGreeksResult, XvaResult,
                               XvaSpec)

__all__ = ["EngineConfig", "price_vanilla", "price_basket", "price_cva",
           "price_cva_portfolio", "price_asian", "price_barrier",
           "price_lookback", "price_cliquet", "price_vanilla_ladder",
           "price_book", "vanilla_setup", "basket_setup", "cva_setup",
           "asian_setup", "barrier_setup", "lookback_setup", "cliquet_setup",
           "ladder_setup", "book_setup", "greeks", "greeks_vanilla",
           "greeks_basket", "greeks_cva", "greeks_asian", "greeks_barrier",
           "greeks_lookback", "greeks_cliquet", "greeks_vanilla_ladder",
           "greeks_book", "greeks_vanilla_setup", "greeks_basket_setup",
           "greeks_cva_setup", "greeks_asian_setup", "greeks_barrier_setup",
           "greeks_lookback_setup", "greeks_cliquet_setup",
           "greeks_vanilla_ladder_setup", "greeks_book_setup",
           "fair_variance_strike", "greeks_varswap", "varswap_setup",
           "greeks_varswap_setup", "price_barrier_book",
           "greeks_barrier_book", "barrier_book_setup",
           "greeks_barrier_book_setup", "price_heston", "greeks_heston",
           "heston_setup", "greeks_heston_setup", "price_basket_asian",
           "price_basket_barrier", "greeks_basket_asian",
           "greeks_basket_barrier", "basket_asian_setup",
           "basket_barrier_setup", "greeks_basket_asian_setup",
           "greeks_basket_barrier_setup", "price_rainbow", "greeks_rainbow",
           "rainbow_setup", "greeks_rainbow_setup", "price_cva_multi",
           "greeks_cva_multi", "price_cva_multi_setup",
           "greeks_cva_multi_setup", "price_xva", "greeks_xva",
           "price_xva_setup", "greeks_xva_setup", "american_setup",
           "greeks_american", "greeks_american_setup"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Launch configuration.

    ``num_blocks`` simulation blocks (the stream and reduction unit) of
    ``rows x 128``-path tiles, before :meth:`layout_for` shrinks them for a
    small request; ``device`` is where the kernels run (``"cuda"`` runs the
    CUDA kernels, ``"cpu"`` their plain versions).
    """

    num_blocks: int = 512
    rows: int = 256
    precision: Precision = Precision.F32_KAHAN
    antithetic: bool = False
    auto_shrink: bool = True
    device: str = "cuda"

    def layout_for(self, n_paths: int, paths_per_block_iter_row: int):
        """``(num_blocks, rows)`` shrunk so the launch tracks small requests:
        blocks halve first (never below 8, staying a multiple of 8), then
        rows (never below 8) — ``mctpu.engine.EngineConfig.layout_for`` on
        one device, so both packages pick the same geometry and streams."""
        blocks, rows = self.num_blocks, self.rows
        if not self.auto_shrink:
            return blocks, rows
        min_blocks = 8
        while (blocks % 2 == 0 and blocks // 2 >= min_blocks
               and (blocks // 2) % min_blocks == 0
               and blocks * rows * paths_per_block_iter_row > n_paths):
            blocks //= 2
        while rows > 8 and blocks * rows * paths_per_block_iter_row > n_paths:
            rows //= 2
        return blocks, max(rows, 8)

    def torch_device(self) -> torch.device:
        """The configured device; raises if it cannot run here."""
        if self.precision is Precision.F64:
            raise NotImplementedError(
                "Precision.F64 is an XLA/Threefry path in mctpu, not a kernel; "
                "the port runs F32, F32_KAHAN and F32_DS")
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device!r} requested but CUDA "
                               "is not available")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device!r}")
        return dev


def _discount(r, t) -> torch.Tensor:
    wide = mcmath.wide_dtype()
    return torch.exp(-torch.tensor(float(r), dtype=wide)
                     * torch.tensor(float(t), dtype=wide))


def _price(partials, plan, r, t) -> McResult:
    """The discounted price estimate of ``(n_blocks, 2)`` partials."""
    sum_p, sum_p2 = mcest.combine_block_partials(partials)
    return mcest.estimate(sum_p, sum_p2, plan.total_units,
                          discount=_discount(r, t), n_paths=plan.total_paths)


def _walk_plan(n_paths: int, config: EngineConfig, ds: bool = False):
    """The plan of a walk kernel (CVA, Asian, barrier): ``rows * 128``
    units per (block, iteration), as ``mctpu``'s walk pricers lay it out."""
    anti = 2 if config.antithetic else 1
    blocks, rows = config.layout_for(n_paths, LANES * anti)
    return walk_plan(n_paths, blocks, rows, config.antithetic,
                     config.precision.kahan, ds=ds)


def _terminal_plan(n_paths: int, config: EngineConfig):
    """K1's plan, which every terminal-draw kernel runs (K1, K6, K21-K24):
    ``2 * rows * 128`` units per (block, iteration), both Box-Muller
    branches."""
    anti = 2 if config.antithetic else 1
    blocks, rows = config.layout_for(n_paths, 2 * LANES * anti)
    return kvanilla.make_plan(n_paths, blocks, rows, config.antithetic,
                              config.precision.kahan)


def vanilla_setup(opt: VanillaOption, n_paths: int, config: EngineConfig):
    """``(plan, params)``: the launch :func:`price_vanilla` makes."""
    dev = config.torch_device()
    return _terminal_plan(n_paths, config), kvanilla.params(opt, dev)


def price_vanilla(opt: VanillaOption, n_paths: int, seed: int,
                  config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of a European call or put (K1)."""
    opt.validate()
    plan, par = vanilla_setup(opt, n_paths, config)
    partials = kvanilla.partials(par, wrap_int32(seed), 0, plan,
                                 plan.num_blocks, opt.kind == "put")
    return _price(partials, plan, opt.r, opt.t)


def _basket_plan(opt, n_paths: int, config: EngineConfig):
    """The terminal basket kernels' plan (K2, K3, K7, K8 and the rainbow's
    K36-K38): ``2 * c * anti`` units a row, ``c`` = 128 asset-major."""
    anti = 2 if config.antithetic else 1
    a = opt.n_assets
    c = LANES if kbasket.use_asset_major(a) else kbasket.pack_factor(a)[1]
    blocks, rows = config.layout_for(n_paths, 2 * c * anti)
    return kbasket.make_plan(n_paths, blocks, rows, config.antithetic,
                             config.precision.kahan, n_assets=a)


def basket_setup(opt: BasketOption, n_paths: int, config: EngineConfig):
    """``(plan, operands)``: the launch :func:`price_basket` makes.  The
    correlation matrix is factorized in float64 on the host, then cast to
    float32 for the kernel."""
    dev = config.torch_device()
    chol = mcmath.cholesky_lower(opt.corr)
    return _basket_plan(opt, n_paths, config), kbasket.operands(opt, chol,
                                                                dev)


def price_basket(opt: BasketOption, n_paths: int, seed: int,
                 config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of a weighted basket call (K2 up to 8 assets, K3
    beyond)."""
    opt.validate()
    plan, ops = basket_setup(opt, n_paths, config)
    partials = kbasket.partials(ops, wrap_int32(seed), 0, plan,
                                plan.num_blocks)
    return _price(partials, plan, opt.r, opt.t)


def price_cva(spec: CvaSpec, n_paths: int, seed: int,
              config: EngineConfig = EngineConfig()) -> CvaResult:
    """CVA of a European call over ``spec.n_grid`` exposure nodes: the
    one-option case of :func:`price_cva_portfolio`."""
    spec.validate()
    return price_cva_portfolio(CvaPortfolioSpec.from_single(spec), n_paths,
                               seed, config)


def cva_setup(port: CvaPortfolioSpec, n_paths: int, config: EngineConfig):
    """``(plan, operands)``: the launch :func:`price_cva_portfolio` makes."""
    dev = config.torch_device()
    return (_walk_plan(n_paths, config, ds=config.precision.ds),
            kcva.operands(port, dev))


def price_cva_portfolio(port: CvaPortfolioSpec, n_paths: int, seed: int,
                        config: EngineConfig = EngineConfig()) -> CvaResult:
    """CVA of a netted portfolio of calls on one underlying (K4).

    The CVA is the undiscounted mean of the per-path default legs, as the
    reference's; ``expected_exposure`` is the per-node mean exposure and
    ``default_leg`` the deterministic masses at ``wwr_b = 0``.
    """
    port.validate()
    plan, ops = cva_setup(port, n_paths, config)
    partials, ee_sums = kcva.partials(ops, wrap_int32(seed), 0, plan,
                                      plan.num_blocks,
                                      wwr=float(port.wwr_b) != 0.0)
    sum_p, sum_p2 = mcest.combine_block_partials(partials)
    ee_profile = pairwise_tree_sum(ee_sums.to(mcmath.wide_dtype()), 0).cpu()
    res = mcest.estimate(sum_p, sum_p2, plan.total_units, discount=1.0,
                         n_paths=plan.total_paths)
    return CvaResult(
        cva=res.price,
        ci=res.ci,
        std_error=res.std_error,
        expected_exposure=ee_profile / plan.total_units,
        default_leg=mcmath.default_leg_weights(port.intensity, port.t,
                                               port.n_grid),
        n=plan.total_units,
        n_paths=plan.total_paths,
    )


def asian_setup(opt: AsianOption, n_paths: int, config: EngineConfig):
    """``(plan, params)``: the launch :func:`price_asian` makes."""
    dev = config.torch_device()
    return _walk_plan(n_paths, config), kasian.params(opt, dev)


def price_asian(opt: AsianOption, n_paths: int, seed: int,
                config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of a discretely monitored arithmetic or geometric
    Asian call (K9)."""
    opt.validate()
    plan, par = asian_setup(opt, n_paths, config)
    partials = kasian.partials(par, wrap_int32(seed), 0, plan,
                               plan.num_blocks, opt.n_obs,
                               opt.average == "geometric")
    return _price(partials, plan, opt.r, opt.t)


def barrier_setup(opt: BarrierOption, n_paths: int, config: EngineConfig):
    """``(plan, params)``: the launch :func:`price_barrier` makes."""
    dev = config.torch_device()
    return _walk_plan(n_paths, config), kbarrier.params(opt, dev)


def price_barrier(opt: BarrierOption, n_paths: int, seed: int,
                  config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of a discretely monitored up- or down-and-out
    barrier call (K12)."""
    opt.validate()
    plan, par = barrier_setup(opt, n_paths, config)
    partials = kbarrier.partials(par, wrap_int32(seed), 0, plan,
                                 plan.num_blocks, opt.n_obs,
                                 opt.kind == "up-and-out")
    return _price(partials, plan, opt.r, opt.t)


def lookback_setup(opt: LookbackOption, n_paths: int, config: EngineConfig):
    """``(plan, params)``: the launch :func:`price_lookback` makes."""
    dev = config.torch_device()
    return _walk_plan(n_paths, config), klookback.params(opt, dev)


def price_lookback(opt: LookbackOption, n_paths: int, seed: int,
                   config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of a discretely monitored floating- or fixed-strike
    lookback call or put (K15).  The floating call approaches the
    continuously monitored Goldman-Sosin-Gatto value
    (:func:`mctpu_torch.math.lookback_floating_call`) from below as
    ``n_obs`` grows."""
    opt.validate()
    plan, par = lookback_setup(opt, n_paths, config)
    partials = klookback.partials(par, wrap_int32(seed), 0, plan,
                                  plan.num_blocks, opt.n_obs,
                                  klookback.mode_of(opt))
    return _price(partials, plan, opt.r, opt.t)


def cliquet_setup(opt: CliquetOption, n_paths: int, config: EngineConfig):
    """``(plan, params)``: the launch :func:`price_cliquet` makes."""
    dev = config.torch_device()
    return _walk_plan(n_paths, config), kcliquet.params(opt, dev)


def price_cliquet(opt: CliquetOption, n_paths: int, seed: int,
                  config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of a locally capped and floored cliquet (K17),
    exact against :func:`mctpu_torch.math.cliquet_closed_form` at any
    period count."""
    opt.validate()
    plan, par = cliquet_setup(opt, n_paths, config)
    partials = kcliquet.partials(par, wrap_int32(seed), 0, plan,
                                 plan.num_blocks, opt.n_periods)
    return _price(partials, plan, opt.r, opt.t)


def _check_heston(opt: HestonOption, n_steps: int) -> None:
    opt.validate()
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")


def heston_setup(opt: HestonOption, n_paths: int, config: EngineConfig,
                 n_steps: int = 100, scheme: str = "euler"):
    """``(plan, params)``: the launch :func:`price_heston` makes."""
    dev = config.torch_device()
    return (_walk_plan(n_paths, config),
            kheston.params(opt, n_steps, scheme == "qe", dev))


def price_heston(opt: HestonOption, n_paths: int, seed: int,
                 config: EngineConfig = EngineConfig(), n_steps: int = 100,
                 scheme: str = "euler") -> McResult:
    """Monte Carlo price of a European call under Heston stochastic
    volatility (K27) over ``n_steps`` steps: ``scheme="euler"`` (full
    truncation, O(dt) bias) or ``"qe"`` (Andersen's quadratic-exponential,
    nearly unbiased at coarse grids).  The characteristic-function price
    (:func:`mctpu_torch.models.heston.cf_call_price`) is its oracle."""
    _check_heston(opt, n_steps)
    if scheme not in ("euler", "qe"):
        raise ValueError("scheme must be 'euler' or 'qe'")
    plan, par = heston_setup(opt, n_paths, config, n_steps, scheme)
    partials = kheston.partials(par, wrap_int32(seed), 0, plan,
                                plan.num_blocks, n_steps, scheme == "qe")
    return _price(partials, plan, opt.r, opt.t)


def _check_strikes(strikes) -> None:
    n_k = int(np.asarray(strikes, np.float64).shape[0])
    if not 1 <= n_k <= kladder.MAX_STRIKES:
        raise ValueError(f"strikes must have 1..{kladder.MAX_STRIKES} "
                         f"entries, got {n_k}")


def ladder_setup(opt: VanillaOption, strikes, n_paths: int,
                 config: EngineConfig):
    """``(plan, params, strikes)``: the launch :func:`price_vanilla_ladder`
    makes (K1's plan)."""
    _check_strikes(strikes)
    dev = config.torch_device()
    return (_terminal_plan(n_paths, config), kladder.params(opt, dev),
            kladder.strike_vector(strikes, dev))


def price_vanilla_ladder(opt: VanillaOption, strikes, n_paths: int,
                         seed: int,
                         config: EngineConfig = EngineConfig()) -> McResult:
    """Price a strike ladder of 1 to 64 strikes from one path sweep (K21):
    a vector :class:`McResult` whose fields have shape ``(K,)``.  Every
    strike reuses the same terminal draws, so call spreads and butterflies
    of the ladder are arbitrage-consistent up to MC noise; ``opt.k`` is
    ignored."""
    opt.validate()
    plan, par, ks = ladder_setup(opt, strikes, n_paths, config)
    partials = kladder.partials(par, ks, wrap_int32(seed), 0, plan,
                                plan.num_blocks, opt.kind == "put")
    total = _total(partials)
    return mcest.estimate(total[:, 0], total[:, 1], plan.total_units,
                          discount=_discount(opt.r, opt.t),
                          n_paths=plan.total_paths)


def _check_book(book: VanillaBook) -> None:
    book.validate()
    m = book.n_instruments
    if m > kbook.MAX_BOOK:
        raise ValueError(f"book holds {m} instruments; max {kbook.MAX_BOOK}"
                         " per fused sweep (split larger books)")


def _book_discount(book) -> torch.Tensor:
    """Each instrument's own float64 ``exp(-r_i t_i)`` (a
    :class:`VanillaBook` or a :class:`BarrierBook`)."""
    r, t = (torch.tensor(np.asarray(x, np.float64).reshape(-1),
                         dtype=mcmath.wide_dtype()) for x in (book.r, book.t))
    return torch.exp(-r * t)


def book_setup(book: VanillaBook, n_paths: int, config: EngineConfig):
    """``(plan, params)``: the launch :func:`price_book` makes (K1's
    plan)."""
    _check_book(book)
    dev = config.torch_device()
    return _terminal_plan(n_paths, config), kbook.params(book, dev)


def price_book(book: VanillaBook, n_paths: int, seed: int,
               config: EngineConfig = EngineConfig()) -> McResult:
    """Price a book of 1 to 64 heterogeneous calls and puts from one path
    sweep (K23): a vector :class:`McResult` of shape ``(M,)``, each
    instrument discounted by its own ``exp(-r_i t_i)``.  All instruments
    share the standard-normal draws, so the marks are comonotone across the
    book; a one-instrument book equals :func:`price_vanilla`."""
    plan, par = book_setup(book, n_paths, config)
    partials = kbook.partials(par, wrap_int32(seed), 0, plan,
                              plan.num_blocks)
    total = _total(partials)
    return mcest.estimate(total[:, 0], total[:, 1], plan.total_units,
                          discount=_book_discount(book),
                          n_paths=plan.total_paths)


# ---------------------------------------------------------------------------
# Greeks: the pricing kernels' paths, with the Greek integrands summed beside
# the payoff (K5-K8); every output is a full estimate with its own CI.
# ---------------------------------------------------------------------------

def _estimates(total, n: int, plan, discount):
    """One :class:`McResult` per ``(sum, sum^2)`` pair of ``total``."""
    return [mcest.estimate(total[2 * i], total[2 * i + 1], n,
                           discount=discount, n_paths=plan.total_paths)
            for i in range(total.shape[0] // 2)]


def _total(partials) -> torch.Tensor:
    """Per-block partials combined across blocks in float64, on the CPU."""
    return pairwise_tree_sum(partials.to(mcmath.wide_dtype()), 0).cpu()


def greeks_vanilla_setup(opt: VanillaOption, n_paths: int,
                         config: EngineConfig):
    """``(plan, params)``: the launch :func:`greeks_vanilla` makes."""
    dev = config.torch_device()
    return _terminal_plan(n_paths, config), kgreeks.params(opt, dev)


def greeks_vanilla(opt: VanillaOption, n_paths: int, seed: int,
                   config: EngineConfig = EngineConfig()) -> GreeksResult:
    """Price + delta/vega/rho/theta/gamma/vanna/volga of a European call or
    put in one sweep (K6): pathwise first-order Greeks, mixed pathwise-
    likelihood-ratio second-order ones, over :func:`price_vanilla`'s paths."""
    opt.validate()
    plan, par = greeks_vanilla_setup(opt, n_paths, config)
    partials = kgreeks.partials(par, wrap_int32(seed), 0, plan,
                                plan.num_blocks, opt.kind == "put")
    total = _total(partials)
    price, delta, vega, rho, theta, gamma, vanna, volga = _estimates(
        total, plan.total_units, plan, _discount(opt.r, opt.t))
    return GreeksResult(price=price, delta=delta, vega=vega, rho=rho,
                        theta=theta, gamma=gamma, vanna=vanna, volga=volga)


def greeks_basket_setup(opt: BasketOption, n_paths: int,
                        config: EngineConfig):
    """``(plan, operands, gamma_ok)``: the launch :func:`greeks_basket`
    makes (K7's operands up to 8 assets, K8's beyond); ``gamma_ok`` is
    false when the correlation admits no Stein tilt."""
    dev = config.torch_device()
    plan = _basket_plan(opt, n_paths, config)
    chol = mcmath.cholesky_lower(opt.corr)
    evec, gvec, ok = kgreeks.tilt_direction(chol)
    build = (kgreeks.am_operands if kbasket.use_asset_major(opt.n_assets)
             else kgreeks.packed_operands)
    return plan, build(opt, chol, (evec, gvec), dev), ok


def greeks_basket(opt: BasketOption, n_paths: int, seed: int,
                  config: EngineConfig = EngineConfig()) -> GreeksResult:
    """Price, scalar rho and theta, and per-asset delta, vega and diagonal
    gamma vectors of the basket call, over :func:`price_basket`'s paths
    (K7 up to 8 assets, K8 beyond).  ``gamma`` is ``None`` when the
    correlation is rank-deficient with no sign-definite Stein tilt
    (:func:`mctpu_torch.kernels.greeks.tilt_direction`)."""
    opt.validate()
    a = opt.n_assets
    plan, ops, gamma_ok = greeks_basket_setup(opt, n_paths, config)
    if kbasket.use_asset_major(a):
        partials = kgreeks.am_partials(ops, wrap_int32(seed), 0, plan,
                                       plan.num_blocks)
        total = _total(partials)
        scal, vec = total[:6], total[6:].reshape(a, 6).T
    else:
        partials, vecs = kgreeks.packed_partials(ops, wrap_int32(seed), 0,
                                                 plan, plan.num_blocks)
        scal = _total(partials)
        a_tile, c, _ = kbasket.pack_factor(a)
        vec = _total(vecs)
        # Fold the c packed path groups back onto the asset slots.
        vec = pairwise_tree_sum(vec.reshape(6, c, a_tile), 1)[:, :a]
    disc = _discount(opt.r, opt.t)
    n = plan.total_units
    price, rho, theta = _estimates(scal, n, plan, disc)
    delta, vega, gamma = _estimates(vec, n, plan, disc)
    return GreeksResult(price=price, delta=delta, vega=vega, rho=rho,
                        theta=theta, gamma=gamma if gamma_ok else None)


def greeks_cva_setup(port: CvaPortfolioSpec, n_paths: int,
                     config: EngineConfig):
    """``(plan, operands)``: the launch :func:`greeks_cva` makes."""
    dev = config.torch_device()
    # No double-single walk state: the Greeks plan is mctpu's, without ds.
    return _walk_plan(n_paths, config), kcva.greek_operands(port, dev)


def greeks_cva(spec, n_paths: int, seed: int,
               config: EngineConfig = EngineConfig()) -> CvaGreeksResult:
    """CVA + credit delta, spot delta, vega, spot gamma, credit gamma and
    cross gamma of a :class:`CvaSpec` or :class:`CvaPortfolioSpec`
    (netting, and wrong-way risk when ``wwr_b != 0``) in one sweep (K5),
    over :func:`price_cva_portfolio`'s paths, each with the CVA's
    undiscounted-mean semantics.

    As in ``mctpu.engine.greeks_cva``, the Greeks plan carries no
    double-single walk state: under ``Precision.F32_DS`` the walk is the
    plain float32 one (with Kahan-compensated block sums).
    """
    if isinstance(spec, CvaSpec):
        spec = CvaPortfolioSpec.from_single(spec)
    spec.validate()
    plan, ops = greeks_cva_setup(spec, n_paths, config)
    partials = kcva.greek_partials(ops, wrap_int32(seed), 0, plan,
                                   plan.num_blocks,
                                   wwr=float(spec.wwr_b) != 0.0)
    total = _total(partials)
    cva, credit_delta, delta, vega, gamma, credit_gamma, cross_gamma = (
        _estimates(total, plan.total_units, plan, 1.0))
    return CvaGreeksResult(cva=cva, credit_delta=credit_delta, delta=delta,
                           vega=vega, gamma=gamma, credit_gamma=credit_gamma,
                           cross_gamma=cross_gamma)


def greeks_asian_setup(opt: AsianOption, n_paths: int,
                       config: EngineConfig):
    """``(plan, params)``: the launch :func:`greeks_asian` makes (the
    pricer's plan)."""
    dev = config.torch_device()
    return _walk_plan(n_paths, config), kasian.greek_params(opt, dev)


def greeks_asian(opt: AsianOption, n_paths: int, seed: int,
                 config: EngineConfig = EngineConfig()) -> GreeksResult:
    """Price, pathwise delta, vega and rho and the Stein-tilt gamma of an
    Asian call in one sweep (K10), over :func:`price_asian`'s paths.

    The price forms the average as ``acc * (1 / n_obs)`` where the pricer
    divides, so it equals :func:`price_asian`'s to about an ulp per path,
    not to the bit."""
    opt.validate()
    plan, gp = greeks_asian_setup(opt, n_paths, config)
    partials = kasian.greek_partials(gp, wrap_int32(seed), 0, plan,
                                     plan.num_blocks, opt.n_obs,
                                     opt.average == "geometric")
    price, delta, vega, rho, gamma = _estimates(
        _total(partials), plan.total_units, plan, _discount(opt.r, opt.t))
    return GreeksResult(price=price, delta=delta, vega=vega, rho=rho,
                        gamma=gamma)


def greeks_barrier_setup(opt: BarrierOption, n_paths: int,
                         config: EngineConfig):
    """``(plan, params)``: the launch :func:`greeks_barrier` makes (the
    pricer's plan)."""
    dev = config.torch_device()
    return _walk_plan(n_paths, config), kbarrier.greek_params(opt, dev)


def greeks_barrier(opt: BarrierOption, n_paths: int, seed: int,
                   config: EngineConfig = EngineConfig()) -> GreeksResult:
    """Price and likelihood-ratio delta, vega and rho of a knock-out
    barrier call in one sweep (K13), over :func:`price_barrier`'s paths.
    The knock-out is discontinuous in every parameter, so pathwise
    derivatives would be biased; the LR scores are unbiased for the
    discretely monitored product, and their variance grows about linearly
    in ``n_obs``."""
    opt.validate()
    plan, gp = greeks_barrier_setup(opt, n_paths, config)
    partials = kbarrier.greek_partials(gp, wrap_int32(seed), 0, plan,
                                       plan.num_blocks, opt.n_obs,
                                       opt.kind == "up-and-out")
    price, delta, vega, rho = _estimates(
        _total(partials), plan.total_units, plan, _discount(opt.r, opt.t))
    return GreeksResult(price=price, delta=delta, vega=vega, rho=rho)


def greeks_lookback_setup(opt: LookbackOption, n_paths: int,
                          config: EngineConfig):
    """``(plan, params)``: the launch :func:`greeks_lookback` makes (the
    pricer's plan)."""
    dev = config.torch_device()
    return _walk_plan(n_paths, config), klookback.greek_params(opt, dev)


def greeks_lookback(opt: LookbackOption, n_paths: int, seed: int,
                    config: EngineConfig = EngineConfig()) -> GreeksResult:
    """Price and pathwise delta, vega and rho of a lookback option in one
    sweep (K16), over :func:`price_lookback`'s paths.  Delta is the
    homogeneity identity (``price / s0`` for the floating kind); vega and
    rho follow the tangent and the date of the arg-extreme.  A fixed strike
    at ``k == s0`` has no delta: the extreme has an atom at ``s0``, and the
    estimator returns the left derivative."""
    opt.validate()
    plan, gp = greeks_lookback_setup(opt, n_paths, config)
    partials = klookback.greek_partials(gp, wrap_int32(seed), 0, plan,
                                        plan.num_blocks, opt.n_obs,
                                        klookback.mode_of(opt))
    price, delta, vega, rho = _estimates(
        _total(partials), plan.total_units, plan, _discount(opt.r, opt.t))
    return GreeksResult(price=price, delta=delta, vega=vega, rho=rho)


def greeks_cliquet_setup(opt: CliquetOption, n_paths: int,
                         config: EngineConfig):
    """``(plan, params)``: the launch :func:`greeks_cliquet` makes (the
    pricer's plan)."""
    dev = config.torch_device()
    return _walk_plan(n_paths, config), kcliquet.greek_params(opt, dev)


def greeks_cliquet(opt: CliquetOption, n_paths: int, seed: int,
                   config: EngineConfig = EngineConfig()) -> GreeksResult:
    """Price and pathwise vega, rho and theta (d/dT) of a cliquet in one
    sweep (K18), over :func:`price_cliquet`'s paths.  The payoff depends on
    returns only, so delta and gamma are identically zero: they come back
    as exact ``0 +- 0`` estimates, as in ``mctpu.engine.greeks_cliquet``."""
    opt.validate()
    plan, gp = greeks_cliquet_setup(opt, n_paths, config)
    partials = kcliquet.greek_partials(gp, wrap_int32(seed), 0, plan,
                                       plan.num_blocks, opt.n_periods)
    n, disc = plan.total_units, _discount(opt.r, opt.t)
    price, vega, rho, theta = _estimates(_total(partials), n, plan, disc)
    zero = mcest.estimate(0.0, 0.0, n, discount=disc,
                          n_paths=plan.total_paths)
    return GreeksResult(price=price, delta=zero, vega=vega, rho=rho,
                        theta=theta, gamma=zero)


def greeks_heston_setup(opt: HestonOption, n_paths: int,
                        config: EngineConfig, n_steps: int = 100):
    """``(plan, params)``: the launch :func:`greeks_heston` makes (the
    pricer's plan)."""
    dev = config.torch_device()
    return _walk_plan(n_paths, config), kheston.greek_params(opt, n_steps,
                                                             dev)


def greeks_heston(opt: HestonOption, n_paths: int, seed: int,
                  config: EngineConfig = EngineConfig(),
                  n_steps: int = 100) -> HestonGreeksResult:
    """Price and pathwise delta, vega (dV/dv0), rho, dtheta, dkappa and dxi
    of a Heston call in one sweep (K28), over the Euler walk of
    :func:`price_heston`'s paths: four forward-mode tangent pairs ride the
    walk.  The payoff is continuous in the parameters, so the pathwise
    estimates are unbiased for the discretized scheme's price; where the
    Feller condition ``2 kappa theta >= xi^2`` fails, the variance tangents
    are heavy-tailed and their standard errors converge slowly."""
    _check_heston(opt, n_steps)
    plan, gp = greeks_heston_setup(opt, n_paths, config, n_steps)
    partials = kheston.greek_partials(gp, wrap_int32(seed), 0, plan,
                                      plan.num_blocks, n_steps)
    price, delta, vega, rho, dtheta, dkappa, dxi = _estimates(
        _total(partials), plan.total_units, plan, _discount(opt.r, opt.t))
    return HestonGreeksResult(price=price, delta=delta, vega=vega, rho=rho,
                              dtheta=dtheta, dkappa=dkappa, dxi=dxi)


def _vector_greeks(total, plan, discount) -> GreeksResult:
    """Price, delta, vega, rho, theta and gamma of ``(K, 12)`` combined
    partials, each a vector :class:`McResult`."""
    price, delta, vega, rho, theta, gamma = _estimates(
        total.T, plan.total_units, plan, discount)
    return GreeksResult(price=price, delta=delta, vega=vega, rho=rho,
                        theta=theta, gamma=gamma)


def greeks_vanilla_ladder_setup(opt: VanillaOption, strikes, n_paths: int,
                                config: EngineConfig):
    """``(plan, params, strikes)``: the launch :func:`greeks_vanilla_ladder`
    makes (the ladder pricer's plan)."""
    _check_strikes(strikes)
    dev = config.torch_device()
    return (_terminal_plan(n_paths, config), kladder.greek_params(opt, dev),
            kladder.strike_vector(strikes, dev))


def greeks_vanilla_ladder(opt: VanillaOption, strikes, n_paths: int,
                          seed: int,
                          config: EngineConfig = EngineConfig()
                          ) -> GreeksResult:
    """The per-strike risk ladder from one path sweep (K22): price, delta,
    vega, rho, theta and gamma at every strike, each a vector
    :class:`McResult` of shape ``(K,)``, over :func:`price_vanilla_ladder`'s
    paths.  The integrands are K6's; the call delta ladder falls in the
    strike path by path."""
    opt.validate()
    plan, gp, ks = greeks_vanilla_ladder_setup(opt, strikes, n_paths, config)
    partials = kladder.greek_partials(gp, ks, wrap_int32(seed), 0, plan,
                                      plan.num_blocks, opt.kind == "put")
    return _vector_greeks(_total(partials), plan, _discount(opt.r, opt.t))


def greeks_book_setup(book: VanillaBook, n_paths: int, config: EngineConfig):
    """``(plan, table)``: the launch :func:`greeks_book` makes (the book
    pricer's plan)."""
    _check_book(book)
    dev = config.torch_device()
    return _terminal_plan(n_paths, config), kbook.greek_const_rows(book, dev)


def greeks_book(book: VanillaBook, n_paths: int, seed: int,
                config: EngineConfig = EngineConfig()) -> GreeksResult:
    """The whole book's risk run from one path sweep (K24): price, delta,
    vega, rho, theta and gamma of every instrument, each a vector
    :class:`McResult` of shape ``(M,)``, over :func:`price_book`'s paths.
    Delta and vega are with respect to each instrument's own spot and vol
    (the diagonal of the book's Jacobian)."""
    plan, cvec = greeks_book_setup(book, n_paths, config)
    partials = kbook.greek_partials(cvec, wrap_int32(seed), 0, plan,
                                    plan.num_blocks)
    return _vector_greeks(_total(partials), plan, _book_discount(book))


def _check_varswap(opt, n_obs: int) -> None:
    if not isinstance(opt, (VanillaOption, HestonOption)):
        raise TypeError(
            "the variance swap takes a VanillaOption (GBM dynamics) or a "
            f"HestonOption (Heston dynamics), got {type(opt).__name__}")
    opt.validate()
    if n_obs < 1:
        raise ValueError("n_obs must be >= 1")


def varswap_setup(opt, n_paths: int, config: EngineConfig,
                  n_obs: int = 252):
    """``(plan, params)``: the launch :func:`fair_variance_strike` makes
    (the Heston leg's scalars for a :class:`HestonOption`)."""
    dev = config.torch_device()
    make = (kvarswap.heston_params if isinstance(opt, HestonOption)
            else kvarswap.params)
    return _walk_plan(n_paths, config), make(opt, n_obs, dev)


def fair_variance_strike(opt, n_paths: int, seed: int,
                         config: EngineConfig = EngineConfig(),
                         n_obs: int = 252) -> McResult:
    """Fair strike of a variance swap (K19): ``E[(1/T) sum_j ln(S_j /
    S_{j-1})^2]`` over ``n_obs`` equal dates, in variance units and
    undiscounted (a strike, not a price).  A :class:`VanillaOption` walks
    GBM, exactly ``v^2 + (r - v^2/2)^2 T / n`` (``opt.k`` and ``opt.kind``
    are not used); a :class:`HestonOption` the Euler Heston walk, whose
    strike approaches ``theta + (v0 - theta)(1 - e^{-kappa T})/(kappa T)``
    as ``n_obs`` grows.  Any other record raises ``TypeError``."""
    _check_varswap(opt, n_obs)
    plan, par = varswap_setup(opt, n_paths, config, n_obs)
    partials = kvarswap.partials(par, wrap_int32(seed), 0, plan,
                                 plan.num_blocks, n_obs)
    sum_p, sum_p2 = mcest.combine_block_partials(partials)
    return mcest.estimate(sum_p, sum_p2, plan.total_units, discount=1.0,
                          n_paths=plan.total_paths)


def greeks_varswap_setup(opt, n_paths: int, config: EngineConfig,
                         n_obs: int = 252):
    """``(plan, params)``: the launch :func:`greeks_varswap` makes (the
    fair-strike plan)."""
    dev = config.torch_device()
    make = (kvarswap.heston_greek_params if isinstance(opt, HestonOption)
            else kvarswap.greek_params)
    return _walk_plan(n_paths, config), make(opt, n_obs, dev)


def greeks_varswap(opt, n_paths: int, seed: int,
                   config: EngineConfig = EngineConfig(), n_obs: int = 252):
    """The fair strike and its sensitivities in one sweep (K20), over
    :func:`fair_variance_strike`'s paths, each undiscounted.  GBM: a
    :class:`GreeksResult` with vega (d/dv), rho (d/dr) and theta (d/dT).
    Heston: a :class:`HestonGreeksResult` with vega (d/dv0), dtheta, dkappa,
    dxi and rho.  Log-returns do not depend on the spot, so delta is an
    exact ``0 +- 0`` estimate in both, as in ``mctpu.engine.greeks_varswap``.
    """
    _check_varswap(opt, n_obs)
    plan, gp = greeks_varswap_setup(opt, n_paths, config, n_obs)
    partials = kvarswap.greek_partials(gp, wrap_int32(seed), 0, plan,
                                       plan.num_blocks, n_obs)
    n = plan.total_units
    est = _estimates(_total(partials), n, plan, 1.0)
    zero = mcest.estimate(0.0, 0.0, n, discount=1.0, n_paths=plan.total_paths)
    if isinstance(opt, HestonOption):
        price, vega, dtheta, dkappa, dxi, rho = est
        return HestonGreeksResult(price=price, delta=zero, vega=vega,
                                  rho=rho, dtheta=dtheta, dkappa=dkappa,
                                  dxi=dxi)
    price, vega, rho, theta = est
    return GreeksResult(price=price, delta=zero, vega=vega, rho=rho,
                        theta=theta)


def _check_barrier_book(book: BarrierBook) -> None:
    book.validate()
    m = book.n_instruments
    if m > kbb.MAX_BARRIER_BOOK:
        raise ValueError(f"barrier book holds {m} instruments; max "
                         f"{kbb.MAX_BARRIER_BOOK} per fused walk "
                         "(split larger books)")


def barrier_book_setup(book: BarrierBook, n_paths: int,
                       config: EngineConfig):
    """``(plan, table)``: the launch :func:`price_barrier_book` makes."""
    _check_barrier_book(book)
    dev = config.torch_device()
    return _walk_plan(n_paths, config), kbb.book_params(book, dev)


def price_barrier_book(book: BarrierBook, n_paths: int, seed: int,
                       config: EngineConfig = EngineConfig()) -> McResult:
    """Price a book of 1 to 32 knock-out calls and puts, up- and
    down-and-out, from one walk sweep (K25): a vector :class:`McResult` of
    shape ``(M,)``, each instrument discounted by its own ``exp(-r_i
    t_i)``.  All instruments step on the same normals, so the draw is paid
    once for the book; a one-instrument book computes what
    :func:`price_barrier` computes, path by path."""
    plan, par = barrier_book_setup(book, n_paths, config)
    partials = kbb.partials(par, wrap_int32(seed), 0, plan, plan.num_blocks,
                            book.n_obs)
    total = _total(partials)
    return mcest.estimate(total[:, 0], total[:, 1], plan.total_units,
                          discount=_book_discount(book),
                          n_paths=plan.total_paths)


def greeks_barrier_book_setup(book: BarrierBook, n_paths: int,
                              config: EngineConfig):
    """``(plan, table)``: the launch :func:`greeks_barrier_book` makes (the
    barrier-book pricer's plan)."""
    _check_barrier_book(book)
    dev = config.torch_device()
    return _walk_plan(n_paths, config), kbb.greek_rows(book, dev)


def greeks_barrier_book(book: BarrierBook, n_paths: int, seed: int,
                        config: EngineConfig = EngineConfig()
                        ) -> GreeksResult:
    """The barrier book's risk run from one walk sweep (K26): price and
    likelihood-ratio delta, vega and rho of every instrument, each a vector
    :class:`McResult` of shape ``(M,)``, over :func:`price_barrier_book`'s
    paths.  Delta and vega are with respect to each instrument's own spot
    and vol; theta and gamma are ``None``, as in ``mctpu``."""
    plan, gp = greeks_barrier_book_setup(book, n_paths, config)
    partials = kbb.greek_partials(gp, wrap_int32(seed), 0, plan,
                                  plan.num_blocks, book.n_obs)
    price, delta, vega, rho = _estimates(
        _total(partials).T, plan.total_units, plan, _book_discount(book))
    return GreeksResult(price=price, delta=delta, vega=vega, rho=rho)


# ---------------------------------------------------------------------------
# Multi-asset walks: basket-Asian and basket-barrier
# ---------------------------------------------------------------------------

def _multi_walk_plan(bk: BasketOption, n_paths: int, config: EngineConfig):
    """The plan of a multi-asset walk: ``unit_per_row`` is ``128 * anti``
    asset-major, ``c * anti`` packed, as ``mctpu``'s pricers and Greeks
    lay them out."""
    anti = 2 if config.antithetic else 1
    a = bk.n_assets
    c = LANES if kbasket.use_asset_major(a) else kbasket.pack_factor(a)[1]
    blocks, rows = config.layout_for(n_paths, c * anti)
    return kmw.make_plan(n_paths, blocks, rows, config.antithetic,
                         config.precision.kahan, n_assets=a)


def _walk_setup(bk: BasketOption, n_obs: int, barrier, n_paths: int,
                config: EngineConfig):
    dev = config.torch_device()
    lt, par = kmw.walk_ops(bk, mcmath.cholesky_lower(bk.corr), n_obs)
    ops = tuple(x.contiguous().to(dev)
                for x in (lt, par, kmw.scalars(bk, barrier)))
    return _multi_walk_plan(bk, n_paths, config), ops


def basket_asian_setup(opt: BasketAsianOption, n_paths: int,
                       config: EngineConfig):
    """``(plan, (lt, par, scal))``: the launch :func:`price_basket_asian`
    makes.  The correlation is factorized in float64 on the host, then
    cast to float32."""
    return _walk_setup(opt.basket, opt.n_obs, None, n_paths, config)


def price_basket_asian(opt: BasketAsianOption, n_paths: int, seed: int,
                       config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of an arithmetic-average call on a correlated
    basket value over ``opt.n_obs`` dates (K30 up to 8 assets, K31
    beyond)."""
    opt.validate()
    plan, ops = basket_asian_setup(opt, n_paths, config)
    partials = kmw.partials(*ops, wrap_int32(seed), 0, plan,
                            plan.num_blocks, "asian", opt.n_obs)
    return _price(partials, plan, opt.basket.r, opt.basket.t)


def basket_barrier_setup(opt: BasketBarrierOption, n_paths: int,
                         config: EngineConfig):
    """``(plan, (lt, par, scal))``: the launch :func:`price_basket_barrier`
    makes."""
    return _walk_setup(opt.basket, opt.n_obs, opt.barrier, n_paths, config)


def price_basket_barrier(opt: BasketBarrierOption, n_paths: int, seed: int,
                         config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of a knock-out call on a correlated basket value,
    monitored at ``opt.n_obs`` dates (K30 up to 8 assets, K31 beyond)."""
    opt.validate()
    plan, ops = basket_barrier_setup(opt, n_paths, config)
    partials = kmw.partials(*ops, wrap_int32(seed), 0, plan,
                            plan.num_blocks, "barrier", opt.n_obs,
                            opt.kind == "up-and-out")
    return _price(partials, plan, opt.basket.r, opt.basket.t)


def _basket_vector_greeks(partials, vecs, plan, bk) -> GreeksResult:
    """Price, scalar rho and per-asset delta and vega vectors of ``((B,
    4), (B, 4, a))`` asset-major or ``((B, 4), (B, 4, width))`` packed
    partials, by ``mctpu``'s ``_vec_greeks_runner`` fold: float64 pairwise
    trees over the blocks, then :func:`_lane_rows` (the port's
    asset-major kernels write only the first ``a`` lanes)."""
    disc = _discount(bk.r, bk.t)
    n = plan.total_units
    price, rho = _estimates(_total(partials), n, plan, disc)
    delta, vega = _estimates(_lane_rows(_total(vecs), bk.n_assets), n, plan,
                             disc)
    return GreeksResult(price=price, delta=delta, vega=vega, rho=rho)


def _lane_rows(vtot: torch.Tensor, a: int) -> torch.Tensor:
    """The ``(4, a)`` per-asset rows of combined lane rows: asset-major
    ``(4, a)`` as they are, packed ``(4, width)`` folded over the ``c``
    path groups (``(4, c, a_tile)``) by a float64 pairwise tree, keeping
    the first ``a`` lanes (``mctpu``'s ``_vec_greeks_runner``)."""
    if kbasket.use_asset_major(a):
        return vtot
    a_tile, c, _ = kbasket.pack_factor(a)
    return pairwise_tree_sum(vtot.reshape(4, c, a_tile), 1)[:, :a]


def greeks_basket_asian_setup(opt: BasketAsianOption, n_paths: int,
                              config: EngineConfig):
    """``(plan, (scal, lt, par))``: the launch :func:`greeks_basket_asian`
    makes (the pricer's plan; K32's tables up to 8 assets, K33's
    beyond)."""
    dev = config.torch_device()
    bk = opt.basket
    build = (kmw.am_greek_ops if kbasket.use_asset_major(bk.n_assets)
             else kmw.packed_greek_ops)
    ops = build(bk, mcmath.cholesky_lower(bk.corr), opt.n_obs)
    return (_multi_walk_plan(bk, n_paths, config),
            tuple(x.contiguous().to(dev) for x in ops))


def greeks_basket_asian(opt: BasketAsianOption, n_paths: int, seed: int,
                        config: EngineConfig = EngineConfig()
                        ) -> GreeksResult:
    """Price, scalar pathwise rho and per-asset pathwise delta and vega
    vectors of the basket-Asian call in one sweep (K32 up to 8 assets, K33
    beyond), over :func:`price_basket_asian`'s paths.  Theta and gamma are
    ``None``, as in ``mctpu``."""
    opt.validate()
    plan, ops = greeks_basket_asian_setup(opt, n_paths, config)
    partials, vecs = kmw.am_greek_partials(*ops, wrap_int32(seed), 0, plan,
                                           plan.num_blocks, opt.n_obs)
    return _basket_vector_greeks(partials, vecs, plan, opt.basket)


def _check_full_rank(chol: torch.Tensor) -> None:
    """The likelihood-ratio scores shift z along ``L^-1`` directions: raise
    when the float64 factor ``chol`` is rank-deficient (``mctpu``'s
    check)."""
    if float(torch.diagonal(chol).min()) <= 1e-6:
        raise ValueError(
            "greeks_basket_barrier needs a full-rank correlation matrix "
            "(the likelihood-ratio scores shift z along L^-1 directions); "
            "this correlation is rank-deficient — use CRN bumps "
            "(mctpu_torch.autodiff.bump_and_revalue) instead")


def greeks_basket_barrier_setup(opt: BasketBarrierOption, n_paths: int,
                                config: EngineConfig):
    """``(plan, (scal, lt, linv, par))``: the launch
    :func:`greeks_basket_barrier` makes (the pricer's plan; K34's tables
    up to 8 assets, K35's beyond)."""
    bk = opt.basket
    chol = mcmath.cholesky_lower(bk.corr)
    _check_full_rank(chol)
    dev = config.torch_device()
    build = (kmw.am_bar_greek_ops if kbasket.use_asset_major(bk.n_assets)
             else kmw.packed_bar_greek_ops)
    ops = build(bk, chol, opt.n_obs, opt.barrier)
    return (_multi_walk_plan(bk, n_paths, config),
            tuple(x.contiguous().to(dev) for x in ops))


def greeks_basket_barrier(opt: BasketBarrierOption, n_paths: int, seed: int,
                          config: EngineConfig = EngineConfig()
                          ) -> GreeksResult:
    """Price, scalar rho and per-asset likelihood-ratio delta and vega
    vectors of the knock-out basket call in one sweep (K34 up to 8 assets,
    K35 beyond), over :func:`price_basket_barrier`'s paths.  A
    rank-deficient correlation raises ``ValueError``."""
    opt.validate()
    plan, ops = greeks_basket_barrier_setup(opt, n_paths, config)
    partials, vecs = kmw.bar_greek_partials(
        *ops, wrap_int32(seed), 0, plan, plan.num_blocks, opt.n_obs,
        opt.kind == "up-and-out")
    return _basket_vector_greeks(partials, vecs, plan, opt.basket)


# ---------------------------------------------------------------------------
# Rainbow: the call on the maximum or minimum of correlated assets
# ---------------------------------------------------------------------------

def rainbow_setup(opt: RainbowOption, n_paths: int, config: EngineConfig):
    """``(plan, operands)``: the launch :func:`price_rainbow` makes (the
    basket's plan, ``2 * c * anti`` units a row).  The correlation is
    factorized in float64 on the host, then cast to float32."""
    dev = config.torch_device()
    chol = mcmath.cholesky_lower(opt.corr)
    return (_basket_plan(opt, n_paths, config),
            krainbow.operands(opt, chol, dev))


def price_rainbow(opt: RainbowOption, n_paths: int, seed: int,
                  config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of a European call on the maximum or minimum of
    correlated assets (K36 up to 8 assets, K37 beyond).  Two-asset prices
    have the Stulz closed form (:func:`mctpu_torch.math.rainbow_max_call`,
    ``rainbow_min_call``)."""
    opt.validate()
    plan, ops = rainbow_setup(opt, n_paths, config)
    partials = krainbow.partials(ops, wrap_int32(seed), 0, plan,
                                 plan.num_blocks)
    return _price(partials, plan, opt.r, opt.t)


def greeks_rainbow_setup(opt: RainbowOption, n_paths: int,
                         config: EngineConfig):
    """``(plan, operands)``: the launch :func:`greeks_rainbow` makes (the
    pricer's plan).  More than 8 assets raise ``ValueError``, as in
    ``mctpu``."""
    a = opt.n_assets
    if not kbasket.use_asset_major(a):
        raise ValueError(
            f"greeks_rainbow runs the asset-major regime (n_assets <= "
            f"{kbasket.ASSET_MAJOR_MAX}, got {a}); use CRN bumps "
            "(mctpu_torch.autodiff.bump_and_revalue) for larger rainbows")
    dev = config.torch_device()
    chol = mcmath.cholesky_lower(opt.corr)
    return (_basket_plan(opt, n_paths, config),
            krainbow.greek_operands(opt, chol, dev))


def greeks_rainbow(opt: RainbowOption, n_paths: int, seed: int,
                   config: EngineConfig = EngineConfig()) -> GreeksResult:
    """Price, per-asset pathwise delta and vega vectors, and scalar rho and
    theta of the rainbow call in one sweep (K38), over
    :func:`price_rainbow`'s paths: the price equals the pricer's.  Gamma is
    ``None`` (no sign-definite Stein tilt crosses the arg-extreme
    boundary), as in ``mctpu``.  Up to 8 assets."""
    opt.validate()
    plan, ops = greeks_rainbow_setup(opt, n_paths, config)
    partials = krainbow.greek_partials(ops, wrap_int32(seed), 0, plan,
                                       plan.num_blocks)
    total = _total(partials)
    n = plan.total_units
    disc = _discount(opt.r, opt.t)
    price, rho, theta = _estimates(total[:6], n, plan, disc)
    vtot = total[6:].reshape(opt.n_assets, 4).T
    delta, vega = _estimates(vtot, n, plan, disc)
    return GreeksResult(price=price, delta=delta, vega=vega, rho=rho,
                        theta=theta)


# ---------------------------------------------------------------------------
# Netting-set CVA over correlated underlyings
# ---------------------------------------------------------------------------

def _cva_multi_plan(spec: CvaMultiSpec, n_paths: int, config: EngineConfig):
    """``mctpu``'s plan of the netting-set walks: ``128 * anti`` units a
    row asset-major, ``c * anti`` packed."""
    anti = 2 if config.antithetic else 1
    m = spec.n_underlyings
    c = LANES if kbasket.use_asset_major(m) else kbasket.pack_factor(m)[1]
    blocks, rows = config.layout_for(n_paths, c * anti)
    return kcm.make_plan(n_paths, blocks, rows, config.antithetic,
                         config.precision.kahan, n_underlyings=m)


def price_cva_multi_setup(spec: CvaMultiSpec, n_paths: int,
                          config: EngineConfig):
    """``(plan, operands)``: the launch :func:`price_cva_multi` makes.  The
    correlation is factorized in float64 on the host, then cast to
    float32."""
    dev = config.torch_device()
    chol = mcmath.cholesky_lower(spec.corr)
    return (_cva_multi_plan(spec, n_paths, config),
            kcm.operands(spec, chol, dev))


def price_cva_multi(spec: CvaMultiSpec, n_paths: int, seed: int,
                    config: EngineConfig = EngineConfig()) -> CvaResult:
    """CVA of a netting set of calls on ``M`` correlated underlyings (K40
    up to 8 underlyings, K39 beyond): the undiscounted mean of the per-path
    default legs, the per-node expected exposure and the default-leg
    masses, as ``mctpu.engine.price_cva_multi``.  All-long sets have the
    closed form :func:`mctpu_torch.math.cva_multi_closed_form`."""
    spec.validate()
    plan, ops = price_cva_multi_setup(spec, n_paths, config)
    partials, ee_sums = kcm.partials(ops, wrap_int32(seed), 0, plan,
                                     plan.num_blocks)
    sum_p, sum_p2 = mcest.combine_block_partials(partials)
    ee_profile = pairwise_tree_sum(ee_sums.to(mcmath.wide_dtype()), 0).cpu()
    res = mcest.estimate(sum_p, sum_p2, plan.total_units, discount=1.0,
                         n_paths=plan.total_paths)
    return CvaResult(
        cva=res.price, ci=res.ci, std_error=res.std_error,
        expected_exposure=ee_profile / plan.total_units,
        default_leg=mcmath.default_leg_weights(spec.intensity, spec.t,
                                               spec.n_grid),
        n=plan.total_units, n_paths=plan.total_paths)


def greeks_cva_multi_setup(spec: CvaMultiSpec, n_paths: int,
                           config: EngineConfig):
    """``(plan, operands)``: the launch :func:`greeks_cva_multi` makes: the
    pricer's plan and the Greek kernels' operands (K42's up to 8
    underlyings, K41's beyond: :func:`mctpu_torch.kernels.cva_multi.
    operands` with ``greeks=True``)."""
    dev = config.torch_device()
    chol = mcmath.cholesky_lower(spec.corr)
    return (_cva_multi_plan(spec, n_paths, config),
            kcm.operands(spec, chol, dev, greeks=True))


def greeks_cva_multi(spec: CvaMultiSpec, n_paths: int, seed: int,
                     config: EngineConfig = EngineConfig()
                     ) -> CvaGreeksResult:
    """CVA, credit delta dCVA/dlambda and per-underlying pathwise delta and
    vega vectors of a netting set in one sweep (K42 up to 8 underlyings,
    K41 beyond), over :func:`price_cva_multi`'s paths, each with the CVA's
    undiscounted-mean semantics.  Up to 8 underlyings the CVA equals the
    pricer's bit for bit; beyond, K41 prices each leg in K42's form, K39
    in ``log(s / k)``'s, so the two CVAs agree to float32 rounding.  The
    lane rows fold as :func:`_lane_rows` folds them; the delta rows then
    take ``1 / s0`` and ``1 / s0^2`` in float64, as ``mctpu``'s runner
    does; the second-order outputs are ``None``."""
    spec.validate()
    plan, ops = greeks_cva_multi_setup(spec, n_paths, config)
    partials, vecs = kcm.greek_partials(ops, wrap_int32(seed), 0, plan,
                                        plan.num_blocks)
    n = plan.total_units
    cva, credit_delta = _estimates(_total(partials), n, plan, 1.0)
    delta, vega = _estimates(_spot_scaled(_lane_rows(_total(vecs),
                                                     spec.n_underlyings),
                                          spec.s), n, plan, 1.0)
    return CvaGreeksResult(cva=cva, credit_delta=credit_delta, delta=delta,
                           vega=vega)


def _spot_scaled(vtot: torch.Tensor, s) -> torch.Tensor:
    """The ``(4, m)`` float64 lane rows with the delta rows over ``s0`` and
    ``s0^2`` (pathwise homogeneity: the kernels sum ``w S N(d1)``)."""
    s0 = torch.as_tensor(np.broadcast_to(np.asarray(s, np.float64),
                                         (vtot.shape[1],)).copy())
    vtot = vtot.clone()
    vtot[0] = vtot[0] / s0
    vtot[1] = vtot[1] / (s0 * s0)
    return vtot


# ---------------------------------------------------------------------------
# Bilateral xVA of a netting set (K43, K44)
# ---------------------------------------------------------------------------

def price_xva_setup(spec: XvaSpec, n_paths: int, config: EngineConfig):
    """``(plan, operands)``: the launch :func:`price_xva` makes: ``mctpu``'s
    plan (``rows * 128`` units a block iteration at every set size, the
    walk pricers') and K43's operands; the correlation is factorized in
    float64 on the host, then cast to float32."""
    dev = config.torch_device()
    chol = mcmath.cholesky_lower(spec.netting.corr)
    return _walk_plan(n_paths, config), kcm.xva_operands(spec, chol, dev)


def price_xva(spec: XvaSpec, n_paths: int, seed: int,
              config: EngineConfig = EngineConfig()) -> XvaResult:
    """Bilateral xVA of a netting set: CVA, DVA, FCA and FBA from one
    sweep, each an undiscounted mean (the CVA estimator's semantics, the
    funding legs forward-valued), and the EPE and ENE profiles (K43 up to
    8 underlyings, its runtime-m kernel beyond).  At ``own_intensity = 0``
    and ``funding_spread = 0`` the CVA leg and the EPE profile are
    :func:`price_cva_multi`'s bit for bit up to 8 underlyings.
    Single-signed sets have the closed form
    :func:`mctpu_torch.math.xva_multi_closed_form`."""
    spec.validate()
    plan, ops = price_xva_setup(spec, n_paths, config)
    partials, profs = kcm.xva_partials(ops, wrap_int32(seed), 0, plan,
                                       plan.num_blocks)
    n = plan.total_units
    cva, dva, fca, fba = _estimates(_total(partials), n, plan, 1.0)
    prof = _total(profs)
    return XvaResult(cva=cva, dva=dva, fca=fca, fba=fba,
                     epe_profile=prof[0] / n, ene_profile=prof[1] / n)


def greeks_xva_setup(spec: XvaSpec, n_paths: int, config: EngineConfig):
    """``(plan, operands)``: the launch :func:`greeks_xva` makes (the
    pricer's plan, K44's operands)."""
    dev = config.torch_device()
    chol = mcmath.cholesky_lower(spec.netting.corr)
    return (_walk_plan(n_paths, config),
            kcm.xva_operands(spec, chol, dev, greeks=True))


def greeks_xva(spec: XvaSpec, n_paths: int, seed: int,
               config: EngineConfig = EngineConfig()) -> XvaGreeksResult:
    """The four xVA legs, the per-leg sensitivities dCVA/dlambda_C,
    dDVA/dlambda_B and dFVA/dspread, and the per-underlying pathwise delta
    and vega vectors of the total XVA = CVA - DVA + FCA - FBA, from one
    sweep over :func:`price_xva`'s paths (K44 up to 8 underlyings, its
    runtime-m kernel beyond); the delta rows take ``1 / s0`` and ``1 /
    s0^2`` in float64 after the block combine, as ``mctpu``'s runner
    does."""
    spec.validate()
    plan, ops = greeks_xva_setup(spec, n_paths, config)
    partials, vecs = kcm.xva_greek_partials(ops, wrap_int32(seed), 0, plan,
                                            plan.num_blocks)
    n = plan.total_units
    legs = _estimates(_total(partials), n, plan, 1.0)
    delta, vega = _estimates(_spot_scaled(_total(vecs), spec.netting.s), n,
                             plan, 1.0)
    return XvaGreeksResult(*legs, delta=delta, vega=vega)


# ---------------------------------------------------------------------------
# American options: the frozen-rule forward pass (K50) and its pathwise
# Greeks (K51); the rule fit and the pricers are mctpu_torch.lsm.
# ---------------------------------------------------------------------------

def american_setup(opt: AmericanOption, beta, n_paths: int,
                   config: EngineConfig):
    """``(plan, operands)``: the launch of K50 (``lsm.price_american`` at
    ``config.antithetic``) and K51 under the rule ``beta``, the walk plan
    of ``mctpu``'s American engine tier."""
    dev = config.torch_device()
    return _walk_plan(n_paths, config), klsm.operands(opt, beta, dev)


def greeks_american_setup(opt: AmericanOption, n_paths: int, seed: int,
                          config: EngineConfig,
                          pilot_paths: int | None = None, fit_dtype=None):
    """``(plan, operands)``: the launch :func:`greeks_american` makes, the
    rule fitted as ``lsm.price_american`` fits it at ``seed``."""
    from mctpu_torch import lsm as mclsm  # lsm imports this module

    if pilot_paths is None:
        pilot_paths = min(n_paths, 1 << 15)
    beta = mclsm.fit_exercise_rule(
        opt.s, opt.k, opt.r, opt.v, opt.t, seed, pilot_paths, opt.n_steps,
        opt.payoff, dtype=fit_dtype or torch.float64,
        device=config.torch_device())
    return american_setup(opt, beta, n_paths, config)


def _greeks_american_run(opt: AmericanOption, plan, ops,
                         seed: int) -> GreeksResult:
    partials = klsm.greek_partials(ops, wrap_int32(seed), 0, plan,
                                   plan.num_blocks, opt.payoff == "put")
    # Cashflows and their derivatives are already present values.
    price, delta, vega, rho = _estimates(_total(partials), plan.total_units,
                                         plan, 1.0)
    return GreeksResult(price=price, delta=delta, vega=vega, rho=rho)


def greeks_american(opt: AmericanOption, n_paths: int, seed: int,
                    config: EngineConfig = EngineConfig(),
                    pilot_paths: int | None = None,
                    fit_dtype=None) -> GreeksResult:
    """Price and frozen-rule pathwise delta, vega and rho of an American
    put or call (K51).  Two passes as ``lsm.price_american``: the same
    pilot fit and pricing stream, so at the same seed, rule and plan its
    price sums equal K50's bit for bit (common random numbers with the
    pricer at ``antithetic=config.antithetic``).  The Greeks are the exact
    pathwise derivatives of the frozen-policy value (Piterbarg 2004); no
    theta, because the exercise grid moves with the maturity.  ``fit_dtype``
    is the pilot regression's (default float64)."""
    opt.validate()
    plan, ops = greeks_american_setup(opt, n_paths, seed, config,
                                      pilot_paths, fit_dtype)
    return _greeks_american_run(opt, plan, ops, seed)


def greeks(opt, n_paths: int, seed: int,
           config: EngineConfig = EngineConfig()):
    """In-kernel Greeks, dispatched on the product record."""
    if isinstance(opt, AmericanOption):
        return greeks_american(opt, n_paths, seed, config)
    if isinstance(opt, VanillaOption):
        return greeks_vanilla(opt, n_paths, seed, config)
    if isinstance(opt, BasketOption):
        return greeks_basket(opt, n_paths, seed, config)
    if isinstance(opt, (CvaSpec, CvaPortfolioSpec)):
        return greeks_cva(opt, n_paths, seed, config)
    if isinstance(opt, CvaMultiSpec):
        return greeks_cva_multi(opt, n_paths, seed, config)
    if isinstance(opt, AsianOption):
        return greeks_asian(opt, n_paths, seed, config)
    if isinstance(opt, BarrierOption):
        return greeks_barrier(opt, n_paths, seed, config)
    if isinstance(opt, LookbackOption):
        return greeks_lookback(opt, n_paths, seed, config)
    if isinstance(opt, CliquetOption):
        return greeks_cliquet(opt, n_paths, seed, config)
    if isinstance(opt, HestonOption):
        return greeks_heston(opt, n_paths, seed, config)
    if isinstance(opt, BasketAsianOption):
        return greeks_basket_asian(opt, n_paths, seed, config)
    if isinstance(opt, BasketBarrierOption):
        return greeks_basket_barrier(opt, n_paths, seed, config)
    if isinstance(opt, RainbowOption):
        return greeks_rainbow(opt, n_paths, seed, config)
    raise TypeError(f"no in-kernel Greeks for {type(opt).__name__}")
