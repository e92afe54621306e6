"""The Monte Carlo engine of the port: pricing drivers on one device.

Counterpart of the main path of :mod:`mctpu.engine`:

    kernel (per-block partials, on the device)
      -> fixed-order float64 pairwise combine across blocks
        -> estimator (price, standard error, 95% CI) in float64

:func:`price_vanilla`, :func:`price_basket`, :func:`price_cva` and
:func:`price_cva_portfolio` take an int32 ``seed`` word (the value
``mctpu.rng.key_to_seed`` gives a JAX key; see
:func:`mctpu_torch.rng.seed_from_generator`) and draw the same streams as the
JAX package's kernels in interpret mode, so a run here matches that run
block by block.  PyTorch runs eagerly: there is no jit cache.
"""
from __future__ import annotations

import dataclasses

import torch

from mctpu_torch import estimator as mcest
from mctpu_torch import math as mcmath
from mctpu_torch.kernels import basket as kbasket
from mctpu_torch.kernels import cva as kcva
from mctpu_torch.kernels import vanilla as kvanilla
from mctpu_torch.kernels.common import LANES
from mctpu_torch.parallel.reduce import pairwise_tree_sum
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import (BasketOption, CvaPortfolioSpec, CvaResult,
                               CvaSpec, McResult, Precision, VanillaOption)

__all__ = ["EngineConfig", "price_vanilla", "price_basket", "price_cva",
           "price_cva_portfolio", "vanilla_setup", "basket_setup",
           "cva_setup"]


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


def vanilla_setup(opt: VanillaOption, n_paths: int, config: EngineConfig):
    """``(plan, params)``: the launch :func:`price_vanilla` makes."""
    dev = config.torch_device()
    anti = 2 if config.antithetic else 1
    blocks, rows = config.layout_for(n_paths, 2 * LANES * anti)
    plan = kvanilla.make_plan(n_paths, blocks, rows, config.antithetic,
                              config.precision.kahan)
    return plan, kvanilla.params(opt, dev)


def price_vanilla(opt: VanillaOption, n_paths: int, seed: int,
                  config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of a European call or put (K1)."""
    opt.validate()
    plan, par = vanilla_setup(opt, n_paths, config)
    partials = kvanilla.partials(par, wrap_int32(seed), 0, plan,
                                 plan.num_blocks, opt.kind == "put")
    sum_p, sum_p2 = mcest.combine_block_partials(partials)
    return mcest.estimate(sum_p, sum_p2, plan.total_units,
                          discount=_discount(opt.r, opt.t),
                          n_paths=plan.total_paths)


def basket_setup(opt: BasketOption, n_paths: int, config: EngineConfig):
    """``(plan, operands)``: the launch :func:`price_basket` makes.  The
    correlation matrix is factorized in float64 on the host, then cast to
    float32 for the kernel."""
    dev = config.torch_device()
    anti = 2 if config.antithetic else 1
    a = opt.n_assets
    c = LANES if kbasket.use_asset_major(a) else kbasket.pack_factor(a)[1]
    blocks, rows = config.layout_for(n_paths, 2 * c * anti)
    plan = kbasket.make_plan(n_paths, blocks, rows, config.antithetic,
                             config.precision.kahan, n_assets=a)
    chol = mcmath.cholesky_lower(opt.corr)
    return plan, kbasket.operands(opt, chol, dev)


def price_basket(opt: BasketOption, n_paths: int, seed: int,
                 config: EngineConfig = EngineConfig()) -> McResult:
    """Monte Carlo price of a weighted basket call (K2 up to 8 assets, K3
    beyond)."""
    opt.validate()
    plan, ops = basket_setup(opt, n_paths, config)
    partials = kbasket.partials(ops, wrap_int32(seed), 0, plan,
                                plan.num_blocks)
    sum_p, sum_p2 = mcest.combine_block_partials(partials)
    return mcest.estimate(sum_p, sum_p2, plan.total_units,
                          discount=_discount(opt.r, opt.t),
                          n_paths=plan.total_paths)


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
    anti = 2 if config.antithetic else 1
    blocks, rows = config.layout_for(n_paths, LANES * anti)
    plan = kcva.make_plan(n_paths, blocks, rows, config.antithetic,
                          config.precision.kahan, ds=config.precision.ds)
    return plan, kcva.operands(port, dev)


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
