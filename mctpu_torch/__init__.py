"""mctpu_torch — the PyTorch/CUDA port of mctpu for NVIDIA Hopper (H100).

The main path of the JAX package, its single-asset walks and its serving
sweeps, on one GPU: vanilla, basket, CVA, Asian, knock-out barrier,
lookback and cliquet pricing, Heston pricing (Euler and QE), the variance
swap's fair strike (GBM and Heston), strike ladders, vanilla books,
barrier books, basket-Asian and basket-barrier calls, rainbow calls on
the maximum or minimum of correlated assets, the netting-set CVA and the
bilateral xVA (CVA, DVA, FCA, FBA) over correlated underlyings, their
in-kernel Greeks, control-variate pricing of calls, arithmetic Asian
calls and baskets and importance-sampled calls
(:mod:`mctpu_torch.variance`), and American puts and calls by two-pass
Longstaff-Schwartz with their frozen-rule Greeks (:mod:`mctpu_torch.lsm`,
:func:`greeks_american`), and multilevel Monte Carlo for the Heston Euler
walk and the continuously monitored Asian and knock-out calls
(:mod:`mctpu_torch.mlmc`), and randomized QMC on digitally shifted Sobol
nets (:mod:`mctpu_torch.qmc_engine`: the vanilla price and Greeks, the
basket, the Brownian-bridge Asian), through hand-written
CUDA kernels (``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use),
per-block partial sums, a fixed-order float64 combine and the reference
estimator.  :mod:`mctpu_torch.autodiff` adds the autodiff and
bump-and-revalue tier.  Each kernel has a plain PyTorch version beside
it, which runs for CPU tensors.  Imports neither jax nor mctpu.
"""
from mctpu_torch import math
from mctpu_torch.engine import (EngineConfig, fair_variance_strike, greeks,
                                greeks_asian, greeks_barrier,
                                greeks_barrier_book, greeks_basket,
                                greeks_american, greeks_basket_asian,
                                greeks_basket_barrier,
                                greeks_book, greeks_cliquet, greeks_cva,
                                greeks_cva_multi, greeks_heston,
                                greeks_lookback, greeks_rainbow,
                                greeks_vanilla,
                                greeks_vanilla_ladder,
                                greeks_varswap, greeks_xva, price_asian,
                                price_barrier,
                                price_barrier_book, price_basket,
                                price_basket_asian, price_basket_barrier,
                                price_book, price_cliquet, price_cva,
                                price_cva_multi, price_cva_portfolio,
                                price_heston, price_lookback, price_rainbow,
                                price_vanilla, price_vanilla_ladder,
                                price_xva)
from mctpu_torch import lsm, mlmc, variance  # noqa: F401  (after engine)
from mctpu_torch import qmc, qmc_engine, sobol  # noqa: F401
from mctpu_torch.qmc_engine import (price_asian_rqmc, price_basket_rqmc,
                                    price_vanilla_rqmc)
from mctpu_torch.lsm import (price_american, price_american_bounds,
                             price_american_heston)
from mctpu_torch.rng import seed_from_generator
from mctpu_torch.types import (AmericanBounds, AmericanOption, AsianOption,
                               BarrierBook, BarrierOption,
                               BasketAsianOption, BasketBarrierOption,
                               BasketOption, CliquetOption, CvaGreeksResult,
                               CvaMultiSpec, CvaPortfolioSpec, CvaResult,
                               CvaSpec,
                               GreeksResult, HestonGreeksResult,
                               HestonOption, LookbackOption, McResult,
                               MlmcLevel, MlmcResult, Precision,
                               RainbowOption, VanillaBook, VanillaOption,
                               XvaGreeksResult, XvaResult, XvaSpec,
                               from_reference)

__all__ = [
    "EngineConfig",
    "price_vanilla",
    "price_basket",
    "price_cva",
    "price_cva_portfolio",
    "price_cva_multi",
    "price_asian",
    "price_barrier",
    "price_lookback",
    "price_cliquet",
    "price_vanilla_ladder",
    "price_book",
    "price_barrier_book",
    "price_heston",
    "price_basket_asian",
    "price_basket_barrier",
    "price_rainbow",
    "price_xva",
    "price_american",
    "price_american_bounds",
    "price_american_heston",
    "price_vanilla_rqmc",
    "price_basket_rqmc",
    "price_asian_rqmc",
    "fair_variance_strike",
    "greeks",
    "greeks_vanilla",
    "greeks_basket",
    "greeks_cva",
    "greeks_cva_multi",
    "greeks_asian",
    "greeks_barrier",
    "greeks_lookback",
    "greeks_cliquet",
    "greeks_vanilla_ladder",
    "greeks_book",
    "greeks_barrier_book",
    "greeks_varswap",
    "greeks_heston",
    "greeks_basket_asian",
    "greeks_basket_barrier",
    "greeks_rainbow",
    "greeks_xva",
    "greeks_american",
    "seed_from_generator",
    "Precision",
    "VanillaOption",
    "VanillaBook",
    "BasketOption",
    "BasketAsianOption",
    "BasketBarrierOption",
    "RainbowOption",
    "CvaSpec",
    "CvaPortfolioSpec",
    "CvaMultiSpec",
    "XvaSpec",
    "AsianOption",
    "BarrierOption",
    "BarrierBook",
    "LookbackOption",
    "CliquetOption",
    "HestonOption",
    "AmericanOption",
    "AmericanBounds",
    "McResult",
    "CvaResult",
    "GreeksResult",
    "HestonGreeksResult",
    "CvaGreeksResult",
    "XvaResult",
    "XvaGreeksResult",
    "MlmcLevel",
    "MlmcResult",
    "from_reference",
    "math",
    "lsm",
    "mlmc",
    "variance",
    "qmc",
    "qmc_engine",
    "sobol",
]
