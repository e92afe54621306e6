"""mctpu_torch — the PyTorch/CUDA port of mctpu for NVIDIA Hopper (H100).

The main path of the JAX package, its single-asset walks and its serving
sweeps, on one GPU: vanilla, basket, CVA, Asian, knock-out barrier,
lookback and cliquet pricing, Heston pricing (Euler and QE), the variance
swap's fair strike (GBM and Heston), strike ladders, vanilla books,
barrier books, basket-Asian and basket-barrier calls, rainbow calls on
the maximum or minimum of correlated assets and the netting-set CVA over
correlated underlyings, and their in-kernel
Greeks through hand-written CUDA kernels (``csrc/``, built with ``nvcc``
for ``sm_90a`` at first use), per-block partial sums, a
fixed-order float64 combine and the reference estimator.
:mod:`mctpu_torch.autodiff` adds the autodiff and bump-and-revalue tier.
Each kernel has a plain PyTorch version beside it, which runs for CPU
tensors.  Imports neither jax nor mctpu.
"""
from mctpu_torch import math
from mctpu_torch.engine import (EngineConfig, fair_variance_strike, greeks,
                                greeks_asian, greeks_barrier,
                                greeks_barrier_book, greeks_basket,
                                greeks_basket_asian, greeks_basket_barrier,
                                greeks_book, greeks_cliquet, greeks_cva,
                                greeks_cva_multi, greeks_heston,
                                greeks_lookback, greeks_rainbow,
                                greeks_vanilla,
                                greeks_vanilla_ladder,
                                greeks_varswap, price_asian, price_barrier,
                                price_barrier_book, price_basket,
                                price_basket_asian, price_basket_barrier,
                                price_book, price_cliquet, price_cva,
                                price_cva_multi, price_cva_portfolio,
                                price_heston, price_lookback, price_rainbow,
                                price_vanilla, price_vanilla_ladder)
from mctpu_torch.rng import seed_from_generator
from mctpu_torch.types import (AsianOption, BarrierBook, BarrierOption,
                               BasketAsianOption, BasketBarrierOption,
                               BasketOption, CliquetOption, CvaGreeksResult,
                               CvaMultiSpec, CvaPortfolioSpec, CvaResult,
                               CvaSpec,
                               GreeksResult, HestonGreeksResult,
                               HestonOption, LookbackOption, McResult,
                               Precision, RainbowOption, VanillaBook,
                               VanillaOption, from_reference)

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
    "AsianOption",
    "BarrierOption",
    "BarrierBook",
    "LookbackOption",
    "CliquetOption",
    "HestonOption",
    "McResult",
    "CvaResult",
    "GreeksResult",
    "HestonGreeksResult",
    "CvaGreeksResult",
    "from_reference",
    "math",
]
