"""The port's control-variate pricers (CPU): the two-stage estimator against
``mctpu.variance`` on interpret-mode Pallas, the public entry points'
statistics, and the pilot seed.

``_run_cv`` is handed the seed pair ``mctpu`` draws from (``key_to_seed``
of the key and of ``fold_in(key, 0x9E37)``), so both packages run the same
pilot and main streams.  Their kernels' moment sums agree to float32
rounding (``tests/test_torch_varred.py``); the pilot's regression and the
main run's center follow from them, so ``n`` and ``n_paths`` must be equal,
the price within ``rtol=1e-6`` (it is nearly shift-invariant, and its
sums agree to 1e-7), and ``std_error`` within ``rtol=2e-5``: it is the root
of the residual variance, a combination of the main run's quadratic sums
(each held at 2e-5 per block) with the pilot's slope (about 2e-6 is
observed).  The statistical gates are ``tests/test_variance.py``'s,
``tests/test_asian.py``'s and ``tests/test_varred_engine.py``'s.
"""
import dataclasses

import jax
import numpy as np
import pytest

import mctpu_torch
from mctpu import engine as jengine
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu import variance as jvariance
from mctpu_torch import math as tmath
from mctpu_torch import variance as tvariance
from mctpu_torch.types import (AsianOption, BasketOption, VanillaOption,
                               from_reference)

KEY = jax.random.key(17)
SEEDS = (int(jrng.key_to_seed(KEY)),
         int(jrng.key_to_seed(jax.random.fold_in(KEY, tvariance.PILOT_WORD))))
JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=4,
                            rows=8)
TCFG = mctpu_torch.EngineConfig(num_blocks=4, rows=8, device="cpu")
CPU = mctpu_torch.EngineConfig(device="cpu")

_VAN = jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
CASES = {
    # name: (mctpu pricer, option, n_paths, antithetic)
    "vanilla": (jvariance.price_vanilla_cv, _VAN, 1 << 14, False),
    "vanilla-antithetic": (jvariance.price_vanilla_cv, _VAN, 1 << 14, True),
    "asian-n8": (jvariance.price_asian_cv,
                 jtypes.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=8),
                 1 << 13, False),
    "basket-3": (jvariance.price_basket_cv,
                 jtypes.BasketOption.equicorrelated(3, 0.3), 1 << 14, False),
    "basket-10": (jvariance.price_basket_cv,
                  jtypes.BasketOption.equicorrelated(10, 0.3), 1 << 12,
                  False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_cv_matches_mctpu(case):
    price_fn, opt, n, antithetic = CASES[case]
    want = price_fn(opt, n, KEY,
                    dataclasses.replace(JCFG, antithetic=antithetic))
    got = tvariance._run_cv(from_reference(opt), n, SEEDS,
                            dataclasses.replace(TCFG, antithetic=antithetic),
                            0.1)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    np.testing.assert_allclose(float(got.price), float(want.price), rtol=1e-6)
    np.testing.assert_allclose(float(got.std_error), float(want.std_error),
                               rtol=2e-5)
    np.testing.assert_allclose(float(got.ci), 1.96 * float(got.std_error),
                               rtol=1e-12)


BS = float(tmath.bs_call(100.0, 100.0, 0.048790, 0.2, 1.0))
VAN = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)


def test_vanilla_cv_unbiased_and_tighter():
    cv = tvariance.price_vanilla_cv(VAN, 1 << 18, 55, CPU)
    assert abs(float(cv.price) - BS) < 4 * float(cv.std_error)
    mc = mctpu_torch.price_vanilla(VAN, 1 << 18, 56, CPU)
    assert float(cv.std_error) < float(mc.std_error) / 1.8
    anti = tvariance.price_vanilla_cv(
        VAN, 1 << 16, 57, dataclasses.replace(CPU, antithetic=True))
    assert abs(float(anti.price) - BS) < 5 * float(anti.std_error)


def test_deep_itm_control_is_near_perfect():
    """At k=20 every path pays ``S_T - k``, and in float32 ``d = (S_T - k -
    p0) - (S_T - m)`` is the same number on every path (each difference is
    exact), so ``std_error`` may be exactly 0 and the price is off Black-
    Scholes only by the float32 rounding of the centers (half an ulp of
    ``m = s0 e^{rT}``, 3.8e-6, discounted)."""
    deep = VanillaOption(100.0, 20.0, 0.048790, 0.2, 1.0)
    cv = tvariance.price_vanilla_cv(deep, 1 << 16, 55, CPU)
    mc = mctpu_torch.price_vanilla(deep, 1 << 16, 59, CPU)
    assert float(cv.std_error) < float(mc.std_error) / 100
    bs = float(tmath.bs_call(100.0, 20.0, 0.048790, 0.2, 1.0))
    assert abs(float(cv.price) - bs) < 4 * float(cv.std_error) + 4e-6


def test_asian_cv_unbiased_and_much_tighter():
    ari = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=12)
    cv = tvariance.price_asian_cv(ari, 1 << 15, 808, CPU)
    mc = mctpu_torch.price_asian(ari, 1 << 15, 809, CPU)
    assert float(cv.std_error) < float(mc.std_error) / 8
    se = np.hypot(float(cv.std_error), float(mc.std_error))
    assert abs(float(cv.price) - float(mc.price)) < 4 * se


@pytest.mark.parametrize("label", ["equicorrelated-5", "equicorrelated-12",
                                   "reference-3-d0.3"])
def test_basket_cv_unbiased_and_tighter(label):
    """Asset-major (5) and packed (12) baskets against plain MC on another
    seed, and a Brownian offset d = 0.3 on every asset (the control mean's
    e^{v sqrt(T) d} factor)."""
    if label == "reference-3-d0.3":
        opt = dataclasses.replace(BasketOption.default_reference(3),
                                  d=np.full(3, 0.3))
    else:
        opt = BasketOption.equicorrelated(int(label.split("-")[1]), rho=0.3)
    cv = tvariance.price_basket_cv(opt, 1 << 16, 55, CPU)
    mc = mctpu_torch.price_basket(opt, 1 << 16, 58, CPU)
    assert float(cv.std_error) < float(mc.std_error) / 1.8
    se = np.hypot(float(cv.std_error), float(mc.std_error))
    assert abs(float(cv.price) - float(mc.price)) < 4 * se


def test_pilot_seed_differs_from_seed():
    rng = np.random.default_rng(0)
    seeds = [0, 1, -1, 2**31 - 1, -2**31, SEEDS[0]] + [
        int(s) for s in rng.integers(-2**31, 2**31, 200)]
    for s in seeds:
        p = tvariance.pilot_seed(s)
        assert p != s and -2**31 <= p < 2**31
        assert p == tvariance.pilot_seed(s)  # a pure function of the seed
    assert len({tvariance.pilot_seed(s) for s in seeds}) == len(set(seeds))


def test_public_cv_prices_draw_the_pilot_from_the_derived_seed():
    """The public entry point is ``_run_cv`` on ``(seed,
    pilot_seed(seed))``, bit for bit."""
    opt = VanillaOption(100.0, 95.0, 0.048790, 0.2, 1.0)
    got = tvariance.price_vanilla_cv(opt, 1 << 14, 7, TCFG)
    want = tvariance._run_cv(opt, 1 << 14, (7, tvariance.pilot_seed(7)),
                             TCFG, 0.1)
    assert float(got.price) == float(want.price)
    assert float(got.std_error) == float(want.std_error)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
