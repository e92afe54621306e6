"""The port's autodiff and bump-and-revalue Greeks (``mctpu_torch.autodiff``)
and the engine Greeks against closed forms (CPU).

The port's ``torch.Generator`` is not JAX's Threefry, so these gates are
statistical, as ``tests/test_greeks.py`` holds ``mctpu.greeks``: the
autodiff estimates within fixed relative tolerances of Black-Scholes, the
engine's Greeks within 4 standard errors.  ``basket_delta`` is the autodiff
oracle for ``greeks_basket``'s delta.
"""
import numpy as np
import pytest
import torch

import mctpu_torch
from mctpu_torch import autodiff
from mctpu_torch import engine as tengine
from mctpu_torch.math import bs_greeks

OPT = mctpu_torch.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
CF = {k: float(v) for k, v in bs_greeks(100.0, 100.0, 0.048790, 0.2,
                                        1.0).items()}
CFG = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")


def _gen(seed=31):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name,rtol", [
    ("price", 0.005), ("delta", 0.01), ("vega", 0.02), ("theta", 0.02),
    ("rho", 0.01),
])
def test_vanilla_autodiff_matches_closed_form(name, rtol):
    mc = autodiff.vanilla_greeks(OPT, 1 << 20, _gen())
    assert float(mc[name]) == pytest.approx(CF[name], rel=rtol)


def test_vanilla_autodiff_rejects_puts():
    with pytest.raises(ValueError):
        autodiff.vanilla_greeks(mctpu_torch.VanillaOption(
            100.0, 100.0, 0.05, 0.2, 1.0, kind="put"), 1 << 10, _gen())


def test_single_asset_basket_delta_equals_vanilla_delta():
    one = mctpu_torch.BasketOption(s=[100.0], v=[0.2], w=[1.0], corr=[[1.0]],
                                   d=[0.0], k=100.0, r=0.048790, t=1.0)
    _, delta = autodiff.basket_delta(one, 1 << 19, _gen(2))
    assert float(delta[0]) == pytest.approx(CF["delta"], rel=0.02)


@pytest.mark.parametrize("order,want", [(1, 6.0), (2, 6.0)])
def test_bump_and_revalue_is_exact_on_a_quadratic(order, want):
    f = lambda x: 3.0 * x * x + 2.0 * x  # noqa: E731
    x0 = 2.0 / 3.0  # f' = 6x + 2 = 6, f'' = 6
    got = autodiff.bump_and_revalue(f, x0, 0.25, order=order)
    assert got == pytest.approx(want, rel=1e-12)


def test_crn_delta_matches_engine_delta():
    def price(s):
        o = mctpu_torch.VanillaOption(s, 100.0, 0.048790, 0.2, 1.0)
        return float(mctpu_torch.price_vanilla(o, 1 << 17, 7, CFG).price)

    fd = autodiff.bump_and_revalue(price, 100.0, 0.5, order=1)
    pw = float(mctpu_torch.greeks_vanilla(OPT, 1 << 17, 7, CFG).delta.price)
    assert fd == pytest.approx(pw, abs=2e-3)


def test_engine_vanilla_greeks_within_4_sigma_of_bs():
    res = mctpu_torch.greeks_vanilla(OPT, 1 << 18, 123, CFG)
    for name in ("price", "delta", "vega", "rho", "theta", "gamma", "vanna",
                 "volga"):
        r = getattr(res, name)
        z = (float(r.price) - CF[name]) / float(r.std_error)
        assert abs(z) < 4.0, (name, float(r.price), CF[name], z)


def test_engine_basket_delta_matches_autodiff_oracle():
    opt = mctpu_torch.BasketOption.default_reference(3)
    res = mctpu_torch.greeks_basket(opt, 1 << 17, 5, CFG)
    _, d_ad = autodiff.basket_delta(opt, 1 << 17, _gen(5))
    np.testing.assert_allclose(res.delta.price.numpy(), d_ad.numpy(),
                               atol=0.01)
    assert (res.delta.std_error > 0).all()
