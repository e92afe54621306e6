"""The Greeks entry points of the port against mctpu.engine (CPU).

``mctpu_torch.greeks_*`` on ``device="cpu"`` (the plain versions of K5-K8)
against ``mctpu.engine.greeks_*`` on interpret-mode Pallas with the same
plan and key.  Both take the same per-block partials through the same f64
combine, so every output's global ``(sum x, sum x^2)`` agrees by the scaled
bound of ``tests/torch_tolerance.py`` at ``rtol=1e-5`` (``n`` the total
units), and the path counts are equal.  The Greek kernels draw their
pricers' paths, so each Greeks price equals ``price_*`` at the same seed.
"""
import jax
import numpy as np
import pytest

import mctpu_torch
from mctpu import engine as jengine
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu_torch import engine as tengine
from mctpu_torch.types import CvaGreeksResult, GreeksResult, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 1e-5
KEY = jax.random.key(41)
SEED = int(jrng.key_to_seed(KEY))
JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=4,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu")
VANILLA_FIELDS = ("price", "delta", "vega", "rho", "theta", "gamma",
                  "vanna", "volga")
CVA_FIELDS = ("cva", "credit_delta", "delta", "vega", "gamma",
              "credit_gamma", "cross_gamma")


def _same_estimate(got, want):
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    pairs = lambda r: np.stack([np.atleast_1d(np.asarray(r.sum_p)),  # noqa
                                np.atleast_1d(np.asarray(r.sum_p2))], 1)
    assert_pairs_close(pairs(got), pairs(want), want.n, RTOL)


def _cva_spec(n_grid=6, wwr_b=0.0):
    spec = jtypes.CvaSpec(intensity=0.03, lgd=0.6,
                          option=jtypes.VanillaOption(100.0, 100.0, 0.05,
                                                      0.2, 1.0),
                          n_grid=n_grid)
    return jtypes.CvaPortfolioSpec.from_single(spec, wwr_b=wwr_b)


@pytest.mark.parametrize("kind", ["call", "put"])
def test_greeks_vanilla_matches_mctpu(kind):
    opt = jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
    want = jengine.greeks_vanilla(opt, 1 << 14, KEY, JCFG)
    got = mctpu_torch.greeks_vanilla(from_reference(opt), 1 << 14, SEED,
                                     TCFG)
    for f in VANILLA_FIELDS:
        _same_estimate(getattr(got, f), getattr(want, f))
    price = mctpu_torch.price_vanilla(from_reference(opt), 1 << 14, SEED,
                                      TCFG)
    assert float(got.price.price) == float(price.price)


@pytest.mark.parametrize("name", ["equicorrelated_3", "default_reference_3",
                                  "default_reference_10"])
def test_greeks_basket_matches_mctpu(name):
    kind, a = name.rsplit("_", 1)
    opt = getattr(jtypes.BasketOption, kind)(int(a))
    want = jengine.greeks_basket(opt, 1 << 13, KEY, JCFG)
    got = mctpu_torch.greeks_basket(from_reference(opt), 1 << 13, SEED, TCFG)
    assert (got.gamma is None) == (want.gamma is None)
    assert (got.gamma is None) == (kind == "default_reference")
    for f in ("price", "delta", "vega", "rho", "theta", "gamma"):
        if getattr(want, f) is not None:
            _same_estimate(getattr(got, f), getattr(want, f))
    assert got.delta.price.shape == (int(a),)
    price = mctpu_torch.price_basket(from_reference(opt), 1 << 13, SEED, TCFG)
    np.testing.assert_allclose(float(got.price.price), float(price.price),
                               rtol=1e-6)


@pytest.mark.parametrize("wwr_b", [0.0, 0.5])
def test_greeks_cva_matches_mctpu(wwr_b):
    port = _cva_spec(wwr_b=wwr_b)
    want = jengine.greeks_cva(port, 1 << 12, KEY, JCFG)
    got = mctpu_torch.greeks_cva(from_reference(port), 1 << 12, SEED, TCFG)
    for f in CVA_FIELDS:
        if wwr_b:  # the hazard's series switch can flip on one ulp
            r, w = getattr(got, f), getattr(want, f)
            assert (r.n, r.n_paths) == (w.n, w.n_paths)
            pairs = lambda x: np.array([[float(x.sum_p),  # noqa: E731
                                         float(x.sum_p2)]])
            assert_pairs_close(pairs(r), pairs(w), w.n, 1e-4)
        else:
            _same_estimate(getattr(got, f), getattr(want, f))
    price = mctpu_torch.price_cva_portfolio(from_reference(port), 1 << 12,
                                            SEED, TCFG)
    # The Greeks walk adds the drift to the log-spot apart from the
    # diffusion (mctpu's order): a constant add rounds alike on every path,
    # up to half an ulp of log s (2.4e-7) per step, times a CVA elasticity
    # to the spot below 6.
    np.testing.assert_allclose(float(got.cva.price), float(price.cva),
                               rtol=6 * 2.4e-7 * port.n_grid)


def test_greeks_dispatcher_routes_records():
    van = mctpu_torch.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
    r = mctpu_torch.greeks(van, 1 << 12, SEED, TCFG)
    assert isinstance(r, GreeksResult) and r.vanna is not None
    bas = mctpu_torch.BasketOption.equicorrelated(2)
    assert mctpu_torch.greeks(bas, 1 << 12, SEED, TCFG).gamma is not None
    spec = from_reference(jtypes.CvaSpec(0.03, 0.6, jtypes.VanillaOption(
        100.0, 100.0, 0.05, 0.2, 1.0), n_grid=3))
    a = mctpu_torch.greeks(spec, 1 << 10, SEED, TCFG)
    b = mctpu_torch.greeks(mctpu_torch.CvaPortfolioSpec.from_single(spec),
                           1 << 10, SEED, TCFG)
    assert isinstance(a, CvaGreeksResult)
    assert float(a.cva.price) == float(b.cva.price)
    with pytest.raises(TypeError):
        mctpu_torch.greeks(object(), 1 << 10, SEED, TCFG)


def test_greeks_cva_f32_ds_runs_the_f32_walk():
    port = from_reference(_cva_spec(n_grid=3))
    ds = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu",
                              precision=mctpu_torch.Precision.F32_DS)
    a = mctpu_torch.greeks_cva(port, 1 << 10, SEED, ds)
    b = mctpu_torch.greeks_cva(port, 1 << 10, SEED, TCFG)
    assert float(a.cva.price) == float(b.cva.price)
