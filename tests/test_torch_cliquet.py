"""The cliquet path of the port against mctpu (CPU): K17's and K18's plain
versions against the JAX kernels in interpret mode, the engine entry points
against ``mctpu.engine`` on interpret-mode Pallas, the exact closed form and
its gradients, and the records.

Both packages draw the same Philox stream.  K17's ``(B, 2)`` partials agree
at ``rtol=2e-5`` (other summation orders, libm ``exp`` within an ulp);
K18's ``(B, 8)`` ``(sum x, sum x^2)`` pairs by the scaled bound of
``tests/torch_tolerance.py`` at ``rtol=2e-5``: the vega and theta integrands
change sign from period to period, so their block sums can nearly cancel.
Each case runs 2 blocks of ``rows=8`` for one or two iterations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mctpu_torch
from mctpu import engine as jengine
from mctpu import math as jmath
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import cliquet as jcliquet
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import cliquet as tcliquet
from mctpu_torch.types import GreeksResult, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(41)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8

CASES = {
    # name: (n_periods, cap, floor, antithetic, kahan, iters)
    "n1": (1, 0.10, -0.10, False, True, 1),
    "n12_2iters": (12, 0.05, -0.02, False, True, 2),
    "n7_antithetic": (7, 0.03, 0.0, True, True, 1),
    "n7_antithetic_f32": (7, 0.05, -0.02, True, False, 1),
}


def _case(case):
    n, cap, floor, antithetic, kahan, iters = CASES[case]
    opt = jtypes.CliquetOption(100.0, 0.03, 0.2, 1.0, n_periods=n, cap=cap,
                               floor=floor)
    paths = NB * iters * ROWS * 128 * (2 if antithetic else 1)
    jplan = jcliquet.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tcliquet.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    return opt, jplan, tplan, from_reference(opt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case):
    opt, jplan, tplan, topt = _case(case)
    want = np.asarray(jcliquet.pallas_partials(opt, SEED, 1, jplan, NB,
                                               interpret=True))
    got = tcliquet.partials(tcliquet.params(topt, "cpu"), SEED, 1, tplan, NB,
                            opt.n_periods)
    assert got.shape == (NB, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greek_partials_match_interpret_mode(case):
    opt, jplan, tplan, topt = _case(case)
    want = np.asarray(jcliquet.greek_pallas_partials(opt, SEED, 1, jplan, NB,
                                                     interpret=True))
    got = tcliquet.greek_partials(tcliquet.greek_params(topt, "cpu"), SEED, 1,
                                  tplan, NB, opt.n_periods)
    assert got.shape == (NB, tcliquet.N_GREEK_SUMS)
    assert_pairs_close(got.numpy(), want,
                       tplan.iters * tplan.units_per_iter, RTOL)


def test_scalars_match():
    """K17's and K18's scalars, formed as ``greek_pallas_partials`` forms
    them in float32."""
    opt = jtypes.CliquetOption(100.0, 0.03, 0.25, 1.5, n_periods=52,
                               cap=0.02, floor=-0.01)
    with jax.enable_x64(False):
        o = opt.astype(jnp.float32)
        dt, mu_dt, vol = jcliquet._scalars(o, opt.n_periods, jnp.float32)
        want = np.array([mu_dt, vol, o.cap, o.floor, dt, o.t, o.r, 1.0 / o.v],
                        np.float32)
    got = tcliquet.greek_params(from_reference(opt), "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tcliquet.params(from_reference(opt), "cpu").numpy(), want[:4])


@pytest.mark.parametrize("greeks", [False, True], ids=["K17", "K18"])
def test_block_offset_relabels_streams(greeks):
    opt = mctpu_torch.CliquetOption(100.0, 0.03, 0.2, 1.0, n_periods=5)
    plan = tcliquet.make_plan(4 * 2 * ROWS * 128, 4, ROWS, False)
    if greeks:
        par, fn = tcliquet.greek_params(opt, "cpu"), tcliquet.greek_partials
    else:
        par, fn = tcliquet.params(opt, "cpu"), tcliquet.partials
    full = fn(par, 9, 0, plan, 4, opt.n_periods)
    tail = fn(par, 9, 2, plan, 2, opt.n_periods)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


@pytest.mark.parametrize("n,cap,floor", [(12, 0.05, -0.02), (1, 0.10, -0.10),
                                         (52, 0.02, -0.01)])
def test_closed_form_and_gradients_match(n, cap, floor):
    want = float(jmath.cliquet_closed_form(0.03, 0.2, 1.0, n, cap, floor))
    got = tmath.cliquet_closed_form(0.03, 0.2, 1.0, n, cap, floor)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    jg = jax.grad(lambda v, r, t: jmath.cliquet_closed_form(r, v, t, n, cap,
                                                            floor),
                  argnums=(0, 1, 2))(0.2, 0.03, 1.0)
    xs = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
          for x in (0.2, 0.03, 1.0)]
    v, r, t = xs
    tg = torch.autograd.grad(tmath.cliquet_closed_form(r, v, t, n, cap,
                                                       floor), xs)
    np.testing.assert_allclose([float(x) for x in tg],
                               [float(x) for x in jg], rtol=1e-10)


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=4,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu")


def test_price_and_greeks_cliquet_match_mctpu():
    opt = jtypes.CliquetOption(100.0, 0.03, 0.2, 1.0, n_periods=5, cap=0.05,
                               floor=-0.02)
    n = 1 << 12
    want = jengine.price_cliquet(opt, n, KEY, JCFG)
    got = mctpu_torch.price_cliquet(from_reference(opt), n, SEED, TCFG)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for field in ("price", "std_error", "ci"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=RTOL)
    gwant = jengine.greeks_cliquet(opt, n, KEY, JCFG)
    ggot = mctpu_torch.greeks_cliquet(from_reference(opt), n, SEED, TCFG)
    for f in ("price", "vega", "rho", "theta", "delta", "gamma"):
        r, w = getattr(ggot, f), getattr(gwant, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        assert_pairs_close([[float(r.sum_p), float(r.sum_p2)]],
                           [[float(w.sum_p), float(w.sum_p2)]], w.n, 1e-5)
    # The same per-path payoffs, summed in another order.
    np.testing.assert_allclose(float(ggot.price.price), float(got.price),
                               rtol=1e-6)


def test_delta_and_gamma_are_exact_zeros_and_dispatch():
    opt = mctpu_torch.CliquetOption(100.0, 0.03, 0.2, 1.0, n_periods=3)
    g = mctpu_torch.greeks(opt, 1 << 10, SEED, TCFG)
    assert isinstance(g, GreeksResult) and g.theta is not None
    for r in (g.delta, g.gamma):
        assert float(r.price) == 0.0 and float(r.std_error) == 0.0
        assert float(r.ci) == 0.0 and r.n == g.price.n


def test_tight_band_pins_the_payoff():
    """cap = floor + 1e-6: every period pays floor, so the price is
    e^{-rT} n floor up to the band's width."""
    opt = mctpu_torch.CliquetOption(100.0, 0.03, 0.2, 1.0, n_periods=12,
                                    cap=0.02 + 1e-6, floor=0.02)
    res = mctpu_torch.price_cliquet(opt, 1 << 12, SEED, TCFG)
    assert float(res.price) == pytest.approx(np.exp(-0.03) * 12 * 0.02,
                                             rel=1e-4)


BAD = [dict(n_periods=0), dict(s=0.0), dict(v=-0.1), dict(t=-1.0),
       dict(cap=-0.05), dict(floor=-1.5)]


@pytest.mark.parametrize("bad", BAD, ids=[next(iter(b)) + str(i)
                                          for i, b in enumerate(BAD)])
def test_validation_errors_match_mctpu(bad):
    base = dict(s=100.0, r=0.03, v=0.2, t=1.0, cap=0.05, floor=-0.02)
    with pytest.raises(ValueError) as want:
        jtypes.CliquetOption(**{**base, **bad}).validate()
    with pytest.raises(ValueError) as got:
        mctpu_torch.price_cliquet(mctpu_torch.CliquetOption(**{**base, **bad}),
                                  1 << 10, SEED, TCFG)
    assert str(got.value) == str(want.value)
