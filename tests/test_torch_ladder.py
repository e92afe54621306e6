"""The strike ladder of the port against mctpu (CPU): K21's and K22's plain
versions against the JAX kernels in interpret mode, the entry points
against ``mctpu.engine`` on interpret-mode Pallas, the ties to
``price_vanilla`` and the ladder's records.

Both packages draw K1's Philox stream.  K21's ``(B, K, 2)`` partials agree
at ``rtol=2e-5`` (other summation orders, libm ``exp`` within an ulp);
K22's ``(B, K, 12)`` ``(sum x, sum x^2)`` pairs by the scaled bound of
``tests/torch_tolerance.py`` at ``rtol=2e-5`` (a Greek's block sum can
nearly cancel).  Each case runs 4 blocks of ``rows=8`` for two iterations
over the 5 strikes 70..130; the ties and the block-offset contract are
bitwise.
"""
import jax
import numpy as np
import pytest
import torch

import mctpu_torch
from mctpu import engine as jengine
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import ladder as jladder
from mctpu_torch import engine as tengine
from mctpu_torch.kernels import ladder as tladder
from mctpu_torch.types import from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(515)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS, ITERS = 4, 8, 2
KS = np.array([70.0, 85.0, 100.0, 115.0, 130.0])
JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=NB,
                            rows=ROWS)
TCFG = tengine.EngineConfig(num_blocks=NB, rows=ROWS, device="cpu")

CASES = {
    # name: (kind, antithetic, kahan)
    "call": ("call", False, True),
    "put": ("put", False, True),
    "call_antithetic": ("call", True, True),
    "put_antithetic_f32": ("put", True, False),
}


def _case(case):
    kind, antithetic, kahan = CASES[case]
    opt = jtypes.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0, kind=kind)
    paths = NB * ITERS * 2 * ROWS * 128 * (2 if antithetic else 1)
    jplan = jladder.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tladder.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.iters == ITERS
    return opt, jplan, tplan, from_reference(opt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case):
    opt, jplan, tplan, topt = _case(case)
    want = np.asarray(jladder.pallas_partials(opt, KS, SEED, 1, jplan, NB,
                                              interpret=True))
    got = tladder.partials(tladder.params(topt, "cpu"),
                           tladder.strike_vector(KS, "cpu"), SEED, 1, tplan,
                           NB, opt.kind == "put")
    assert got.shape == (NB, len(KS), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greek_partials_match_interpret_mode(case):
    opt, jplan, tplan, topt = _case(case)
    want = np.asarray(jladder.greek_pallas_partials(
        opt, KS, SEED, 1, jplan, NB, interpret=True))
    got = tladder.greek_partials(tladder.greek_params(topt, "cpu"),
                                 tladder.strike_vector(KS, "cpu"), SEED, 1,
                                 tplan, NB, opt.kind == "put")
    assert got.shape == (NB, len(KS), tladder.N_LADDER_GREEK_SUMS)
    assert_pairs_close(got.numpy().reshape(NB, -1), want.reshape(NB, -1),
                       tplan.iters * tplan.units_per_iter, RTOL)


def test_params_match_kernel_prep():
    """K21's and K22's float32 operands, formed as ``pallas_partials`` and
    ``greek_pallas_partials`` form them."""
    opt = jtypes.VanillaOption(100.0, 95.0, 0.048790, 0.25, 1.5)
    with jax.enable_x64(False):
        o = opt.astype(np.float32)
        sqt = np.sqrt(np.float32(o.t))
        want = np.array([o.s, (o.r - 0.5 * o.v * o.v) * o.t, o.v * sqt, o.v,
                         o.t, sqt, o.r, 1.0 / o.s,
                         1.0 / (o.s * o.s * o.v * sqt)], np.float32)
    topt = from_reference(opt)
    np.testing.assert_array_equal(tladder.greek_params(topt, "cpu").numpy(),
                                  want)
    np.testing.assert_array_equal(tladder.params(topt, "cpu").numpy(),
                                  want[:3])
    ks = tladder.strike_vector(KS, "cpu")
    assert ks.dtype == torch.float32 and ks.shape == (5,)


def test_price_and_greeks_ladder_match_mctpu():
    n = NB * ITERS * 2 * ROWS * 128
    for kind in ("call", "put"):
        opt = jtypes.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0, kind=kind)
        want = jengine.price_vanilla_ladder(opt, KS, n, KEY, JCFG)
        got = mctpu_torch.price_vanilla_ladder(from_reference(opt), KS, n,
                                               SEED, TCFG)
        assert (got.n, got.n_paths) == (want.n, want.n_paths)
        for f in ("price", "std_error", "ci"):
            assert getattr(got, f).shape == (len(KS),)
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=RTOL)
        gwant = jengine.greeks_vanilla_ladder(opt, KS, n, KEY, JCFG)
        ggot = mctpu_torch.greeks_vanilla_ladder(from_reference(opt), KS, n,
                                                 SEED, TCFG)
        for f in ("price", "delta", "vega", "rho", "theta", "gamma"):
            r, w = getattr(ggot, f), getattr(gwant, f)
            assert (r.n, r.n_paths) == (w.n, w.n_paths)
            assert r.price.shape == (len(KS),)
            assert_pairs_close(
                np.stack([r.sum_p.numpy(), r.sum_p2.numpy()], 1),
                np.stack([np.asarray(w.sum_p), np.asarray(w.sum_p2)], 1),
                w.n, 1e-5)
        # K22's price sums the same per-path payoffs as K21.
        np.testing.assert_allclose(ggot.price.price.numpy(),
                                   got.price.numpy(), rtol=1e-6)


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_one_strike_ladder_equals_price_vanilla(kind, antithetic):
    opt = mctpu_torch.VanillaOption(100.0, 95.0, 0.05, 0.2, 1.0, kind=kind)
    cfg = tengine.EngineConfig(num_blocks=NB, rows=ROWS, device="cpu",
                               antithetic=antithetic)
    lad = mctpu_torch.price_vanilla_ladder(opt, [95.0], 1 << 14, SEED, cfg)
    van = mctpu_torch.price_vanilla(opt, 1 << 14, SEED, cfg)
    for f in ("price", "ci", "std_error", "sum_p", "sum_p2"):
        assert float(getattr(lad, f)[0]) == float(getattr(van, f)), f
    assert (lad.n, lad.n_paths) == (van.n, van.n_paths)


def test_ladder_is_comonotone_across_strikes():
    """Common draws: call prices fall and are convex in the strike, the
    call delta ladder falls, puts rise, path by path."""
    opt = mctpu_torch.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    res = mctpu_torch.price_vanilla_ladder(opt, KS, 1 << 14, SEED, TCFG)
    p = res.price.numpy()
    assert (np.diff(p) < 0).all()
    assert (p[:-2] - 2 * p[1:-1] + p[2:] >= -1e-12).all()
    g = mctpu_torch.greeks_vanilla_ladder(opt, KS, 1 << 14, SEED, TCFG)
    assert (np.diff(g.delta.price.numpy()) < 0).all()
    put = mctpu_torch.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0, kind="put")
    pp = mctpu_torch.price_vanilla_ladder(put, KS, 1 << 14, SEED, TCFG)
    assert (np.diff(pp.price.numpy()) > 0).all()


@pytest.mark.parametrize("greeks", [False, True], ids=["K21", "K22"])
def test_block_offset_relabels_streams(greeks):
    opt = mctpu_torch.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    plan = tladder.make_plan(4 * 2 * ROWS * 128, 4, ROWS, False)
    ks = tladder.strike_vector(KS, "cpu")
    if greeks:
        par, fn = tladder.greek_params(opt, "cpu"), tladder.greek_partials
    else:
        par, fn = tladder.params(opt, "cpu"), tladder.partials
    full = fn(par, ks, 9, 0, plan, 4, False)
    tail = fn(par, ks, 9, 2, plan, 2, False)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


@pytest.mark.parametrize("n_strikes", [0, 65])
def test_strike_count_is_capped(n_strikes):
    opt = jtypes.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    ks = np.linspace(50.0, 150.0, n_strikes)
    with pytest.raises(ValueError) as want:
        jengine.price_vanilla_ladder(opt, ks, 1 << 12, KEY, JCFG)
    for fn in (mctpu_torch.price_vanilla_ladder,
               mctpu_torch.greeks_vanilla_ladder):
        with pytest.raises(ValueError) as got:
            fn(from_reference(opt), ks, 1 << 12, SEED, TCFG)
        assert str(got.value) == str(want.value)


def test_vector_results_print_their_pairs():
    opt = mctpu_torch.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    res = mctpu_torch.price_vanilla_ladder(opt, KS, 1 << 12, SEED, TCFG)
    text = repr(res)
    assert text.startswith("McResult(prices=[") and text.count("±") == 5
    assert f"{float(res.price[0]):.4f}±{float(res.ci[0]):.4f}" in text
    basket = mctpu_torch.BasketOption.default_reference(3)
    delta = mctpu_torch.greeks_basket(basket, 1 << 12, SEED, TCFG).delta
    assert repr(delta).count("±") == 3
    one = mctpu_torch.price_vanilla_ladder(opt, [100.0], 1 << 12, SEED, TCFG)
    assert repr(one).startswith("McResult(price=")
