"""The vanilla book of the port against mctpu (CPU): K23's and K24's plain
versions against the JAX kernels in interpret mode, the entry points
against ``mctpu.engine`` on interpret-mode Pallas, the ties to
``price_vanilla``, and the ``VanillaBook`` record.

Both packages draw K1's Philox stream.  K23's ``(B, M, 2)`` partials agree
at ``rtol=2e-5`` (other summation orders, libm ``exp`` within an ulp);
K24's ``(B, M, 12)`` ``(sum x, sum x^2)`` pairs by the scaled bound of
``tests/torch_tolerance.py`` at ``rtol=2e-5`` (a Greek's block sum can
nearly cancel).  Each case runs 4 blocks of ``rows=8`` for two iterations
over the 4-instrument book of ``tests/test_book.py``; the operand tables,
the ties and the block-offset contract are bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mctpu_torch
from mctpu import engine as jengine
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import book as jbook
from mctpu_torch import engine as tengine
from mctpu_torch.kernels import book as tbook
from mctpu_torch.types import VanillaBook, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(929)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS, ITERS = 4, 8, 2
BOOK = jtypes.VanillaBook.from_options([
    jtypes.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0),
    jtypes.VanillaOption(100.0, 120.0, 0.05, 0.3, 0.5),
    jtypes.VanillaOption(95.0, 90.0, 0.03, 0.15, 2.0, kind="put"),
    jtypes.VanillaOption(120.0, 100.0, 0.01, 0.25, 0.25, kind="put"),
])
JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=NB,
                            rows=ROWS)
TCFG = tengine.EngineConfig(num_blocks=NB, rows=ROWS, device="cpu")
FIELDS = ("price", "delta", "vega", "rho", "theta", "gamma")


def _signs(book):
    return jnp.asarray([1.0 if kd == "call" else -1.0 for kd in book.kinds],
                       jnp.float32)


def _jax_params(book):
    """K23's operands as ``mctpu.engine.price_book`` forms them."""
    with jax.enable_x64(False):
        o = book.astype(jnp.float32)
        mu = (o.r - 0.5 * o.v * o.v) * o.t
        sig = o.v * jnp.sqrt(o.t)
        return o.s, mu, sig, o.k, _signs(book)


def _plans(antithetic, kahan):
    paths = NB * ITERS * 2 * ROWS * 128 * (2 if antithetic else 1)
    jplan = jbook.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tbook.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.iters == ITERS
    return jplan, tplan


CASES = {"plain": (False, True), "antithetic": (True, True),
         "antithetic_f32": (True, False), "f32": (False, False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case):
    jplan, tplan = _plans(*CASES[case])
    want = np.asarray(jbook.pallas_partials(_jax_params(BOOK), SEED, 1, jplan,
                                            NB, interpret=True))
    got = tbook.partials(tbook.params(from_reference(BOOK), "cpu"), SEED, 1,
                         tplan, NB)
    assert got.shape == (NB, 4, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greek_partials_match_interpret_mode(case):
    jplan, tplan = _plans(*CASES[case])
    raw = (BOOK.s, BOOK.k, BOOK.r, BOOK.v, BOOK.t, _signs(BOOK))
    want = np.asarray(jbook.greek_pallas_partials(raw, SEED, 1, jplan, NB,
                                                  interpret=True))
    got = tbook.greek_partials(
        tbook.greek_const_rows(from_reference(BOOK), "cpu"), SEED, 1, tplan,
        NB)
    assert got.shape == (NB, 4, tbook.N_BOOK_GREEK_SUMS)
    assert_pairs_close(got.numpy().reshape(NB, -1), want.reshape(NB, -1),
                       tplan.iters * tplan.units_per_iter, RTOL)


def test_tables_match_kernel_prep():
    """K23's ``(5, M)`` and K24's ``(13, M)`` float32 tables, bit for bit
    the operands the JAX package forms."""
    book = from_reference(BOOK)
    np.testing.assert_array_equal(
        tbook.params(book, "cpu").numpy(),
        np.stack([np.asarray(x) for x in _jax_params(BOOK)]))
    with jax.enable_x64(False):
        want = np.asarray(jbook.greek_const_rows(
            (BOOK.s, BOOK.k, BOOK.r, BOOK.v, BOOK.t, _signs(BOOK)),
            jnp.float32))
    got = tbook.greek_const_rows(book, "cpu")
    assert got.dtype == torch.float32 and got.shape == (13, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serving_book_is_the_benchmark_book():
    """``VanillaBook.serving(64)`` gives K23 the operands, bit for bit, of
    the 64-instrument book that the JAX package's serving benchmark
    prices."""
    from benchmarks.book_rate_r4 import _book_params

    np.testing.assert_array_equal(
        tbook.params(VanillaBook.serving(64), "cpu").numpy(),
        np.stack([np.asarray(x) for x in _book_params(64)]))
    assert VanillaBook.serving(3, "put").kinds == ("put",) * 3


def test_price_and_greeks_book_match_mctpu():
    n = NB * ITERS * 2 * ROWS * 128
    book = from_reference(BOOK)
    want = jengine.price_book(BOOK, n, KEY, JCFG)
    got = mctpu_torch.price_book(book, n, SEED, TCFG)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for f in ("price", "std_error", "ci"):
        assert getattr(got, f).shape == (4,)
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=RTOL)
    gwant = jengine.greeks_book(BOOK, n, KEY, JCFG)
    ggot = mctpu_torch.greeks_book(book, n, SEED, TCFG)
    for f in FIELDS:
        r, w = getattr(ggot, f), getattr(gwant, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        assert r.price.shape == (4,)
        assert_pairs_close(np.stack([r.sum_p.numpy(), r.sum_p2.numpy()], 1),
                           np.stack([np.asarray(w.sum_p),
                                     np.asarray(w.sum_p2)], 1), w.n, 1e-5)
    # K24's price sums the same per-path payoffs as K23.
    np.testing.assert_allclose(ggot.price.price.numpy(), got.price.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_one_instrument_book_equals_price_vanilla(kind, antithetic):
    opt = mctpu_torch.VanillaOption(95.0, 90.0, 0.03, 0.15, 2.0, kind=kind)
    cfg = tengine.EngineConfig(num_blocks=NB, rows=ROWS, device="cpu",
                               antithetic=antithetic)
    one = VanillaBook.from_options([opt])
    rb = mctpu_torch.price_book(one, 1 << 14, SEED, cfg)
    rv = mctpu_torch.price_vanilla(opt, 1 << 14, SEED, cfg)
    for f in ("price", "ci", "std_error", "sum_p", "sum_p2"):
        assert float(getattr(rb, f)[0]) == float(getattr(rv, f)), f
    assert (rb.n, rb.n_paths) == (rv.n, rv.n_paths)


def test_one_call_book_greeks_equal_one_strike_ladder():
    opt = mctpu_torch.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    gb = mctpu_torch.greeks_book(VanillaBook.from_options([opt]), 1 << 13,
                                 SEED, TCFG)
    gl = mctpu_torch.greeks_vanilla_ladder(opt, [100.0], 1 << 13, SEED, TCFG)
    # Same integrands; the gamma scale rounds k / (s0^2 v sqt) in the book
    # and (1 / (s0^2 v sqt)) k in the ladder.
    for f in FIELDS:
        np.testing.assert_allclose(getattr(gb, f).price.numpy(),
                                   getattr(gl, f).price.numpy(), rtol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("greeks", [False, True], ids=["K23", "K24"])
def test_block_offset_relabels_streams(greeks):
    book = from_reference(BOOK)
    plan = tbook.make_plan(4 * 2 * ROWS * 128, 4, ROWS, False)
    if greeks:
        par, fn = tbook.greek_const_rows(book, "cpu"), tbook.greek_partials
    else:
        par, fn = tbook.params(book, "cpu"), tbook.partials
    full = fn(par, 9, 0, plan, 4)
    tail = fn(par, 9, 2, plan, 2)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


def test_record_carries_kinds_and_signs():
    book = from_reference(BOOK)
    assert isinstance(book, VanillaBook) and book.kinds == BOOK.kinds
    assert all(type(kd) is str for kd in book.kinds)
    assert book.n_instruments == 4
    np.testing.assert_array_equal(tbook.params(book, "cpu")[4].numpy(),
                                  np.asarray(_signs(BOOK)))
    for i in range(4):
        o, w = book.option(i), BOOK.option(i)
        assert o.kind == w.kind
        assert (o.s, o.k, o.r, o.v, o.t) == tuple(
            float(x) for x in (w.s, w.k, w.r, w.v, w.t))
    np.testing.assert_array_equal(VanillaBook.from_options(
        [book.option(i) for i in range(4)]).s, book.s)


def test_market_tick_reprices():
    book = from_reference(BOOK)
    base = mctpu_torch.price_book(book, 1 << 13, SEED, TCFG)
    ticked = dataclasses.replace(book, s=book.s * 1.01, v=book.v * 0.98)
    res = mctpu_torch.price_book(ticked, 1 << 13, SEED, TCFG)
    assert not np.allclose(res.price.numpy(), base.price.numpy())
    assert repr(res).count("±") == 4


BAD = {
    "kinds_length": dict(kinds=("call",)),
    "kinds_value": dict(kinds=("call", "straddle")),
    "shape": dict(k=np.ones(3)),
    "spot": dict(s=np.array([100.0, -1.0])),
    "vol": dict(v=np.array([0.2, -0.1])),
    "maturity": dict(t=np.array([1.0, 0.0])),
    "empty": dict(s=np.ones(0), k=np.ones(0), r=np.ones(0), v=np.ones(0),
                  t=np.ones(0), kinds=()),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_validation_errors_match_mctpu(bad):
    base = dict(s=np.full(2, 100.0), k=np.full(2, 100.0), r=np.zeros(2),
                v=np.full(2, 0.2), t=np.ones(2), kinds=("call", "put"))
    fields = {**base, **BAD[bad]}
    with pytest.raises(ValueError) as want:
        jtypes.VanillaBook(**fields).validate()
    with pytest.raises(ValueError) as got:
        mctpu_torch.price_book(VanillaBook(**fields), 1 << 10, SEED, TCFG)
    assert str(got.value) == str(want.value)


def test_book_size_is_capped():
    opt = jtypes.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    big = jtypes.VanillaBook.from_options([opt] * 65)
    with pytest.raises(ValueError) as want:
        jengine.price_book(big, 1 << 12, KEY, JCFG)
    for fn in (mctpu_torch.price_book, mctpu_torch.greeks_book):
        with pytest.raises(ValueError) as got:
            fn(from_reference(big), 1 << 12, SEED, TCFG)
        assert str(got.value) == str(want.value)
    # As in mctpu, the greeks dispatcher takes no book.
    with pytest.raises(TypeError):
        mctpu_torch.greeks(from_reference(BOOK), 1 << 12, SEED, TCFG)
