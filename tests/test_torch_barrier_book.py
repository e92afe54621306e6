"""The barrier book of the port against mctpu (CPU): K25's and K26's plain
versions against the JAX kernels in interpret mode, the entry points
against ``mctpu.engine`` on interpret-mode Pallas, the ties to
``price_barrier``, the operand tables and the ``BarrierBook`` record.

Both packages draw the walk kernels' Philox stream.  K25's ``(B, M, 2)``
partials agree at ``rtol=2e-5`` (other summation orders, libm ``exp``
within an ulp); K26's ``(B, M, 8)`` ``(sum x, sum x^2)`` pairs by the
scaled bound of ``tests/torch_tolerance.py`` at ``rtol=2e-5``: the LR vega
integrand ``p (z2s / v - zs sqrt(dt) - n / v)`` cancels heavily, as K13's.
Each case runs 2 blocks of ``rows=8`` for one or two iterations over the
4-instrument book of ``tests/test_book.py`` (three up-and-out calls and a
down-and-out put) at up to 7 dates.  The tables, the one-instrument tie,
two identical instruments and the block-offset contract are bitwise.
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
from mctpu.kernels import barrier_book as jbb
from mctpu_torch import engine as tengine
from mctpu_torch.kernels import barrier_book as tbb
from mctpu_torch.types import BarrierBook, GreeksResult, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(3232)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8


def _jbook(n_obs, m=4):
    """The 4-instrument book of ``tests/test_book.py`` (its first ``m``)."""
    return jtypes.BarrierBook(
        s=np.asarray([100.0, 95.0, 105.0, 100.0][:m]),
        k=np.asarray([100.0, 90.0, 110.0, 95.0][:m]),
        r=np.asarray([0.05, 0.03, 0.04, 0.05][:m]),
        v=np.asarray([0.2, 0.25, 0.15, 0.3][:m]),
        t=np.asarray([1.0, 2.0, 0.5, 1.0][:m]),
        barrier=np.asarray([130.0, 140.0, 150.0, 70.0][:m]),
        n_obs=n_obs,
        kinds=("call", "call", "call", "put")[:m],
        directions=("up-and-out", "up-and-out", "up-and-out",
                    "down-and-out")[:m])


CASES = {
    # name: (n_obs, instruments, antithetic, kahan, iters)
    "n1": (1, 4, False, True, 1),
    "n5_m1": (5, 1, False, True, 1),
    "n6_f32_2iters": (6, 4, False, False, 2),
    "n7_antithetic": (7, 4, True, True, 1),
}


def _plans(antithetic, kahan, iters):
    paths = NB * iters * ROWS * 128 * (2 if antithetic else 1)
    jplan = jbb.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tbb.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.iters == iters
    return jplan, tplan


@pytest.mark.parametrize("greeks", [False, True], ids=["K25", "K26"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case, greeks):
    """Both kernels on the port's own table (the tables are held apart, in
    :func:`test_tables_match_kernel_prep`)."""
    n_obs, m, antithetic, kahan, iters = CASES[case]
    jplan, tplan = _plans(antithetic, kahan, iters)
    book = from_reference(_jbook(n_obs, m))
    if greeks:
        table = tbb.greek_rows(book, "cpu")
        want = np.asarray(jbb.greek_pallas_partials(
            jnp.asarray(table.numpy()), SEED, 1, jplan, NB, n_obs,
            interpret=True))
        got = tbb.greek_partials(table, SEED, 1, tplan, NB, n_obs)
        assert got.shape == (NB, m, tbb.N_BB_GREEK_SUMS)
        assert_pairs_close(got.numpy().reshape(NB, -1), want.reshape(NB, -1),
                           tplan.iters * tplan.units_per_iter, RTOL)
    else:
        table = tbb.book_params(book, "cpu")
        want = np.asarray(jbb.pallas_partials(
            jnp.asarray(table.numpy()), SEED, 1, jplan, NB, n_obs,
            interpret=True))
        got = tbb.partials(table, SEED, 1, tplan, NB, n_obs)
        assert got.shape == (NB, m, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def _jax_tables(jbook):
    """``(eager, jitted)`` pairs of K25's and K26's tables as ``mctpu``
    forms them: operation by operation as the source writes them, and
    under ``jit`` as ``mctpu.engine`` does."""
    out = []
    for fn in (jbb.book_params, jbb.greek_rows):
        with jax.enable_x64(False):
            eager = np.asarray(fn(jbook, jbook.n_obs, jnp.float32))
            jitted = np.asarray(jax.jit(
                lambda b, f=fn: f(b, b.n_obs, jnp.float32))(jbook))
        out.append((eager, jitted))
    return out


def _jax_serving(n_obs):
    """The serving book as an ``mctpu`` record, at ``n_obs`` dates."""
    book = BarrierBook.serving(32)
    return jtypes.BarrierBook(
        *(getattr(book, f) for f in ("s", "k", "r", "v", "t", "barrier")),
        n_obs=n_obs, kinds=book.kinds, directions=book.directions)


@pytest.mark.parametrize("which,n_obs", [("test", 5), ("test", 7),
                                         ("serving", 13), ("serving", 50)])
def test_tables_match_kernel_prep(which, n_obs):
    """The ``(7, M)`` and ``(13, M)`` float32 tables, bit for bit the
    operands ``mctpu`` forms operation by operation.  Under ``jit`` XLA's
    CPU compiler takes ``t / n`` as ``t * (1 / n)`` and contracts ``r - 0.5
    v v`` into a fused multiply-add, which moves the drift row (row 3) of
    some instruments: by an ulp, and by 3-4 ulps where ``r`` and ``v^2 /
    2`` nearly cancel (the put, r = 0.05 and v = 0.3, at n_obs = 5 and 7).
    The drift row is held to four roundings of its terms ``(|r| + v^2 / 2)
    dt``, every other row to two ulps (they agree bit for bit here)."""
    jbook = _jbook(n_obs) if which == "test" else _jax_serving(n_obs)
    book = from_reference(jbook)
    r, v, t = (np.asarray(x, np.float64) for x in (book.r, book.v, book.t))
    terms = (np.abs(r) + 0.5 * v * v) * t / n_obs
    for got, (eager, jitted) in zip(
            (tbb.book_params(book, "cpu"), tbb.greek_rows(book, "cpu")),
            _jax_tables(jbook)):
        assert got.dtype == torch.float32
        assert got.shape == (eager.shape[0], book.n_instruments)
        got = got.numpy()
        np.testing.assert_array_equal(got, eager)
        rows = [i for i in range(got.shape[0]) if i != 3]
        np.testing.assert_array_max_ulp(got[rows], jitted[rows], maxulp=2)
        drift_err = np.abs(got[3].astype(np.float64) - jitted[3])
        assert (drift_err <= 4 * 2.0 ** -24 * terms).all(), drift_err


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kind,h", [("up-and-out", 120.0),
                                    ("down-and-out", 85.0)])
def test_one_instrument_book_equals_price_barrier(kind, h, antithetic):
    """A one-instrument book computes K12's path step for step: on the CPU
    the port's plain K25 equals its plain K12 bit for bit."""
    opt = mctpu_torch.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, h,
                                    n_obs=5, kind=kind)
    cfg = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu",
                               antithetic=antithetic)
    rb = mctpu_torch.price_barrier_book(BarrierBook.from_options([opt]),
                                        1 << 13, SEED, cfg)
    rs = mctpu_torch.price_barrier(opt, 1 << 13, SEED, cfg)
    for f in ("price", "ci", "std_error", "sum_p", "sum_p2"):
        assert float(getattr(rb, f)[0]) == float(getattr(rs, f)), f
    assert (rb.n, rb.n_paths) == (rs.n, rs.n_paths)
    # K26 and K13: the same integrands (their tables round n / v and
    # 1 / (s0 vol) apart).
    gb = mctpu_torch.greeks_barrier_book(BarrierBook.from_options([opt]),
                                         1 << 13, SEED, cfg)
    gs = mctpu_torch.greeks_barrier(opt, 1 << 13, SEED, cfg)
    for f in ("price", "delta", "vega", "rho"):
        r, w = getattr(gb, f), getattr(gs, f)
        assert_pairs_close([[float(r.sum_p[0]), float(r.sum_p2[0])]],
                           [[float(w.sum_p), float(w.sum_p2)]], w.n, 1e-6)


def test_identical_instruments_give_identical_marks():
    opt = mctpu_torch.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, 130.0,
                                    n_obs=5)
    cfg = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu")
    twin = BarrierBook.from_options([opt, opt])
    res = mctpu_torch.price_barrier_book(twin, 1 << 13, SEED, cfg)
    g = mctpu_torch.greeks_barrier_book(twin, 1 << 13, SEED, cfg)
    for r in (res, g.price, g.delta, g.vega, g.rho):
        assert torch.equal(r.sum_p[0], r.sum_p[1])
        assert torch.equal(r.sum_p2[0], r.sum_p2[1])
    assert g.theta is None and g.gamma is None


@pytest.mark.parametrize("greeks", [False, True], ids=["K25", "K26"])
def test_block_offset_relabels_streams(greeks):
    book = from_reference(_jbook(5))
    plan = tbb.make_plan(4 * ROWS * 128, 4, ROWS, False)
    if greeks:
        par, fn = tbb.greek_rows(book, "cpu"), tbb.greek_partials
    else:
        par, fn = tbb.book_params(book, "cpu"), tbb.partials
    full = fn(par, 9, 0, plan, 4, 5)
    tail = fn(par, 9, 2, plan, 2, 5)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=4,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu")


def test_price_and_greeks_barrier_book_match_mctpu():
    """The entry points at the same seed word.  ``mctpu.engine`` forms its
    tables under ``jit``, whose drift of the put differs from the port's by
    a few ulps (:func:`test_tables_match_kernel_prep`); no path of this run
    comes near enough its barrier for that to knock it out in one package
    and not the other."""
    jbook = _jbook(5)
    book = from_reference(jbook)
    n = 1 << 12
    want = jengine.price_barrier_book(jbook, n, KEY, JCFG)
    got = mctpu_torch.price_barrier_book(book, n, SEED, TCFG)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for f in ("price", "std_error", "ci"):
        assert getattr(got, f).shape == (4,)
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=RTOL)
    gwant = jengine.greeks_barrier_book(jbook, n, KEY, JCFG)
    ggot = mctpu_torch.greeks_barrier_book(book, n, SEED, TCFG)
    assert isinstance(ggot, GreeksResult)
    for f in ("price", "delta", "vega", "rho"):
        r, w = getattr(ggot, f), getattr(gwant, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        assert r.price.shape == (4,)
        assert_pairs_close(np.stack([r.sum_p.numpy(), r.sum_p2.numpy()], 1),
                           np.stack([np.asarray(w.sum_p),
                                     np.asarray(w.sum_p2)], 1), w.n, 1e-5)
    # K26's price sums the same per-path payoffs as K25.
    np.testing.assert_allclose(ggot.price.price.numpy(), got.price.numpy(),
                               rtol=1e-6)


def test_serving_book_is_the_command_line_book():
    """``BarrierBook.serving(32)`` is, bit for bit, the book the JAX
    command line's ``--product barrier-book --assets 32`` prices."""
    from mctpu.cli import exotic

    class Captured(Exception):
        pass

    def capture(book, *args, **kwargs):
        raise Captured(book)

    orig = jengine.price_barrier_book
    jengine.price_barrier_book = capture
    try:
        with pytest.raises(Captured) as got:
            exotic.main(["--product", "barrier-book", "--assets", "32"])
    finally:
        jengine.price_barrier_book = orig
    want, mine = got.value.args[0], BarrierBook.serving(32)
    for f in ("s", "k", "r", "v", "t", "barrier"):
        np.testing.assert_array_equal(np.asarray(getattr(mine, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert (mine.n_obs, mine.kinds, mine.directions) == (
        want.n_obs, want.kinds, want.directions)
    assert BarrierBook.serving(3, "call").kinds == ("call",) * 3


def test_record_carries_kinds_and_directions():
    jbook = _jbook(5)
    book = from_reference(jbook)
    assert isinstance(book, BarrierBook) and book.n_obs == 5
    assert (book.kinds, book.directions) == (jbook.kinds, jbook.directions)
    assert all(type(x) is str for x in book.kinds + book.directions)
    for i in range(3):
        o, w = book.option(i), jbook.option(i)
        assert (o.kind, o.n_obs) == (w.kind, w.n_obs)
        assert (o.s, o.k, o.r, o.v, o.t, o.barrier) == tuple(
            float(x) for x in (w.s, w.k, w.r, w.v, w.t, w.barrier))
    np.testing.assert_array_equal(BarrierBook.from_options(
        [book.option(i) for i in range(3)]).barrier, book.barrier[:3])
    for fn in (book.option, jbook.option):
        with pytest.raises(ValueError, match="call-only"):
            fn(3)
    opts = [book.option(0), dataclasses.replace(book.option(1), n_obs=6)]
    with pytest.raises(ValueError) as want:
        jtypes.BarrierBook.from_options([jbook.option(0), dataclasses.replace(
            jbook.option(1), n_obs=6)])
    with pytest.raises(ValueError) as got:
        BarrierBook.from_options(opts)
    assert str(got.value) == str(want.value)


def test_tick_reprices_and_flips_a_direction():
    book = from_reference(_jbook(5))
    base = mctpu_torch.price_barrier_book(book, 1 << 13, SEED, TCFG)
    ticked = dataclasses.replace(
        book, s=book.s * 1.01, v=book.v * 0.99,
        barrier=np.asarray([80.0, 140.0, 150.0, 70.0]),
        directions=("down-and-out",) + book.directions[1:])
    res = mctpu_torch.price_barrier_book(ticked, 1 << 13, SEED, TCFG)
    assert not np.allclose(res.price.numpy(), base.price.numpy())
    one = mctpu_torch.price_barrier(ticked.option(0), 1 << 13, SEED, TCFG)
    assert float(res.price[0]) == float(one.price)
    assert repr(res).count("±") == 4


def _bad_fields():
    base = dict(s=np.full(2, 100.0), k=np.full(2, 100.0), r=np.zeros(2),
                v=np.full(2, 0.2), t=np.ones(2),
                barrier=np.asarray([130.0, 70.0]), n_obs=5,
                kinds=("call", "put"),
                directions=("up-and-out", "down-and-out"))
    return base, {
        "kinds_length": dict(kinds=("call",)),
        "kinds_value": dict(kinds=("call", "straddle")),
        "directions_value": dict(directions=("up-and-out", "up-and-in")),
        "shape": dict(barrier=np.ones(3)),
        "spot": dict(s=np.array([100.0, -1.0])),
        "barrier": dict(barrier=np.array([130.0, 0.0])),
        "vol": dict(v=np.array([0.2, -0.1])),
        "maturity": dict(t=np.array([1.0, 0.0])),
        "n_obs": dict(n_obs=0),
        "knocked_out": dict(barrier=np.array([100.0, 70.0])),
        "both_knocked_out": dict(barrier=np.array([90.0, 110.0])),
        "empty": dict(s=np.ones(0), k=np.ones(0), r=np.ones(0), v=np.ones(0),
                      t=np.ones(0), barrier=np.ones(0), kinds=(),
                      directions=()),
    }


@pytest.mark.parametrize("bad", sorted(_bad_fields()[1]))
def test_validation_errors_match_mctpu(bad):
    base, bads = _bad_fields()
    fields = {**base, **bads[bad]}
    with pytest.raises(ValueError) as want:
        jtypes.BarrierBook(**fields).validate()
    for fn in (mctpu_torch.price_barrier_book,
               mctpu_torch.greeks_barrier_book):
        with pytest.raises(ValueError) as got:
            fn(BarrierBook(**fields), 1 << 10, SEED, TCFG)
        assert str(got.value) == str(want.value)


def test_book_size_is_capped():
    opt = jtypes.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, 130.0, n_obs=3)
    big = jtypes.BarrierBook.from_options([opt] * 33)
    with pytest.raises(ValueError) as want:
        jengine.price_barrier_book(big, 1 << 12, KEY, JCFG)
    for fn in (mctpu_torch.price_barrier_book,
               mctpu_torch.greeks_barrier_book):
        with pytest.raises(ValueError) as got:
            fn(from_reference(big), 1 << 12, SEED, TCFG)
        assert str(got.value) == str(want.value)
    # As in mctpu, the greeks dispatcher takes no book.
    with pytest.raises(TypeError):
        mctpu_torch.greeks(from_reference(_jbook(3)), 1 << 12, SEED, TCFG)
