"""The basket Greeks of the port against mctpu (CPU): K32's, K33's, K34's
and K35's plain versions against the JAX kernels in interpret mode, their
operand tables (``L^-1`` included) against ``mctpu``'s builders bit for
bit, the engine entry points against ``mctpu.engine`` on interpret-mode
Pallas, the dispatcher, and what the entry points refuse.

The ``(B, 4)`` scalar and ``(B, 4, a)`` per-asset ``(sum x, sum x^2)``
pairs are held by the scaled bound of ``tests/torch_tolerance.py`` at
``rtol=2e-5``: the likelihood-ratio vega ``p (sum q (bt / v - sqrt(dt)) -
n / v)`` cancels heavily, so a plain relative bound would test the
cancellation, not the port.  ``mctpu`` writes the per-asset sums into
lanes ``0..a-1`` of ``(B, 4, 128)`` rows; the lanes past ``a`` must be
zero.  K33 and K35 write ``(B, 4, width)`` lane rows whose padded lanes are
exactly zero.  Each interpret-mode call runs once: 2 blocks of
``rows=8``.
"""
import dataclasses

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
from mctpu.kernels import multi_walk as jmw
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import multi_walk as tmw
from mctpu_torch.types import (BasketAsianOption, BasketBarrierOption,
                               BasketOption, GreeksResult, from_reference)
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(37)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The wide baskets' plain walks beside other test workers: torch's
    per-process thread pool oversubscribes the cores, so this module runs
    torch on one thread and restores the setting after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CASES = {
    # name: (assets, barrier kernel, n_obs, up, barrier, antithetic, kahan,
    #        iters)
    "K32_a3_n5": (3, False, 5, True, None, False, True, 1),
    "K32_a1_n4_antithetic_f32_2iters": (1, False, 4, True, None, True, False,
                                        2),
    "K32_a8_n2": (8, False, 2, True, None, False, True, 1),
    "K34_a3_up_n4_antithetic_f32_2iters": (3, True, 4, True, 104.0, True,
                                           False, 2),
    "K34_a1_down_n7": (1, True, 7, False, 97.0, False, True, 1),
    "K34_a8_up_n2": (8, True, 2, True, 103.0, False, True, 1),
    "K34_a5_down_n3_antithetic_2iters": (5, True, 3, False, 97.0, True, True,
                                         2),
}

MIXED = jtypes.BasketOption(
    s=np.array([95.0, 100.0, 110.0]), v=np.array([0.2, 0.3, 0.25]),
    w=np.array([0.5, 0.3, 0.2]),
    corr=np.array([[1.0, 0.3, -0.2], [0.3, 1.0, 0.4], [-0.2, 0.4, 1.0]]),
    d=np.array([0.1, -0.05, 0.0]), k=100.0, r=0.03, t=1.5)


def _chol64(bk):
    with jax.enable_x64(True):
        return np.asarray(jmath.cholesky_lower(jnp.asarray(bk.corr,
                                                           jnp.float64)))


def _pairs(scal, vec):
    """``(B, 4)`` and ``(B, 4, a)`` sums -> ``(B, 4 + 4a)`` as ``(sum x,
    sum x^2)`` pairs: price, rho, then per asset delta and vega."""
    scal, vec = np.asarray(scal), np.asarray(vec)
    cols = [scal] + [vec[:, :, i] for i in range(vec.shape[2])]
    return np.concatenate(cols, axis=1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greek_partials_match_interpret_mode(case):
    a, bar, n_obs, up, h, antithetic, kahan, iters = CASES[case]
    bk = jtypes.BasketOption.equicorrelated(a, 0.3)
    probe = jmw.make_plan(1, NB, ROWS, antithetic, n_assets=a)
    paths = NB * iters * probe.paths_per_iter
    jplan = jmw.make_plan(paths, NB, ROWS, antithetic, kahan=kahan,
                          n_assets=a)
    tplan = tmw.make_plan(paths, NB, ROWS, antithetic, kahan, n_assets=a)
    assert (tplan.iters, tplan.units_per_iter) == (jplan.iters,
                                                   jplan.units_per_iter)
    tb = from_reference(bk)
    chol = tmath.cholesky_lower(tb.corr)
    if bar:
        ws, wv = jmw.bar_greek_pallas_partials(
            bk, _chol64(bk), SEED, 1, jplan, NB, n_obs=n_obs, barrier=h,
            up=up, interpret=True)
        gs, gv = tmw.am_bar_greek_partials(
            *tmw.am_bar_greek_ops(tb, chol, n_obs, h), SEED, 1, tplan, NB,
            n_obs, up)
    else:
        ws, wv = jmw.greek_pallas_partials(bk, _chol64(bk), SEED, 1, jplan,
                                           NB, n_obs=n_obs, interpret=True)
        gs, gv = tmw.am_greek_partials(*tmw.am_greek_ops(tb, chol, n_obs),
                                       SEED, 1, tplan, NB, n_obs)
    wv = np.asarray(wv)
    assert wv.shape == (NB, 4, 128) and (wv[:, :, a:] == 0).all()
    assert gs.shape == (NB, 4) and gv.shape == (NB, 4, a)
    assert_pairs_close(_pairs(gs, gv), _pairs(ws, wv[:, :, :a]),
                       tplan.iters * tplan.units_per_iter, RTOL)


@pytest.mark.parametrize("basket", ["mixed", "eq1", "eq8"])
@pytest.mark.parametrize("n_obs", [7, 16, 50])
def test_greek_ops_match_mctpu_builders(basket, n_obs):
    """K32's and K34's tables equal ``_am_greek_ops`` and
    ``_am_bar_greek_ops`` as ``mctpu``'s source forms them (eagerly), bit
    for bit; ``L^-1`` by ``torch.linalg.solve_triangular`` equals
    ``jax.scipy.linalg.solve_triangular``'s."""
    bk = (MIXED if basket == "mixed"
          else jtypes.BasketOption.equicorrelated(int(basket[2:]), 0.3))
    ch = _chol64(bk)
    with jax.enable_x64(False):
        o = bk.astype(jnp.float32)
        jlt, jpar, jsqdt, jdt = jmw._am_greek_ops(o, ch, jnp.float32, n_obs)
        blt, blinv, bpar, bsqdt = jmw._am_bar_greek_ops(o, ch, jnp.float32,
                                                        n_obs)
        want_scal = np.array([o.k, o.t, np.float32(1.0 / n_obs), jsqdt, jdt],
                             np.float32)
        want_bscal = np.array([o.k, o.t, 120.0, bsqdt], np.float32)
        jpar, bpar, blinv = (np.asarray(x) for x in (jpar, bpar, blinv))
    tb = from_reference(bk)
    chol = tmath.cholesky_lower(tb.corr)
    scal, lt, par = tmw.am_greek_ops(tb, chol, n_obs)
    np.testing.assert_array_equal(scal.numpy(), want_scal)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(jlt))
    np.testing.assert_array_equal(par.numpy(), jpar)
    bscal, blt2, linv, bpar2 = tmw.am_bar_greek_ops(tb, chol, n_obs, 120.0)
    np.testing.assert_array_equal(bscal.numpy(), want_bscal)
    np.testing.assert_array_equal(blt2.numpy(), np.asarray(blt))
    np.testing.assert_array_equal(linv.numpy(), blinv)
    np.testing.assert_array_equal(bpar2.numpy(), bpar)


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=8,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")


@pytest.mark.parametrize("product", ["asian", "barrier"])
def test_engine_greeks_match_mctpu(product):
    bk = jtypes.BasketOption.equicorrelated(3, 0.3)
    if product == "asian":
        opt = jtypes.BasketAsianOption(bk, n_obs=4)
        jfn, tfn = jengine.greeks_basket_asian, mctpu_torch.greeks_basket_asian
    else:
        opt = jtypes.BasketBarrierOption(bk, 106.0, n_obs=5)
        jfn, tfn = (jengine.greeks_basket_barrier,
                    mctpu_torch.greeks_basket_barrier)
    n = 1 << 13
    want = jfn(opt, n, KEY, JCFG)
    got = tfn(from_reference(opt), n, SEED, TCFG)
    assert isinstance(got, GreeksResult)
    assert got.theta is None and got.gamma is None
    for f in ("price", "rho", "delta", "vega"):
        r, w = getattr(got, f), getattr(want, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        pairs = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                          for x in (r.sum_p, r.sum_p2)], 1)
        wpairs = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                           for x in (w.sum_p, w.sum_p2)], 1)
        assert pairs.shape == wpairs.shape == ((3, 2) if f in ("delta",
                                                               "vega")
                                               else (1, 2))
        assert_pairs_close(pairs.reshape(1, -1), wpairs.reshape(1, -1),
                           w.n, 1e-5)


@pytest.mark.parametrize("product", ["asian", "barrier"])
def test_greeks_price_equals_pricer(product):
    """The Greek walk's payoffs are the pricer's, path by path, and the plain
    versions sum them alike: the prices are equal (at n_obs = 16 the
    Asian's acc * (1/n) is acc / n exactly)."""
    bk = BasketOption.equicorrelated(3, 0.3)
    n = 1 << 12
    if product == "asian":
        opt = BasketAsianOption(bk, n_obs=16)
        g = mctpu_torch.greeks(opt, n, SEED, TCFG)
        p = mctpu_torch.price_basket_asian(opt, n, SEED, TCFG)
    else:
        opt = BasketBarrierOption(bk, 110.0, n_obs=9, kind="up-and-out")
        g = mctpu_torch.greeks(opt, n, SEED, TCFG)
        p = mctpu_torch.price_basket_barrier(opt, n, SEED, TCFG)
    assert float(g.price.price) == float(p.price)
    assert g.delta.price.shape == g.vega.price.shape == (3,)
    assert bool(torch.isfinite(g.delta.price).all())


@pytest.mark.parametrize("kernel", ["K32", "K34"])
def test_block_offset_relabels_streams(kernel):
    tb = BasketOption.equicorrelated(3, 0.3)
    chol = tmath.cholesky_lower(tb.corr)
    plan = tmw.make_plan(4 * ROWS * 128, 4, ROWS, False)
    if kernel == "K32":
        ops, fn = tmw.am_greek_ops(tb, chol, 5), tmw.am_greek_partials
        extra = ()
    else:
        ops = tmw.am_bar_greek_ops(tb, chol, 5, 104.0)
        fn, extra = tmw.am_bar_greek_partials, (True,)
    full = fn(*ops, 9, 0, plan, 4, 5, *extra)
    tail = fn(*ops, 9, 2, plan, 2, 5, *extra)
    for x, y in zip(full, tail):
        assert torch.equal(x[2:], y)


def test_rank_deficient_correlation_raises():
    """``default_reference(3)``'s +-0.5 matrix is singular: no L^-1 shift
    exists, so the LR Greeks refuse it, as ``mctpu``'s do."""
    bk = jtypes.BasketOption.default_reference(3)
    opt = jtypes.BasketBarrierOption(bk, 130.0, n_obs=5)
    with pytest.raises(ValueError, match="rank-deficient"):
        jengine.greeks_basket_barrier(opt, 1 << 10, KEY, JCFG)
    with pytest.raises(ValueError, match="rank-deficient"):
        mctpu_torch.greeks_basket_barrier(from_reference(opt), 1 << 10, SEED,
                                          TCFG)


@pytest.mark.parametrize("product", ["barrier"])
def test_wide_basket_greeks_are_not_ported_yet(product):
    """The packed basket-barrier Greeks (K35) run beyond 8 assets through
    the ``greeks`` dispatcher: per-asset delta and vega vectors, scalar
    rho, no theta or gamma."""
    bk = BasketOption.equicorrelated(16, 0.3)
    opt = BasketBarrierOption(bk, 120.0, n_obs=4)
    g = mctpu_torch.greeks(opt, 1 << 10, SEED, TCFG)
    assert isinstance(g, GreeksResult)
    assert g.delta.price.shape == g.vega.price.shape == (16,)
    assert g.theta is None and g.gamma is None
    assert bool(torch.isfinite(g.delta.price).all())


# K33: the packed basket-Asian Greeks (a > 8).
PACKED = {
    # name: (assets, n_obs, antithetic, kahan, iters)
    "K33_a9_n3": (9, 3, False, True, 1),
    "K33_a16_n4_antithetic_f32_2iters": (16, 4, True, False, 2),
    "K33_a16_n3_antithetic": (16, 3, True, True, 1),
    # a_tile 32 (the register kernel's second instance) and past it.
    "K33_a17_n3": (17, 3, False, True, 1),
    "K33_a32_n2_antithetic": (32, 2, True, True, 1),
    "K33_a33_n2": (33, 2, False, True, 1),
}


@pytest.mark.parametrize("case", sorted(PACKED))
def test_packed_greek_partials_match_interpret_mode(case):
    """K33's ``(B, 4)`` scalars and ``(B, 4, width)`` lane rows (every
    packed group, padded lanes exactly 0) against the interpret-mode
    kernel, by the scaled pair bound."""
    a, n_obs, antithetic, kahan, iters = PACKED[case]
    bk = jtypes.BasketOption.equicorrelated(a, 0.3)
    probe = jmw.make_plan(1, NB, ROWS, antithetic, n_assets=a)
    paths = NB * iters * probe.paths_per_iter
    jplan = jmw.make_plan(paths, NB, ROWS, antithetic, kahan=kahan,
                          n_assets=a)
    tplan = tmw.make_plan(paths, NB, ROWS, antithetic, kahan, n_assets=a)
    assert (tplan.iters, tplan.units_per_iter) == (jplan.iters,
                                                   jplan.units_per_iter)
    ws, wv = jmw.greek_pallas_partials(bk, _chol64(bk), SEED, 1, jplan, NB,
                                       n_obs=n_obs, interpret=True)
    tb = from_reference(bk)
    gs, gv = tmw.am_greek_partials(
        *tmw.packed_greek_ops(tb, tmath.cholesky_lower(tb.corr), n_obs),
        SEED, 1, tplan, NB, n_obs)
    a_tile, _, width = tmw.pack_factor(a)
    wv = np.asarray(wv)
    assert gs.shape == (NB, 4) and gv.shape == wv.shape == (NB, 4, width)
    pad = gv.view(NB, 4, -1, a_tile)[..., a:]
    assert bool((pad == 0).all())
    assert_pairs_close(_pairs(gs, gv), _pairs(ws, wv),
                       tplan.iters * tplan.units_per_iter, RTOL)


@pytest.mark.parametrize("a", [9, 16, 100])
@pytest.mark.parametrize("n_obs", [12, 50])
def test_packed_greek_ops_match_greek_step_ops(a, n_obs):
    """K33's table equals the real lanes of ``greek_step_ops``' rows and
    scalars as ``mctpu``'s source forms them (eagerly), bit for bit."""
    bk = jtypes.BasketOption.equicorrelated(a, 0.3)
    ch = _chol64(bk)
    with jax.enable_x64(False):
        o = bk.astype(jnp.float32)
        ops = jmw.greek_step_ops(o, ch, jnp.float32, n_obs)
        want_par = np.stack(
            [np.asarray(ops[name])[0, :a] for name in
             ("log_s0", "drift", "vol", "d", "w_row", "vdt", "inv_s0")])
        want_scal = np.concatenate([
            np.array([o.k, o.t, np.float32(1.0 / n_obs), ops["sqdt"]],
                     np.float32), np.asarray(ops["tj"])])
        want_lt = np.asarray(ops["chol_bd"])[:a, :a].T
    tb = from_reference(bk)
    scal, lt, par = tmw.packed_greek_ops(tb, tmath.cholesky_lower(tb.corr),
                                         n_obs)
    np.testing.assert_array_equal(scal.numpy(), want_scal)
    np.testing.assert_array_equal(lt.numpy(), want_lt)
    np.testing.assert_array_equal(par.numpy(), want_par)


def test_wide_basket_asian_greeks_match_mctpu():
    """``greeks_basket_asian`` beyond 8 assets (K33) against ``mctpu``'s on
    interpret-mode Pallas: the blocks' float64 tree, then the tree over
    the ``c`` packed groups, then the first ``a`` lanes."""
    bk = jtypes.BasketOption.equicorrelated(16, 0.3)
    opt = jtypes.BasketAsianOption(bk, n_obs=4)
    n = 1 << 13
    want = jengine.greeks_basket_asian(opt, n, KEY, JCFG)
    got = mctpu_torch.greeks(from_reference(opt), n, SEED, TCFG)
    assert isinstance(got, GreeksResult)
    assert got.theta is None and got.gamma is None
    for f in ("price", "rho", "delta", "vega"):
        r, w = getattr(got, f), getattr(want, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        pairs = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                          for x in (r.sum_p, r.sum_p2)], 1)
        wpairs = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                           for x in (w.sum_p, w.sum_p2)], 1)
        assert pairs.shape == wpairs.shape == ((16, 2) if f in ("delta",
                                                                "vega")
                                               else (1, 2))
        assert_pairs_close(pairs.reshape(1, -1), wpairs.reshape(1, -1),
                           w.n, 1e-5)


@pytest.mark.parametrize("antithetic", [False, True])
def test_wide_basket_asian_greeks_price_equals_pricer(antithetic):
    """K33's walk is K31's, path by path, and its plain version sums the
    payoffs alike: at n_obs = 16 (acc * (1/n) is acc / n) the prices are
    equal."""
    opt = BasketAsianOption(BasketOption.equicorrelated(16, 0.3), n_obs=16)
    cfg = dataclasses.replace(TCFG, antithetic=antithetic)
    g = mctpu_torch.greeks_basket_asian(opt, 1 << 12, SEED, cfg)
    p = mctpu_torch.price_basket_asian(opt, 1 << 12, SEED, cfg)
    assert float(g.price.price) == float(p.price)
    assert g.delta.price.shape == g.vega.price.shape == (16,)
    assert bool(torch.isfinite(g.vega.price).all())


def test_am_greek_wrappers_refuse_wide_operands():
    tb = BasketOption.equicorrelated(9, 0.3)
    chol = tmath.cholesky_lower(tb.corr)
    plan = tmw.make_plan(ROWS * 128, 1, ROWS, False)
    with pytest.raises(ValueError, match="1..8"):
        tmw.am_greek_partials(*tmw.am_greek_ops(tb, chol, 3), SEED, 0, plan,
                              1, 3)
    with pytest.raises(ValueError, match="1..8"):
        tmw.am_bar_greek_partials(*tmw.am_bar_greek_ops(tb, chol, 3, 120.0),
                                  SEED, 0, plan, 1, 3, True)


def test_greek_entry_points_validate():
    bk = BasketOption.equicorrelated(3, 0.3)
    with pytest.raises(ValueError, match="already knocked out"):
        mctpu_torch.greeks_basket_barrier(
            BasketBarrierOption(bk, 95.0, n_obs=4), 1 << 10, SEED, TCFG)
    with pytest.raises(ValueError, match="n_obs"):
        mctpu_torch.greeks_basket_asian(BasketAsianOption(bk, n_obs=0),
                                        1 << 10, SEED, TCFG)


# K35: the packed basket-barrier LR Greeks (a > 8).
PACKED_BAR = {
    # name: (assets, n_obs, up, barrier, antithetic, kahan, iters)
    "K35_a9_up_n3": (9, 3, True, 104.0, False, True, 1),
    "K35_a16_down_n4_antithetic_f32_2iters": (16, 4, False, 97.0, True,
                                              False, 2),
}


@pytest.mark.parametrize("case", sorted(PACKED_BAR))
def test_packed_bar_greek_partials_match_interpret_mode(case):
    """K35's ``(B, 4)`` scalars and ``(B, 4, width)`` lane rows against the
    interpret-mode kernel by the scaled pair bound; the padded lanes are
    exactly 0 (``q`` vanishes there and ``inv_v = cd = 0``).  ``mctpu``'s
    K35 price sums equal its packed pricer's (K31) bit for bit on these
    plans, and so do the port's plain versions'."""
    a, n_obs, up, h, antithetic, kahan, iters = PACKED_BAR[case]
    bk = jtypes.BasketOption.equicorrelated(a, 0.3)
    probe = jmw.make_plan(1, NB, ROWS, antithetic, n_assets=a)
    paths = NB * iters * probe.paths_per_iter
    jplan = jmw.make_plan(paths, NB, ROWS, antithetic, kahan=kahan,
                          n_assets=a)
    tplan = tmw.make_plan(paths, NB, ROWS, antithetic, kahan, n_assets=a)
    ch = _chol64(bk)
    ws, wv = jmw.bar_greek_pallas_partials(bk, ch, SEED, 1, jplan, NB,
                                           n_obs=n_obs, barrier=h, up=up,
                                           interpret=True)
    wp = jmw.pallas_partials(bk, ch, SEED, 1, jplan, NB, product="barrier",
                             n_obs=n_obs, barrier=h, up=up, interpret=True)
    tb = from_reference(bk)
    chol = tmath.cholesky_lower(tb.corr)
    gs, gv = tmw.bar_greek_partials(
        *tmw.packed_bar_greek_ops(tb, chol, n_obs, h), SEED, 1, tplan, NB,
        n_obs, up)
    a_tile, _, width = tmw.pack_factor(a)
    wv = np.asarray(wv)
    assert gs.shape == (NB, 4) and gv.shape == wv.shape == (NB, 4, width)
    assert bool((gv.view(NB, 4, -1, a_tile)[..., a:] == 0).all())
    assert_pairs_close(_pairs(gs, gv), _pairs(ws, wv),
                       tplan.iters * tplan.units_per_iter, RTOL)
    np.testing.assert_array_equal(np.asarray(ws)[:, :2], np.asarray(wp))
    lt, par = tmw.walk_ops(tb, chol, n_obs)
    tp = tmw.plain_partials(lt, par, tmw.scalars(tb, h), SEED, 1, tplan, NB,
                            "barrier", n_obs, up)
    assert torch.equal(gs[:, :2], tp)


@pytest.mark.parametrize("a", [9, 16])
@pytest.mark.parametrize("n_obs", [12, 50])
def test_packed_bar_greek_ops_match_barrier_greek_ops(a, n_obs):
    """K35's tables equal the real lanes of ``barrier_greek_ops``' rows
    (``linvT_bd``'s block is ``L^-1`` itself) as ``mctpu``'s source forms
    them (eagerly), bit for bit."""
    bk = jtypes.BasketOption.equicorrelated(a, 0.3)
    ch = _chol64(bk)
    with jax.enable_x64(False):
        o = bk.astype(jnp.float32)
        ops = jmw.barrier_greek_ops(o, ch, jnp.float32, n_obs)
        want_par = np.stack(
            [np.asarray(ops[name])[0, :a] for name in
             ("log_s0", "drift", "vol", "d", "w_row", "inv_v", "cd_row",
              "sr_row")])
        want_scal = np.array([o.k, o.t, 125.0, ops["sqdt"]], np.float32)
        want_lt = np.asarray(ops["chol_bd"])[:a, :a].T
        want_linv = np.asarray(ops["linvT_bd"])[:a, :a]
    tb = from_reference(bk)
    scal, lt, linv, par = tmw.packed_bar_greek_ops(
        tb, tmath.cholesky_lower(tb.corr), n_obs, 125.0)
    np.testing.assert_array_equal(scal.numpy(), want_scal)
    np.testing.assert_array_equal(lt.numpy(), want_lt)
    np.testing.assert_array_equal(linv.numpy(), want_linv)
    np.testing.assert_array_equal(par.numpy(), want_par)


def test_wide_basket_barrier_greeks_match_mctpu():
    """``greeks_basket_barrier`` beyond 8 assets (K35) against ``mctpu``'s
    on interpret-mode Pallas, folded as the basket-Asian's."""
    bk = jtypes.BasketOption.equicorrelated(9, 0.3)
    opt = jtypes.BasketBarrierOption(bk, 108.0, n_obs=3)
    n = 1 << 12
    want = jengine.greeks_basket_barrier(opt, n, KEY, JCFG)
    got = mctpu_torch.greeks(from_reference(opt), n, SEED, TCFG)
    for f in ("price", "rho", "delta", "vega"):
        r, w = getattr(got, f), getattr(want, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        pairs = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                          for x in (r.sum_p, r.sum_p2)], 1)
        wpairs = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                           for x in (w.sum_p, w.sum_p2)], 1)
        assert pairs.shape == wpairs.shape == ((9, 2) if f in ("delta",
                                                               "vega")
                                               else (1, 2))
        assert_pairs_close(pairs.reshape(1, -1), wpairs.reshape(1, -1),
                           w.n, 1e-5)


@pytest.mark.parametrize("antithetic", [False, True])
def test_wide_basket_barrier_greeks_price_equals_pricer(antithetic):
    """K35's walk is K31's, path by path, and the plain versions sum the
    payoffs alike: the prices are equal bit for bit."""
    opt = BasketBarrierOption(BasketOption.equicorrelated(16, 0.3), 112.0,
                              n_obs=5)
    cfg = dataclasses.replace(TCFG, antithetic=antithetic)
    g = mctpu_torch.greeks_basket_barrier(opt, 1 << 12, SEED, cfg)
    p = mctpu_torch.price_basket_barrier(opt, 1 << 12, SEED, cfg)
    assert float(g.price.price) == float(p.price)
    assert g.delta.price.shape == g.vega.price.shape == (16,)


def test_packed_bar_block_offset_relabels_streams():
    tb = BasketOption.equicorrelated(9, 0.3)
    ops = tmw.packed_bar_greek_ops(tb, tmath.cholesky_lower(tb.corr), 3,
                                   104.0)
    plan = tmw.make_plan(4 * ROWS * 8, 4, ROWS, False, n_assets=9)
    full = tmw.bar_greek_partials(*ops, 9, 0, plan, 4, 3, True)
    tail = tmw.bar_greek_partials(*ops, 9, 2, plan, 2, 3, True)
    for x, y in zip(full, tail):
        assert torch.equal(x[2:], y)


@pytest.mark.parametrize("a", [9, 16])
def test_packed_bar_mirror_scores_are_negations(a):
    """The mirror's scores q are -q exactly, so under round-to-nearest its
    first-date score qd and score sum acc_q are the plain sign's negated
    (the register design of K35 keeps neither); its acc_v is not."""
    from mctpu_torch.kernels.common import iter_keys, tile_index
    tb = BasketOption.equicorrelated(a, 0.3)
    scal, lt, linv, par = tmw.packed_bar_greek_ops(
        tb, tmath.cholesky_lower(tb.corr), 7, 104.0)
    width = tmw.pack_factor(a)[2]
    shape = (NB, ROWS * width)
    key = iter_keys(SEED, 0, 1, 0, NB, torch.device("cpu"))
    idx = tile_index(shape[1], torch.device("cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plus, minus = (tmw.packed_bar_greek_state(
            scal, lt, linv, par, 7, True, key, idx, shape, sgn)
            for sgn in (1.0, -1.0))
    finally:
        torch.set_num_threads(threads)
    _, qd, acc_q, acc_v, _, _ = plus
    _, qd_m, acc_q_m, acc_v_m, _, _ = minus
    assert bool((qd != 0).all()) and bool((acc_q != 0).all())
    assert torch.equal(qd_m, -qd)
    assert torch.equal(acc_q_m, -acc_q)
    assert not torch.equal(acc_v_m, -acc_v)


@pytest.mark.parametrize("cap", [0, 1, 1 << 20])
def test_am_bar_greek_partials_scratch_cap_runs_plain_on_cpu(cap):
    """On the CPU, K34's wrapper runs the plain version whatever the
    scratch cap of its split walk (a CUDA-only argument)."""
    tb = BasketOption.equicorrelated(3, 0.3)
    ops = tmw.am_bar_greek_ops(tb, tmath.cholesky_lower(tb.corr), 5, 104.0)
    plan = tmw.make_plan(NB * 2 * ROWS * 128 * 2, NB, ROWS, True, n_assets=3)
    assert plan.iters == 2
    got = tmw.am_bar_greek_partials(*ops, SEED, 1, plan, NB, 5, True,
                                    scratch_cap=cap)
    want = tmw.am_bar_greek_plain_partials(*ops, SEED, 1, plan, NB, 5, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("a", [1, 3, 8])
def test_am_bar_mirror_scores_are_negations(a):
    """K34's split walk takes the mirror's scores q_m = sum_{j >= m}
    Linv[j, m] (-z_j) as -q_m: in the plain version's order each product
    and sum of -z rounds to the negation of the plus sign's (torch.equal
    leaves a zero's sign aside, which no output reads but as a zero)."""
    tb = BasketOption.equicorrelated(a, 0.3)
    linv = tmw.am_bar_greek_ops(tb, tmath.cholesky_lower(tb.corr), 7,
                                104.0)[2]
    z = torch.from_numpy(np.random.default_rng(a).standard_normal(
        (a, 4096)).astype(np.float32))

    def scores(zs):
        out = []
        for m in range(a):
            q = linv[m, m] * zs[m]
            for jj in range(m + 1, a):
                q = q + linv[jj, m] * zs[jj]
            out.append(q)
        return torch.stack(out)

    plus = scores(z)
    assert bool((plus != 0).all())
    assert torch.equal(scores(-z), -plus)
