"""The netting-set CVA Greeks of the port against mctpu (CPU): K42's and
K41's plain versions against the JAX kernels in interpret mode,
``greeks_cva_multi`` against ``mctpu.engine.greeks_cva_multi`` on
interpret-mode Pallas (asset-major and packed), the CVA it shares with the
pricer, and what the entry points refuse.

The ``(B, 4)`` (cva, credit delta) and ``(B, 4, m)`` per-underlying
``(sum x, sum x^2)`` pairs are held by the scaled bound of
``tests/torch_tolerance.py`` at ``rtol=2e-5``: a mixed-sign set's deltas
and vegas are sums of terms of both signs.  ``mctpu`` writes the
per-underlying sums into lanes ``0..m-1`` of ``(B, 4, 128)`` rows; the
lanes past ``m`` must be zero.  Each interpret-mode call runs once: 2
blocks of ``rows=8``.
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
from mctpu.kernels import cva_multi as jcm
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import cva_multi as tcm
from mctpu_torch.types import CvaGreeksResult, CvaMultiSpec, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(53)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8

# The JAX Greeks CLI's netting set (``--product cva-multi``): corr 0.3 +
# 0.7 I, s = 100 (1 - 0.05 i), v = 0.2 (1 + 0.25 i), k = 100, w = 1.
def _cli(m: int, g: int):
    i = np.arange(m)
    return jtypes.CvaMultiSpec(
        intensity=0.03, lgd=0.6, s=100.0 * (1.0 - 0.05 * i),
        v=0.2 * (1.0 + 0.25 * i), corr=np.full((m, m), 0.3) + 0.7 * np.eye(m),
        r=0.04879, t=1.0, strikes=np.full(m, 100.0), weights=np.ones(m),
        n_grid=g)


MIXED = jtypes.CvaMultiSpec(
    intensity=0.03, lgd=0.6, s=np.array([100.0, 95.0]),
    v=np.array([0.2, 0.3]), corr=np.array([[1.0, 0.5], [0.5, 1.0]]),
    r=0.05, t=1.0, strikes=np.array([100.0, 90.0]),
    weights=np.array([1.0, -0.6]), n_grid=5)


def _chol64(spec):
    with jax.enable_x64(True):
        return np.asarray(jmath.cholesky_lower(jnp.asarray(spec.corr,
                                                           jnp.float64)))


def _ops(spec):
    ts = from_reference(spec)
    return tcm.operands(ts, tmath.cholesky_lower(ts.corr), "cpu")


def _pairs(scal, vec):
    scal, vec = np.asarray(scal), np.asarray(vec)
    return np.concatenate([scal] + [vec[:, :, i] for i in
                                    range(vec.shape[2])], axis=1)


CASES = {
    # name: (spec, antithetic, kahan, iters)
    "K42_m3_cli_g3": (_cli(3, 3), False, True, 1),
    "K42_m2_mixed_g5": (MIXED, False, True, 1),
    "K42_m1_g2_antithetic_f32_2iters": (_cli(1, 2), True, False, 2),
}


def _plans(m, antithetic, kahan, iters):
    probe = jcm.make_plan(1, NB, ROWS, antithetic, n_underlyings=m)
    paths = NB * iters * probe.paths_per_iter
    return (jcm.make_plan(paths, NB, ROWS, antithetic, kahan=kahan,
                          n_underlyings=m),
            tcm.make_plan(paths, NB, ROWS, antithetic, kahan,
                          n_underlyings=m))


@pytest.mark.parametrize("case", sorted(CASES))
def test_greek_partials_match_interpret_mode(case):
    """K42's pairs against the interpret-mode kernel by the scaled bound.
    ``mctpu``'s own K40 and K42 sum their CVA tiles through different
    accumulators (``_accum_add`` of chunk sums, ``acc_add_n``), yet on these
    plans their price pairs agree bit for bit; so K42's CVA pair equals the
    port's K40 plain version's bit for bit too."""
    spec, antithetic, kahan, iters = CASES[case]
    m = spec.n_underlyings
    jplan, tplan = _plans(m, antithetic, kahan, iters)
    ch = _chol64(spec)
    ws, wv = jcm.greek_pallas_partials(spec, ch, SEED, 1, jplan, NB,
                                       interpret=True)
    wp, _ = jcm.pallas_partials(spec, ch, SEED, 1, jplan, NB,
                                interpret=True)
    ops = _ops(spec)
    gs, gv = tcm.greek_partials(ops, SEED, 1, tplan, NB)
    wv = np.asarray(wv)
    assert wv.shape == (NB, 4, 128) and (wv[:, :, m:] == 0).all()
    assert gs.shape == (NB, 4) and gv.shape == (NB, 4, m)
    assert_pairs_close(_pairs(gs, gv), _pairs(ws, wv[:, :, :m]),
                       tplan.iters * tplan.units_per_iter, RTOL)
    np.testing.assert_array_equal(np.asarray(ws)[:, :2], np.asarray(wp))
    tp, _ = tcm.partials(ops, SEED, 1, tplan, NB)
    assert torch.equal(gs[:, :2], tp)


def test_packed_greek_partials_match_interpret_mode():
    """K41 (9 underlyings, packed) against the interpret-mode kernel: the
    ``(B, 4)`` pairs and the ``(B, 4, width)`` lane rows (padded lanes
    exactly 0 in both) by the scaled bound.  K41 prices each leg in K42's
    ``x - log k`` form and K39 in ``log(s / k)``'s, so on one stream their
    CVA pairs agree to float32 rounding (rtol 1e-5), not bit for bit."""
    spec = _cli(9, 3)
    m = spec.n_underlyings
    jplan, tplan = _plans(m, False, True, 1)
    ws, wv = jcm.greek_pallas_partials(spec, _chol64(spec), SEED, 1, jplan,
                                       NB, interpret=True)
    ts = from_reference(spec)
    ops = tcm.operands(ts, tmath.cholesky_lower(ts.corr), "cpu",
                       greeks=True)
    gs, gv = tcm.greek_partials(ops, SEED, 1, tplan, NB)
    a_tile, c, width = tcm.pack_factor(m)
    assert gs.shape == (NB, 4) and gv.shape == (NB, 4, width)
    pad = gv.reshape(NB, 4, c, a_tile)[..., m:]
    assert (pad == 0).all()
    wv = np.asarray(wv)
    assert (wv.reshape(NB, 4, c, a_tile)[..., m:] == 0).all()
    assert_pairs_close(_pairs(gs, gv), _pairs(ws, wv),
                       tplan.iters * tplan.units_per_iter, RTOL)
    price, _ = tcm.partials(_ops(spec), SEED, 1, tplan, NB)
    np.testing.assert_allclose(gs[:, :2].numpy(), price.numpy(), rtol=1e-5)


def test_packed_greek_partials_16_antithetic_match_interpret_mode():
    """K41 at 16 underlyings (the widest set of its a_tile-16 register
    instance, so no lane of a path is padding; the 9-underlying case above
    holds the padded lanes at 0) under antithetic against the
    interpret-mode kernel: the ``(B, 4)`` pairs and the ``(B, 4, width)``
    lane rows by the scaled bound."""
    spec = _cli(16, 3)
    m = spec.n_underlyings
    jplan, tplan = _plans(m, True, True, 1)
    ws, wv = jcm.greek_pallas_partials(spec, _chol64(spec), SEED, 1, jplan,
                                       NB, interpret=True)
    ts = from_reference(spec)
    ops = tcm.operands(ts, tmath.cholesky_lower(ts.corr), "cpu",
                       greeks=True)
    gs, gv = tcm.greek_partials(ops, SEED, 1, tplan, NB)
    a_tile, c, width = tcm.pack_factor(m)
    assert (a_tile, c, width) == (16, 8, 128)
    assert gs.shape == (NB, 4) and gv.shape == (NB, 4, width)
    wv = np.asarray(wv)
    assert wv.shape == (NB, 4, width)
    assert_pairs_close(_pairs(gs, gv), _pairs(ws, wv),
                       tplan.iters * tplan.units_per_iter, RTOL)


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=8,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")


@pytest.mark.parametrize("which", ["cli", "mixed", "wide"])
def test_engine_greeks_match_mctpu(which):
    """``greeks_cva_multi`` on the same streams as ``mctpu``'s: every
    output's ``(sum x, sum x^2)`` by the scaled bound, the delta rows after
    the float64 pairwise fold of K41's packed lane rows (9 underlyings) and
    the ``1 / s0`` and ``1 / s0^2``; no second-order outputs."""
    spec = {"cli": _cli(2, 3), "mixed": MIXED, "wide": _cli(9, 2)}[which]
    n = 1 << 12
    want = jengine.greeks_cva_multi(spec, n, KEY, JCFG)
    got = mctpu_torch.greeks(from_reference(spec), n, SEED, TCFG)
    assert isinstance(got, CvaGreeksResult)
    assert got.gamma is None and got.credit_gamma is None
    m = spec.n_underlyings
    for f in ("cva", "credit_delta", "delta", "vega"):
        r, w = getattr(got, f), getattr(want, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        pairs = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                          for x in (r.sum_p, r.sum_p2)], 1)
        wpairs = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                           for x in (w.sum_p, w.sum_p2)], 1)
        assert pairs.shape == wpairs.shape == ((m, 2) if f in ("delta",
                                                               "vega")
                                               else (1, 2))
        assert_pairs_close(pairs.reshape(1, -1), wpairs.reshape(1, -1),
                           w.n, 1e-5)


@pytest.mark.parametrize("antithetic", [False, True])
def test_greeks_cva_equals_pricer(antithetic):
    """K42's walk is K40's, path by path, and the plain versions sum the
    CVA alike: ``greeks_cva_multi``'s CVA is ``price_cva_multi``'s."""
    spec = from_reference(_cli(3, 7))
    cfg = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu",
                               antithetic=antithetic)
    g = mctpu_torch.greeks_cva_multi(spec, 1 << 12, SEED, cfg)
    p = mctpu_torch.price_cva_multi(spec, 1 << 12, SEED, cfg)
    assert float(g.cva.price) == float(p.cva)
    assert g.delta.price.shape == g.vega.price.shape == (3,)
    assert bool(torch.isfinite(g.vega.price).all())


def test_wide_sets_are_refused():
    """More than 8 underlyings run K41: the engine and the dispatcher give
    the 9-underlying delta and vega vectors (finite, the CVA within
    float32 rounding of the pricer's), and the Greek wrapper refuses the
    pricer's packed operands, whose rows K41 does not read."""
    spec = from_reference(_cli(9, 3))
    g = mctpu_torch.greeks_cva_multi(spec, 1 << 11, SEED, TCFG)
    assert isinstance(mctpu_torch.greeks(spec, 1 << 11, SEED, TCFG),
                      CvaGreeksResult)
    for r in (g.delta, g.vega):
        assert r.price.shape == r.std_error.shape == (9,)
        assert bool(torch.isfinite(r.price).all())
    assert bool((g.delta.price > 0).all()) and bool((g.vega.price > 0).all())
    p = mctpu_torch.price_cva_multi(spec, 1 << 11, SEED, TCFG)
    np.testing.assert_allclose(float(g.cva.price), float(p.cva), rtol=1e-5)
    plan = tcm.make_plan(ROWS * 8, 1, ROWS, False, n_underlyings=9)
    with pytest.raises(ValueError, match="greeks=True"):
        tcm.greek_partials(_ops(_cli(9, 3)), SEED, 0, plan, 1)


def test_block_offset_relabels_streams():
    ops = _ops(_cli(3, 4))
    plan = tcm.make_plan(4 * ROWS * 128, 4, ROWS, False, n_underlyings=3)
    full = tcm.greek_partials(ops, 9, 0, plan, 4)
    tail = tcm.greek_partials(ops, 9, 2, plan, 2)
    for x, y in zip(full, tail):
        assert torch.equal(x[2:], y)


def test_entry_points_validate():
    bad = CvaMultiSpec(0.03, 1.5, np.full(2, 100.0), np.full(2, 0.2),
                       np.eye(2), 0.05, 1.0, np.full(2, 100.0), np.ones(2), 4)
    for fn in (mctpu_torch.price_cva_multi, mctpu_torch.greeks_cva_multi):
        with pytest.raises(ValueError, match="lgd"):
            fn(bad, 1 << 10, SEED, TCFG)
