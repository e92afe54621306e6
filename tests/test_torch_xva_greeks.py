"""The bilateral xVA Greeks of the port against mctpu (CPU): K44's plain
version against the JAX kernel in interpret mode, ``greeks_xva`` against
``mctpu.engine.greeks_xva`` on interpret-mode Pallas, and statistically
against autograd of the closed form (single-signed sets, also beyond 8
underlyings, where ``mctpu`` has no stream to match) and common-random-
number bumps of ``price_xva`` (the mixed-sign pair, at
``tests/test_xva.py``'s limits).

The ``(B, 14)`` leg and sensitivity pairs and the ``(B, 4, m)``
per-underlying pairs are held by the scaled bound of
``tests/torch_tolerance.py`` at ``rtol=2e-5`` (a mixed-sign set's deltas
and vegas are sums of terms of both signs), the four legs' pairs also at
plain ``rtol=2e-5``.  ``mctpu`` writes the per-underlying sums into lanes
``0..m-1`` of ``(B, 4, 128)`` rows; the lanes past ``m`` must be zero.
Each interpret-mode call runs once: 2 blocks of ``rows=8``.
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
from mctpu.kernels import cva_multi as jcm
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import cva_multi as tcm
from mctpu_torch.types import XvaGreeksResult, XvaSpec, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(61)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8


def _cli(m: int, g: int, mixed: bool = False):
    """The JAX Greeks CLI's xVA set (``--product xva``): correlation 0.3 +
    0.7 I, s = 100 (1 - 0.05 i), v = 0.2 (1 + 0.25 i), k = 100, w = 1, r =
    0.04879; own intensity 0.02, own lgd 0.5, spread 0.01.  ``mixed``:
    every odd leg short, w = -0.6."""
    i = np.arange(m)
    net = jtypes.CvaMultiSpec(
        intensity=0.03, lgd=0.6, s=100.0 * (1.0 - 0.05 * i),
        v=0.2 * (1.0 + 0.25 * i), corr=np.full((m, m), 0.3) + 0.7 * np.eye(m),
        r=0.04879, t=1.0, strikes=np.full(m, 100.0),
        weights=np.where(i % 2 == 1, -0.6, 1.0) if mixed else np.ones(m),
        n_grid=g)
    return jtypes.XvaSpec(net, own_intensity=0.02, own_lgd=0.5,
                          funding_spread=0.01)


def _mixed(g: int, w1: float = -0.6):
    """The mixed-sign pair (s 100/95, v 0.2/0.3, k 100/90, correlation 0.5,
    w 1/``w1``) with the CLI's bank side."""
    net = jtypes.CvaMultiSpec(
        intensity=0.03, lgd=0.6, s=np.array([100.0, 95.0]),
        v=np.array([0.2, 0.3]), corr=np.array([[1.0, 0.5], [0.5, 1.0]]),
        r=0.05, t=1.0, strikes=np.array([100.0, 90.0]),
        weights=np.array([1.0, w1]), n_grid=g)
    return jtypes.XvaSpec(net, own_intensity=0.02, own_lgd=0.5,
                          funding_spread=0.01)


def _chol64(spec):
    with jax.enable_x64(True):
        return np.asarray(jmath.cholesky_lower(jnp.asarray(spec.corr,
                                                           jnp.float64)))


def _ops(xspec):
    ts = from_reference(xspec)
    return tcm.xva_operands(ts, tmath.cholesky_lower(ts.netting.corr),
                            "cpu", greeks=True)


def _pairs(scal, vec):
    scal, vec = np.asarray(scal), np.asarray(vec)
    return np.concatenate([scal] + [vec[:, :, i] for i in
                                    range(vec.shape[2])], axis=1)


# mctpu's K44 (and its XLA twin) cannot run antithetic: its _xva_avg_tiles
# averages tuples only and meets the walk's lists of per-underlying tiles
# (mctpu/kernels/cva_multi.py:1413-1420).  The port averages the mirror as
# K42 does; its antithetic K44 is held against the plain version on the
# card and by the engine's statistical gates.
# Also the geometries the card's kernels dispatch on: one underlying, five
# (past am_threads' 512-thread instances), and two iterations a block.
CASES = {
    # name: (xspec, antithetic, kahan, iterations)
    "K44_m3_cli_g3": (_cli(3, 3), False, True, 1),
    "K44_m2_mixed_g4_f32": (_mixed(4), False, False, 1),
    "K44_m1_cli_g2": (_cli(1, 2), False, True, 1),
    "K44_m5_mixed_g2": (_cli(5, 2, mixed=True), False, True, 1),
    "K44_m3_cli_g2_iters2_f32": (_cli(3, 2), False, False, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greek_partials_match_interpret_mode(case):
    xspec, antithetic, kahan, iters = CASES[case]
    m = xspec.netting.n_underlyings
    probe = jcm.make_plan(1, NB, ROWS, antithetic, n_underlyings=m)
    paths = NB * probe.paths_per_iter * iters
    jplan = jcm.make_plan(paths, NB, ROWS, antithetic, kahan=kahan,
                          n_underlyings=m)
    tplan = tcm.make_plan(paths, NB, ROWS, antithetic, kahan,
                          n_underlyings=m)
    assert tplan.iters == jplan.iters == iters
    ws, wv = jcm.xva_greek_pallas_partials(xspec, _chol64(xspec.netting),
                                           SEED, 1, jplan, NB,
                                           interpret=True)
    gs, gv = tcm.xva_greek_partials(_ops(xspec), SEED, 1, tplan, NB)
    wv = np.asarray(wv)
    assert wv.shape == (NB, 4, 128) and (wv[:, :, m:] == 0).all()
    assert gs.shape == (NB, 14) and gv.shape == (NB, 4, m)
    np.testing.assert_allclose(gs[:, :8].numpy(), np.asarray(ws)[:, :8],
                               rtol=RTOL)
    assert_pairs_close(_pairs(gs, gv), _pairs(ws, wv[:, :, :m]),
                       tplan.iters * tplan.units_per_iter, RTOL)


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=8,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")


def test_engine_greeks_match_mctpu():
    """``greeks_xva`` on the mixed-sign pair, on the same streams as
    ``mctpu``'s: every output's ``(sum x, sum x^2)`` by the scaled bound,
    the delta rows after the float64 ``1 / s0`` and ``1 / s0^2``."""
    xspec = _mixed(4)
    n = 1 << 12
    want = jengine.greeks_xva(xspec, n, KEY, JCFG)
    got = mctpu_torch.greeks_xva(from_reference(xspec), n, SEED, TCFG)
    assert isinstance(got, XvaGreeksResult)
    for f in dataclasses.fields(got):
        r, w = getattr(got, f.name), getattr(want, f.name)
        assert (r.n, r.n_paths) == (int(w.n), int(w.n_paths))
        pairs, wpairs = (np.stack([np.atleast_1d(np.asarray(x, np.float64))
                                   for x in (y.sum_p, y.sum_p2)], 1)
                         for y in (r, w))
        assert pairs.shape == wpairs.shape
        assert_pairs_close(pairs.reshape(1, -1), wpairs.reshape(1, -1),
                           w.n, 1e-5)
    assert repr(got).startswith("XvaGreeksResult(cva=")
    assert set(got.to_dict()) == set(want.to_dict())


def _closed_grads(xspec):
    """The closed form's four legs and, by autograd, dCVA/dlambda_C,
    dDVA/dlambda_B, dFVA/dspread and the total XVA's gradient in the spots
    and the vols, in float64."""
    net = xspec.netting
    lam_c, lam_b, sf, s, v = (
        torch.tensor(np.asarray(x, np.float64), requires_grad=True)
        for x in (net.intensity, xspec.own_intensity, xspec.funding_spread,
                  net.s, net.v))
    cva, dva, fca, fba = tmath.xva_multi_closed_form(
        lam_c, net.lgd, lam_b, xspec.own_lgd, sf, s, v, net.strikes,
        net.weights, net.r, net.t, net.n_grid)

    def grad(y, x):
        (gx,) = torch.autograd.grad(y, x, retain_graph=True,
                                    allow_unused=True)
        return torch.zeros_like(x) if gx is None else gx

    total = cva - dva + fca - fba
    return ([float(x.detach()) for x in (cva, dva, fca, fba)],
            [float(grad(cva, lam_c)), float(grad(dva, lam_b)),
             float(grad(fca - fba, sf))],
            grad(total, s), grad(total, v))


@pytest.mark.parametrize("m, short", [(3, False), (3, True), (12, False)])
def test_single_signed_sets_match_autograd_of_closed_form(m, short):
    """Every output within 4 standard errors of the closed form and its
    autograd (the all-long and all-short CLI sets at 3 underlyings, and at
    12, past ``mctpu``'s Pallas kernel, on the runtime-m path); the side
    the set never reaches is 0 up to float32's subnormals (see
    ``tests/test_torch_xva.py``'s ``_zero``)."""
    xspec = _cli(m, 6)
    if short:
        xspec = dataclasses.replace(xspec, netting=dataclasses.replace(
            xspec.netting, weights=-np.ones(m)))
    ts = from_reference(xspec)
    res = mctpu_torch.greeks_xva(ts, 1 << 14, SEED, TCFG)
    legs, sens, dtot, vtot = _closed_grads(ts)
    outs = ([res.cva, res.dva, res.fca, res.fba],
            [res.credit_cpty, res.credit_own, res.funding])
    tiny = torch.finfo(torch.float32).tiny  # the Hastings legs' subnormals
    for got, want in zip((*outs[0], *outs[1]), (*legs, *sens)):
        if want == 0.0:
            assert abs(float(got.price)) < tiny
        else:
            assert abs(float(got.price) - want) < 4 * float(got.std_error)
    for got, want in ((res.delta, dtot), (res.vega, vtot)):
        assert got.price.shape == (m,)
        z = (got.price - want).abs() / got.std_error
        assert bool((z < 4).all()), z


def test_mixed_pair_matches_crn_bumps_of_price_xva():
    """The mixed-sign pair (w 1/-0.8, ``tests/test_xva.py``'s): the total
    XVA's delta and vega of the first underlying against central CRN bumps
    of ``price_xva`` at ``tests/test_xva.py``'s limits, 6 standard errors
    plus 2e-4 (delta, h = 0.25) and plus 5e-3 (vega, h = 0.005)."""
    xspec = from_reference(_mixed(12, w1=-0.8))
    n = 1 << 14
    res = mctpu_torch.greeks_xva(xspec, n, SEED, TCFG)

    def total(field, h):
        vals = np.asarray(getattr(xspec.netting, field), float).copy()
        vals[0] += h
        sp = dataclasses.replace(xspec, netting=dataclasses.replace(
            xspec.netting, **{field: vals}))
        r = mctpu_torch.price_xva(sp, n, SEED, TCFG)
        return (float(r.cva.price) - float(r.dva.price)
                + float(r.fca.price) - float(r.fba.price))

    for field, h, allow, got in (("s", 0.25, 2e-4, res.delta),
                                 ("v", 0.005, 5e-3, res.vega)):
        fd = (total(field, h) - total(field, -h)) / (2 * h)
        assert abs(float(got.price[0]) - fd) < 6 * float(
            got.std_error[0]) + allow, field


def test_block_offset_relabels_streams():
    ops = _ops(_cli(3, 4))
    plan = tcm.make_plan(4 * ROWS * 128, 4, ROWS, False, n_underlyings=3)
    full = tcm.xva_greek_partials(ops, 9, 0, plan, 4)
    tail = tcm.xva_greek_partials(ops, 9, 2, plan, 2)
    for x, y in zip(full, tail):
        assert torch.equal(x[2:], y)


def test_entry_points_validate_and_refuse_bad_operands():
    bad = from_reference(dataclasses.replace(_cli(2, 4), own_lgd=1.5))
    for fn in (mctpu_torch.price_xva, mctpu_torch.greeks_xva):
        with pytest.raises(ValueError, match="own_lgd"):
            fn(bad, 1 << 10, SEED, TCFG)
    ts = from_reference(_cli(3, 4))
    pops = tcm.xva_operands(ts, tmath.cholesky_lower(ts.netting.corr), "cpu")
    plan = tcm.make_plan(ROWS * 128, 1, ROWS, False, n_underlyings=3)
    with pytest.raises(ValueError, match="nodes"):
        tcm.xva_greek_partials(pops, SEED, 0, plan, 1)
    assert isinstance(ts, XvaSpec)
