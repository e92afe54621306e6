"""The bilateral xVA of the port against mctpu (CPU): K43's plain version
against the JAX kernel in interpret mode, its node tables against
``mctpu``'s table functions, the leg-weight math and the closed form against
``mctpu.math`` in float64, ``price_xva`` against ``mctpu.engine.price_xva``
on interpret-mode Pallas, the bitwise tie to the netting-set CVA pricer,
the wide sets (beyond ``mctpu``'s Pallas kernel) against the float64 oracle
and the closed form, and the records.

Both packages draw the same streams up to 8 underlyings, so the per-block
leg pairs and both exposure profiles agree at ``rtol=2e-5`` (the block
sums are taken in other orders).  Each interpret-mode call runs once, on 2
blocks of ``rows=8`` and at most 6 nodes.
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
from mctpu import reference as jref
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import cva_multi as jcm
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import cva_multi as tcm
from mctpu_torch.models.cva_multi import xva_oracle
from mctpu_torch.types import (CvaGreeksResult, CvaResult, McResult,
                               XvaResult, XvaSpec, from_reference)

RTOL = 2e-5
KEY = jax.random.key(77)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8


def _net(m: int, g: int, mixed: bool = False, short: bool = False):
    """The JAX exotic CLI's netting set (``--product xva``: correlation
    0.5, s = k = 100, v = 0.2, r = 0.05, w = 1/m, or -1/m with ``short``),
    or the mixed-sign pair of ``tests/test_cva_multi.py`` (s 100/95, v
    0.2/0.3, k 100/90, w 1/-0.6) alternated over the ``m`` underlyings."""
    corr = np.full((m, m), 0.5) + 0.5 * np.eye(m)
    if mixed:
        odd = np.arange(m) % 2 == 1
        pick = lambda a, b: np.where(odd, b, a)  # noqa: E731
        return jtypes.CvaMultiSpec(0.03, 0.6, pick(100.0, 95.0),
                                   pick(0.2, 0.3), corr, 0.05, 1.0,
                                   pick(100.0, 90.0), pick(1.0, -0.6), g)
    full = np.full(m, 100.0)
    w = np.full(m, (-1.0 if short else 1.0) / m)
    return jtypes.CvaMultiSpec(0.03, 0.6, full, np.full(m, 0.2), corr, 0.05,
                               1.0, full, w, g)


def _xspec(net, own=0.02, own_lgd=0.5, spread=0.01):
    """The CLI's bank side: own intensity 0.02, own lgd 0.5, spread 0.01."""
    return jtypes.XvaSpec(net, own_intensity=own, own_lgd=own_lgd,
                          funding_spread=spread)


def _chol64(spec):
    with jax.enable_x64(True):
        return np.asarray(jmath.cholesky_lower(jnp.asarray(spec.corr,
                                                           jnp.float64)))


def _ops(xspec, greeks=False):
    ts = from_reference(xspec)
    return tcm.xva_operands(ts, tmath.cholesky_lower(ts.netting.corr),
                            "cpu", greeks)


def _plans(m, antithetic, kahan, iters):
    probe = jcm.make_plan(1, NB, ROWS, antithetic, n_underlyings=m)
    paths = NB * iters * probe.paths_per_iter
    return (jcm.make_plan(paths, NB, ROWS, antithetic, kahan=kahan,
                          n_underlyings=m),
            tcm.make_plan(paths, NB, ROWS, antithetic, kahan,
                          n_underlyings=m))


CASES = {
    # name: (xspec, antithetic, kahan, iters)
    "K43_m3_cli_g4": (_xspec(_net(3, 4)), False, True, 1),
    "K43_m2_mixed_g5_antithetic_f32_2iters": (
        _xspec(_net(2, 5, mixed=True)), True, False, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case):
    """The (sum, sum^2) pairs of the four legs and both profiles at rtol
    2e-5; the all-long set's bank-side sums and ENE profile 0."""
    xspec, antithetic, kahan, iters = CASES[case]
    m, g = xspec.netting.n_underlyings, xspec.netting.n_grid
    jplan, tplan = _plans(m, antithetic, kahan, iters)
    want, wprof = jcm.xva_pallas_partials(xspec, _chol64(xspec.netting),
                                          SEED, 1, jplan, NB, interpret=True)
    got, gprof = tcm.xva_partials(_ops(xspec), SEED, 1, tplan, NB)
    assert got.shape == (NB, 8) and gprof.shape == (NB, 2, g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(gprof.numpy(), np.asarray(wprof), rtol=RTOL)
    if (xspec.netting.weights > 0).all():
        assert _zero(got[:, 2:4]) and _zero(got[:, 6:])
        assert _zero(gprof[:, 1])


def _zero(x) -> bool:
    """0 up to float32's subnormal range: a single-signed set never reaches
    the other exposure side, but a leg deep out of the money can price a
    hair below 0 under the Hastings CDF.  mctpu's XLA flushes such
    subnormals to 0; PyTorch and the kernels keep them."""
    return bool((torch.as_tensor(x).abs() < torch.finfo(torch.float32)
                 .tiny).all())


def _ulps(a, b) -> int:
    """The largest distance in float32 ulps between ``a`` and ``b``."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
              for x in (a, b))
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("g", [1, 50])
@pytest.mark.parametrize("own, spread", [(0.02, 0.01), (0.0, 0.0)])
def test_tables_match_mctpu(g, own, spread):
    """K43's and K44's node tables against ``mctpu``'s ``xva_tables`` and
    ``xva_greek_tables`` (eager, float32): tau and sqrt(tau) bit for bit;
    the exponentials are libm's here and XLA's there, so as for the
    netting-set tables (``tests/test_torch_cva_multi.py``) the leg weights
    (an exp times -expm1, or times sf dt) sit within 2 ulp, disc within 1
    ulp, the derivative tables (a sum of an exp and an expm1 term, at most
    2 ulp each, times the survival) within 4 ulp and their LGD-scaled rows
    within one more; at own_intensity = 0 the CVA table is the port's
    default_leg_weights bit for bit."""
    xspec = _xspec(_net(3, g), own=own, spread=spread)
    with jax.enable_x64(False):
        want = [np.asarray(x) for x in jcm.xva_tables(xspec, jnp.float32)]
        wantg = [np.asarray(x)
                 for x in jcm.xva_greek_tables(xspec, jnp.float32)]
    ts = from_reference(xspec)
    got = tcm.xva_tables(ts).numpy()
    gotg = tcm.xva_greek_tables(ts).numpy()
    assert got.shape == (6, g) and gotg.shape == (9, g)
    for k in (3, 4):
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(gotg[k + 3], wantg[k + 3])
    assert _ulps(got[5], want[5]) <= 1 and _ulps(gotg[8], wantg[8]) <= 1
    for k in range(3):
        assert _ulps(got[k], want[k]) <= 2, k
        assert _ulps(gotg[k], wantg[k]) <= 3, k
        assert _ulps(gotg[3 + k], wantg[3 + k]) <= 5, k
    if own == 0.0:
        np.testing.assert_array_equal(got[0], tmath.default_leg_weights(
            ts.netting.intensity, ts.netting.t, g, torch.float32).numpy())
        assert (got[1] == 0).all() and (got[2] == 0).all()


def test_math_matches_mctpu():
    """The leg weights, the funding weights and their derivative tables
    within 1e-14 of ``mctpu.math``'s in float64; the closed form within
    1e-12 and its autograd in every input within 1e-9 of ``jax.grad``;
    mixed-sign weights raise in both."""
    lam, own, sf, t, g = 0.03, 0.02, 0.01, 1.0, 12
    with jax.enable_x64(True):
        f64 = jnp.float64
        want = ([np.asarray(x) for x in jmath.xva_leg_weights(
            lam, own, t, g, dtype=f64)]
            + [np.asarray(jmath.funding_leg_weights(lam, own, sf, t, g,
                                                    dtype=f64))]
            + [np.asarray(x) for x in jmath.xva_leg_weight_derivs(
                lam, own, t, g, dtype=f64)])
    got = (list(tmath.xva_leg_weights(lam, own, t, g))
           + [tmath.funding_leg_weights(lam, own, sf, t, g)]
           + list(tmath.xva_leg_weight_derivs(lam, own, t, g)))
    for x, w in zip(got, want):
        assert x.dtype == torch.float64
        np.testing.assert_allclose(x.numpy(), w, rtol=1e-14, atol=0)

    net = _net(3, g)
    s, v, k, w = net.s * np.array([1.0, 0.97, 0.94]), net.v, net.strikes, \
        net.weights
    with jax.enable_x64(True):
        def jf(lam_c, lam_b, spread, s_, v_):
            legs = jmath.xva_multi_closed_form(
                lam_c, 0.6, lam_b, 0.5, spread, s_, v_, k, w, 0.05, t, g,
                dtype=jnp.float64)
            return legs[0] - legs[1] + legs[2] - legs[3]
        args = (jnp.float64(lam), jnp.float64(own), jnp.float64(sf),
                jnp.asarray(s), jnp.asarray(v))
        wlegs = [float(x) for x in jmath.xva_multi_closed_form(
            lam, 0.6, own, 0.5, sf, s, v, k, w, 0.05, t, g,
            dtype=jnp.float64)]
        wgrad = [np.asarray(x) for x in jax.grad(jf, argnums=range(5))(*args)]
    targs = [torch.tensor(np.asarray(x, np.float64), requires_grad=True)
             for x in (lam, own, sf, s, v)]
    legs = tmath.xva_multi_closed_form(targs[0], 0.6, targs[1], 0.5,
                                       targs[2], targs[3], targs[4], k, w,
                                       0.05, t, g)
    for x, want_leg in zip(legs, wlegs):
        assert abs(float(x.detach()) - want_leg) <= 1e-12 * max(
            abs(want_leg), 1e-300)
    (legs[0] - legs[1] + legs[2] - legs[3]).backward()
    for x, want_grad in zip(targs, wgrad):
        np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-9,
                                   atol=1e-12)
    mixed = np.array([1.0, -0.6, 1.0])
    for fn in (jmath.xva_multi_closed_form, tmath.xva_multi_closed_form):
        with pytest.raises(ValueError, match="single-signed"):
            fn(lam, 0.6, own, 0.5, sf, s, v, k, mixed, 0.05, t, g)


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=8,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")


def test_engine_matches_mctpu():
    """``price_xva`` on the mixed-sign pair, on the same streams as
    ``mctpu``'s: every leg's price and standard error at rtol 2e-5 (1e-4),
    both profiles at rtol 2e-5, the aggregates as ``mctpu`` forms them."""
    xspec = _xspec(_net(2, 6, mixed=True))
    n = 1 << 12
    want = jengine.price_xva(xspec, n, KEY, JCFG)
    got = mctpu_torch.price_xva(from_reference(xspec), n, SEED, TCFG)
    assert isinstance(got, XvaResult)
    for leg in ("cva", "dva", "fca", "fba"):
        r, w = getattr(got, leg), getattr(want, leg)
        assert (r.n, r.n_paths) == (int(w.n), int(w.n_paths))
        np.testing.assert_allclose(float(r.price), float(w.price), rtol=RTOL)
        np.testing.assert_allclose(float(r.std_error), float(w.std_error),
                                   rtol=1e-4)
    for side in ("epe_profile", "ene_profile"):
        np.testing.assert_allclose(getattr(got, side).numpy(),
                                   np.asarray(getattr(want, side)),
                                   rtol=RTOL)
    assert float(got.bcva) == float(got.cva.price) - float(got.dva.price)
    assert float(got.fva) == float(got.fca.price) - float(got.fba.price)


@pytest.mark.parametrize("antithetic", [False, True])
def test_cva_leg_ties_price_cva_multi_bitwise(antithetic):
    """At own_intensity = 0 and funding_spread = 0 the CVA table is the
    default-leg table and K43's walk, sums and EPE slots are K40's: the
    CVA pair and EPE row of the plain partials, and ``price_xva``'s CVA,
    its CI and EPE profile, equal ``price_cva_multi``'s bit for bit."""
    net = _net(3, 7)
    xspec = from_reference(_xspec(net, own=0.0, spread=0.0))
    ops = _ops(_xspec(net, own=0.0, spread=0.0))
    plan = tcm.make_plan(NB * 2 * ROWS * 128, NB, ROWS, antithetic,
                         n_underlyings=3)
    xp, xprof = tcm.xva_partials(ops, SEED, 0, plan, NB)
    cops = tcm.operands(xspec.netting,
                        tmath.cholesky_lower(xspec.netting.corr), "cpu")
    cp, cprof = tcm.partials(cops, SEED, 0, plan, NB)
    assert torch.equal(xp[:, :2], cp) and torch.equal(xprof[:, 0], cprof)
    assert (xp[:, 2:4] == 0).all() and (xp[:, 6:] == 0).all()  # no tables
    cfg = dataclasses.replace(TCFG, antithetic=antithetic)
    a = mctpu_torch.price_xva(xspec, 1 << 12, SEED, cfg)
    b = mctpu_torch.price_cva_multi(xspec.netting, 1 << 12, SEED, cfg)
    assert float(a.cva.price) == float(b.cva)
    assert float(a.cva.ci) == float(b.ci)
    assert torch.equal(a.epe_profile, b.expected_exposure)


def test_single_signed_sides_are_zero():
    """All long: the netted value never falls below 0, so DVA, FBA and the
    ENE profile are 0 (:func:`_zero`); all short: CVA, FCA and EPE."""
    for short in (False, True):
        xspec = from_reference(_xspec(_net(3, 5, short=short)))
        res = mctpu_torch.price_xva(xspec, 1 << 11, SEED, TCFG)
        zero = ("cva", "fca") if short else ("dva", "fba")
        live = ("dva", "fba") if short else ("cva", "fca")
        for leg in zero:
            assert _zero(getattr(res, leg).price)
        for leg in live:
            assert float(getattr(res, leg).price) > 0.0
        assert _zero(res.epe_profile if short else res.ene_profile)


def test_wide_sets_match_oracle_and_closed_form():
    """Beyond 8 underlyings ``mctpu``'s Pallas kernel stops and its engine
    draws a Threefry stream, so the wide path is held statistically: at
    m = 12 the all-long set's CVA and FCA within 4 standard errors of the
    closed form (DVA = FBA = 0), the mixed-sign set's four legs
    within 4 combined standard errors of the float64 oracle, both
    profiles within 4 of their node's standard errors."""
    n = 1 << 14
    xspec = from_reference(_xspec(_net(12, 6)))
    res = mctpu_torch.price_xva(xspec, n, SEED, TCFG)
    net = xspec.netting
    legs = tmath.xva_multi_closed_form(
        net.intensity, net.lgd, xspec.own_intensity, xspec.own_lgd,
        xspec.funding_spread, net.s, net.v, net.strikes, net.weights, net.r,
        net.t, net.n_grid)
    for leg, want in zip(("cva", "fca"), (legs[0], legs[2])):
        r = getattr(res, leg)
        assert abs(float(r.price) - float(want)) < 4 * float(r.std_error)
    assert _zero(res.dva.price) and _zero(res.fba.price)

    mixed = from_reference(_xspec(_net(12, 6, mixed=True)))
    res = mctpu_torch.price_xva(mixed, n, SEED, TCFG)
    ora = xva_oracle(mixed, n, 11)
    for leg in ("cva", "dva", "fca", "fba"):
        r = getattr(res, leg)
        price, se = ora[leg]
        assert abs(float(r.price) - price) < 4 * np.hypot(
            float(r.std_error), se), leg
    for side in ("epe", "ene"):
        got = getattr(res, side + "_profile")
        se = ora[side + "_sd"] * np.sqrt(2.0 / n)
        assert (torch.abs(got - ora[side]) < 4 * se).all(), side


def test_oracle_matches_mctpu_reference():
    """The float64 oracle and ``mctpu.reference.price_xva_multi`` on the
    mixed-sign pair: each leg within 4 combined standard errors, each
    profile node within 4 of its combined standard errors (the oracle's
    sample deviation per node)."""
    n = 1 << 14
    xspec = _xspec(_net(2, 8, mixed=True))
    want = jref.price_xva_multi(xspec, n, seed=3)
    got = xva_oracle(from_reference(xspec), n, 5)
    for leg in ("cva", "dva", "fca", "fba"):
        price, se = got[leg]
        assert abs(price - want[leg].price) < 4 * np.hypot(
            se, want[leg].std_error), leg
    for side in ("epe", "ene"):
        se = got[side + "_sd"].numpy() * np.sqrt(2.0 / n)
        assert (np.abs(got[side].numpy() - want[side]) < 4 * se).all(), side


def test_records_carry_and_validate():
    """``from_reference`` carries ``XvaSpec`` with its netting set and the
    result records ``XvaResult``, ``CvaResult`` and ``CvaGreeksResult``
    (float64 tensors, ``None`` where a Greek is absent); ``validate``
    raises ``mctpu``'s messages; ``bcva``, ``fva``, ``to_dict`` and the
    repr as ``mctpu``'s."""
    xspec = _xspec(_net(2, 5, mixed=True))
    ts = from_reference(xspec)
    assert isinstance(ts, XvaSpec) and ts.netting.n_underlyings == 2
    np.testing.assert_array_equal(ts.netting.corr, xspec.netting.corr)
    ts.validate()
    bad = {"own_intensity": -0.1, "own_lgd": 1.5, "funding_spread": -0.01,
           "netting": dataclasses.replace(xspec.netting, lgd=2.0)}
    for field, value in bad.items():
        jbad = dataclasses.replace(xspec, **{field: value})
        with pytest.raises(ValueError) as jerr:
            jbad.validate()
        with pytest.raises(ValueError) as terr:
            from_reference(jbad).validate()
        assert str(terr.value) == str(jerr.value), field

    xcfg = jengine.EngineConfig(backend="xla", num_blocks=8, rows=8)
    jres = jengine.price_xva(xspec, 1 << 11, KEY, xcfg)
    res = from_reference(jres)
    assert isinstance(res, XvaResult) and isinstance(res.cva, McResult)
    assert res.epe_profile.dtype == torch.float64
    np.testing.assert_array_equal(res.ene_profile.numpy(),
                                  np.asarray(jres.ene_profile))
    assert float(res.bcva) == float(jres.bcva)
    assert float(res.fva) == float(jres.fva)
    assert res.to_dict() == jres.to_dict()
    assert repr(res) == repr(jres)

    jcva = jengine.price_cva_multi(xspec.netting, 1 << 11, KEY, xcfg)
    cres = from_reference(jcva)
    assert isinstance(cres, CvaResult)
    assert float(cres.cva) == float(jcva.cva)
    np.testing.assert_array_equal(cres.expected_exposure.numpy(),
                                  np.asarray(jcva.expected_exposure))
    jg = jengine.greeks_cva_multi(xspec.netting, 1 << 11, KEY, xcfg)
    gres = from_reference(jg)
    assert isinstance(gres, CvaGreeksResult) and gres.gamma is None
    np.testing.assert_array_equal(gres.delta.price.numpy(),
                                  np.asarray(jg.delta.price))


def test_block_offset_relabels_streams():
    ops = _ops(_xspec(_net(3, 4)))
    plan = tcm.make_plan(4 * ROWS * 128, 4, ROWS, False, n_underlyings=3)
    full = tcm.xva_partials(ops, 9, 0, plan, 4)
    tail = tcm.xva_partials(ops, 9, 2, plan, 2)
    for x, y in zip(full, tail):
        assert torch.equal(x[2:], y)


def test_partials_refuse_bad_operands():
    ops = _ops(_xspec(_net(3, 4)))
    plan = tcm.make_plan(ROWS * 128, 1, ROWS, False, n_underlyings=3)
    with pytest.raises(ValueError, match="nodes"):
        tcm.xva_partials(_ops(_xspec(_net(3, 4)), greeks=True), SEED, 0,
                         plan, 1)
    with pytest.raises(ValueError, match="scal"):
        tcm.xva_partials(dataclasses.replace(ops, scal=ops.scal[:3]), SEED,
                         0, plan, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tcm.xva_partials(dataclasses.replace(
            ops, **{f.name: getattr(ops, f.name).to("meta")
                    for f in dataclasses.fields(ops)}), SEED, 0, plan, 1)
    with pytest.raises(ValueError, match="funding_spread"):
        mctpu_torch.price_xva(from_reference(_xspec(_net(2, 4),
                                                    spread=-1.0)),
                              1 << 10, SEED, TCFG)
