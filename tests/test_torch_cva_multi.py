"""The netting-set CVA of the port against mctpu (CPU): K40's and K39's plain
versions against the JAX kernels in interpret mode, their operand tables
against ``mctpu``'s builders (bit for bit, the exponentials' within the
ulps stated), ``price_cva_multi`` against
``mctpu.engine.price_cva_multi`` on interpret-mode Pallas, the closed form
and its autograd against ``mctpu.math`` and ``jax.grad``, the float64
oracle against ``mctpu.reference``, and the record's validation.

Both packages draw the same streams, so the per-block price pairs agree at
``rtol=2e-5`` (the block sums are taken in other orders) and so does the
exposure profile: ``mctpu`` sums each node over the whole tile, the port's
plain version over the block, both then compensated node by node.  Each
interpret-mode call runs once, on 2 blocks of ``rows=8`` and at most 10
nodes.
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
from mctpu_torch.models.cva_multi import cva_multi_oracle
from mctpu_torch.types import CvaMultiSpec, CvaResult, from_reference

RTOL = 2e-5
KEY = jax.random.key(91)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8


def _spec(m: int, g: int, mixed: bool = False):
    """The JAX package's mixed-sign pair (``tests/test_cva_multi.py``) or
    an all-long set of ``m`` underlyings."""
    if mixed:
        return jtypes.CvaMultiSpec(
            intensity=0.03, lgd=0.6, s=np.array([100.0, 95.0]),
            v=np.array([0.2, 0.3]), corr=np.array([[1.0, 0.5], [0.5, 1.0]]),
            r=0.05, t=1.0, strikes=np.array([100.0, 90.0]),
            weights=np.array([1.0, -0.6]), n_grid=g)
    corr = np.full((m, m), 0.3) + 0.7 * np.eye(m)
    return jtypes.CvaMultiSpec(
        intensity=0.03, lgd=0.6, s=100.0 * (1.0 - 0.02 * np.arange(m)),
        v=np.linspace(0.15, 0.35, m), corr=corr, r=0.05, t=1.0,
        strikes=np.linspace(95.0, 105.0, m), weights=np.full(m, 1.0 / m),
        n_grid=g)


def _chol64(spec):
    with jax.enable_x64(True):
        return np.asarray(jmath.cholesky_lower(jnp.asarray(spec.corr,
                                                           jnp.float64)))


def _ops(spec):
    ts = from_reference(spec)
    return tcm.operands(ts, tmath.cholesky_lower(ts.corr), "cpu")


CASES = {
    # name: (m, n_grid, mixed, antithetic, kahan, iters)
    "K40_m2_mixed_g5": (2, 5, True, False, True, 1),
    "K40_m3_g4_antithetic_f32_2iters": (3, 4, False, True, False, 2),
    "K40_m1_g3": (1, 3, False, False, True, 1),
    "K39_m9_g4": (9, 4, False, False, True, 1),
    "K39_m9_g3_antithetic": (9, 3, False, True, True, 1),
    # the register instances' edges: a_tile 16 full, a_tile 32 at its first
    "K39_m16_g3": (16, 3, False, False, True, 1),
    "K39_m17_g3_antithetic_f32": (17, 3, False, True, False, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case):
    m, g, mixed, antithetic, kahan, iters = CASES[case]
    spec = _spec(m, g, mixed)
    probe = jcm.make_plan(1, NB, ROWS, antithetic, n_underlyings=m)
    paths = NB * iters * probe.paths_per_iter
    jplan = jcm.make_plan(paths, NB, ROWS, antithetic, kahan=kahan,
                          n_underlyings=m)
    tplan = tcm.make_plan(paths, NB, ROWS, antithetic, kahan,
                          n_underlyings=m)
    assert (tplan.iters, tplan.units_per_iter) == (jplan.iters,
                                                   jplan.units_per_iter)
    want, wee = jcm.pallas_partials(spec, _chol64(spec), SEED, 1, jplan, NB,
                                    interpret=True)
    got, gee = tcm.partials(_ops(spec), SEED, 1, tplan, NB)
    assert got.shape == (NB, 2) and gee.shape == (NB, g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(gee.numpy(), np.asarray(wee), rtol=RTOL)


@pytest.mark.parametrize("which", ["mixed", "m3", "m16"])
@pytest.mark.parametrize("g", [1, 50])
def test_tables_match_mctpu_builders(which, g):
    """``pack_spec``'s rows, ``_am_ops``' and ``greek_tables``' as
    ``mctpu`` forms them (eagerly, float32), bit for bit; K39's two
    per-element rows, ``log s0`` and ``r + 0.5 v v``, as its kernel forms
    them from those rows."""
    spec = (_spec(2, g, True) if which == "mixed"
            else _spec(int(which[1:]), g))
    m = spec.n_underlyings
    ch = _chol64(spec)
    with jax.enable_x64(False):
        sp = spec.astype(jnp.float32)
        jp = jcm.pack_spec(sp, ch, jnp.float32)
        jlt, jpar, jsqdt = jcm._am_ops(sp, ch, jnp.float32)
        jtab = [np.asarray(x) for x in jcm.greek_tables(sp, jnp.float32)]
        log_s0 = np.asarray(jnp.log(jp["s0"]))[0, :m]
        cr = np.asarray(sp.r + 0.5 * jp["v"] * jp["v"])[0, :m]
        jp = {k: np.asarray(v) for k, v in jp.items()}
    ts = from_reference(spec)
    chol = tmath.cholesky_lower(ts.corr)
    tp = tcm.pack_spec(ts)
    for name in ("s0", "k", "w", "v", "drift", "vol"):
        np.testing.assert_array_equal(tp[name].numpy(), jp[name], name)
    lt, par = tcm.am_ops(ts, chol)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(jlt))
    np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))
    np.testing.assert_array_equal(tcm.operands(ts, chol, "cpu").scal[2],
                                  np.float32(jsqdt))
    plt_, ppar = tcm.packed_ops(ts, chol)
    np.testing.assert_array_equal(plt_.numpy(), np.asarray(jlt))
    want = np.stack([log_s0] + [jp[n][0, :m] for n in
                                ("drift", "vol", "k", "w", "v")] + [cr])
    np.testing.assert_array_equal(ppar.numpy(), want)
    # The node tables: tau and sqrt(tau) bit for bit.  The exponentials are
    # libm's here and XLA's there: dp (exp times -expm1) within 2 ulp, disc
    # within 1 ulp; ddp is a difference of neighbouring terms t_j
    # e^{-lam t_j} <= t, so an ulp of a term moves it by up to 2 ulp(t).
    dp, ddp, tau, sqtau, disc = tcm.greek_tables(ts).numpy()
    np.testing.assert_array_equal(tau, jtab[2])
    np.testing.assert_array_equal(sqtau, jtab[3])
    assert _ulps(dp, jtab[0]) <= 2 and _ulps(disc, jtab[4]) <= 1
    assert np.abs(ddp - jtab[1]).max() <= 2 * np.spacing(np.float32(spec.t))


def _ulps(a, b) -> int:
    """The largest distance in float32 ulps between ``a`` and ``b``."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
              for x in (a, b))
    return int(np.abs(ia - ib).max())


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=8,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")


@pytest.mark.parametrize("which", ["mixed", "m9"])
def test_engine_matches_mctpu(which):
    """``price_cva_multi`` on the same streams: the CVA and its standard
    error at rtol 2e-5 (so within 4 standard errors), the profile at rtol
    2e-5, the default-leg masses to float64 rounding."""
    spec = _spec(2, 6, True) if which == "mixed" else _spec(9, 3)
    n = 1 << 12
    want = jengine.price_cva_multi(spec, n, KEY, JCFG)
    got = mctpu_torch.price_cva_multi(from_reference(spec), n, SEED, TCFG)
    assert isinstance(got, CvaResult)
    assert (got.n, got.n_paths) == (int(want.n), int(want.n_paths))
    assert abs(float(got.cva) - float(want.cva)) < 4 * float(want.std_error)
    np.testing.assert_allclose(float(got.cva), float(want.cva), rtol=RTOL)
    np.testing.assert_allclose(float(got.std_error), float(want.std_error),
                               rtol=1e-4)
    np.testing.assert_allclose(got.expected_exposure.numpy(),
                               np.asarray(want.expected_exposure), rtol=RTOL)
    np.testing.assert_allclose(got.default_leg.numpy(),
                               np.asarray(want.default_leg), rtol=1e-13)


def test_block_offset_relabels_streams():
    ops = _ops(_spec(3, 4))
    plan = tcm.make_plan(4 * ROWS * 128, 4, ROWS, False, n_underlyings=3)
    full = tcm.partials(ops, 9, 0, plan, 4)
    tail = tcm.partials(ops, 9, 2, plan, 2)
    for x, y in zip(full, tail):
        assert torch.equal(x[2:], y)


def _cf_args(spec):
    return (spec.intensity, spec.lgd, spec.s, spec.v, spec.strikes,
            spec.weights, spec.r, spec.t)


@pytest.mark.parametrize("m", [1, 3, 9])
def test_closed_form_and_autograd_match_mctpu(m):
    """The float64 closed form within 1e-12 of ``mctpu.math``'s, and its
    autograd in the intensity, the spots and the vols within 1e-9 of
    ``jax.grad``."""
    spec = _spec(m, 12)
    with jax.enable_x64(True):
        def jf(lam, s, v):
            return jmath.cva_multi_closed_form(
                lam, spec.lgd, s, v, spec.strikes, spec.weights, spec.r,
                spec.t, spec.n_grid, dtype=jnp.float64)
        args = (jnp.float64(spec.intensity), jnp.asarray(spec.s),
                jnp.asarray(spec.v))
        want = float(jf(*args))
        wgrad = [np.asarray(x) for x in jax.grad(jf, argnums=(0, 1, 2))(
            *args)]
    lam, s, v = (torch.tensor(np.asarray(x, np.float64), requires_grad=True)
                 for x in (spec.intensity, spec.s, spec.v))
    got = tmath.cva_multi_closed_form(lam, spec.lgd, s, v, spec.strikes,
                                      spec.weights, spec.r, spec.t,
                                      spec.n_grid)
    assert abs(float(got.detach()) - want) <= 1e-12 * abs(want)
    got.backward()
    for g, w in zip((lam.grad, s.grad, v.grad), wgrad):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-12)


def test_oracle_matches_mctpu_reference():
    """The float64 oracle and ``mctpu.reference.price_cva_multi`` on the
    mixed-sign set: within 4 combined standard errors; the oracle's
    profile is the exposure's mean per node."""
    spec = _spec(2, 10, True)
    want = jref.price_cva_multi(spec, 1 << 14, seed=3)
    cva, se, ee, ee_sd = cva_multi_oracle(from_reference(spec), 1 << 14, 5)
    assert abs(cva - want.price) < 4 * np.hypot(se, want.std_error)
    assert ee.shape == ee_sd.shape == (10,)
    assert bool((ee > 0).all()) and bool((ee_sd > 0).all())


def test_records_carry_and_validate():
    """``from_reference`` carries the record; ``validate`` raises
    ``mctpu``'s messages."""
    spec = _spec(3, 7)
    ts = from_reference(spec)
    assert isinstance(ts, CvaMultiSpec)
    assert ts.n_underlyings == 3 and ts.n_grid == 7
    np.testing.assert_array_equal(ts.corr, spec.corr)
    ts.validate()
    bad = {
        "v": np.array([0.2, 0.3]), "strikes": np.array([100.0]),
        "weights": np.ones(4), "corr": np.eye(2), "n_grid": 0,
        "s": np.array([100.0, -1.0, 100.0]),
        "intensity": -0.1, "lgd": 1.5,
    }
    for field, value in bad.items():
        jbad = dataclasses.replace(spec, **{field: value})
        with pytest.raises(ValueError) as jerr:
            jbad.validate()
        with pytest.raises(ValueError) as terr:
            from_reference(jbad).validate()
        assert str(terr.value) == str(jerr.value), field
    with pytest.raises(ValueError, match="strikes must be positive"):
        dataclasses.replace(ts, strikes=np.array([100.0, 0.0, 1.0])
                            ).validate()


def test_partials_refuse_bad_operands():
    ops = _ops(_spec(3, 4))
    plan = tcm.make_plan(ROWS * 128, 1, ROWS, False, n_underlyings=3)
    with pytest.raises(ValueError, match="par"):
        tcm.partials(dataclasses.replace(ops, par=ops.par[:7]), SEED, 0,
                     plan, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tcm.partials(dataclasses.replace(
            ops, **{f.name: getattr(ops, f.name).to("meta")
                    for f in dataclasses.fields(ops)}), SEED, 0, plan, 1)
