"""The rainbow pricer of the port against mctpu (CPU): K36's and K37's plain
versions against the JAX kernels in interpret mode, the operand tables
against ``mctpu``'s builders bit for bit, ``price_rainbow`` against
``mctpu.engine`` on interpret-mode Pallas, the Stulz closed form and the
bivariate normal CDF against ``mctpu.math``, the float64 oracle against
``mctpu.reference``'s, and the record.

Both packages draw the same Philox stream, so the ``(B, 2)`` partials agree
at ``rtol=2e-5`` (the two sum a block in other orders, XLA may contract or
reorder the operand arithmetic, and the packed regime forms ``L z`` as a
dot).  Each interpret-mode call takes a few seconds on a CPU: 2 blocks of
``rows=8``, two iterations.  The closed forms agree at ``1e-10``: the same
256-node quadrature in float64.
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
from mctpu.kernels import rainbow as jrb
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import rainbow as trb
from mctpu_torch.models.rainbow import rainbow_oracle
from mctpu_torch.types import RainbowOption, from_reference

RTOL = 2e-5
KEY = jax.random.key(616)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8
# The min call's strike falls with the basket, so that paths finish in the
# money at every size.
STRIKE_MIN = {1: 100.0, 2: 95.0, 3: 90.0, 8: 85.0, 9: 80.0, 16: 75.0,
              100: 60.0}


def _ref_opt(a: int, kind: str):
    """A ``mctpu`` rainbow whose spots and vols differ by asset (a seeded
    draw), equicorrelated at 0.3."""
    rng = np.random.default_rng(100 + a)
    return jtypes.RainbowOption(
        s=rng.uniform(90.0, 110.0, a), v=rng.uniform(0.15, 0.35, a),
        corr=jtypes.BasketOption.equicorrelated(a, 0.3).corr,
        k=100.0 if kind == "max" else STRIKE_MIN[a], r=0.05, t=1.0, kind=kind)


def _chol64(corr):
    """``mctpu.engine``'s float64 factor of ``corr`` (as a NumPy array)."""
    with jax.enable_x64(True):
        return np.asarray(jmath.cholesky_lower(jnp.asarray(corr,
                                                           jnp.float64)))


def _plans(a: int, antithetic: bool, kahan: bool):
    probe = jrb.make_plan(1, NB, ROWS, antithetic, n_assets=a)
    paths = NB * 2 * probe.paths_per_iter
    jplan = jrb.make_plan(paths, NB, ROWS, antithetic, kahan=kahan,
                          n_assets=a)
    tplan = trb.make_plan(paths, NB, ROWS, antithetic, kahan, n_assets=a)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    return jplan, tplan


@pytest.mark.parametrize("a", sorted(STRIKE_MIN))
@pytest.mark.parametrize("kind", ["max", "min"])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_partials_match_interpret_mode(a, kind, antithetic, kahan):
    """K36 (a <= 8) and K37 (9, 16, 100 assets: ``c`` = 8, 8, 1)."""
    opt = _ref_opt(a, kind)
    jplan, tplan = _plans(a, antithetic, kahan)
    want = np.asarray(jrb.pallas_partials(opt, _chol64(opt.corr), SEED, 1,
                                          jplan, NB, interpret=True))
    to = from_reference(opt)
    ops = trb.operands(to, tmath.cholesky_lower(to.corr), "cpu")
    got = trb.partials(ops, SEED, 1, tplan, NB)
    assert got.shape == (NB, 2)
    assert (want[:, 0] > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("a", [1, 3, 8, 9, 16, 100, 129])
@pytest.mark.parametrize("kind", ["max", "min"])
def test_operand_tables_match_mctpu_builders(a, kind):
    """The port's tables equal ``rainbow_am_ops`` (a <= 8) or the real lanes
    of ``pack_rainbow`` (its factor the transpose of ``chol_bd``'s first
    block), as ``mctpu``'s source forms them (eagerly), bit for bit."""
    opt = (_ref_opt(a, kind) if a in STRIKE_MIN
           else dataclasses.replace(_ref_opt(100, kind),
                                    s=np.linspace(90.0, 110.0, a),
                                    v=np.linspace(0.15, 0.35, a),
                                    corr=np.eye(a)))
    ch = _chol64(opt.corr)
    with jax.enable_x64(False):
        o = opt.astype(jnp.float32)
        if a <= 8:
            jlt, jpar = (np.asarray(x) for x in jrb.rainbow_am_ops(
                o, ch, jnp.float32))
        else:
            ops = jrb.pack_rainbow(o, ch, jnp.float32)
            jpar = np.stack([np.asarray(ops[name])[0, :a]
                             for name in ("drift", "vol", "s0")])
            jlt = np.asarray(ops["chol_bd"])[:a, :a].T
            a_tile, c, width = trb.pack_factor(a)
            assert (ops["a_tile"], ops["c"]) == (a_tile, c)
            assert np.asarray(ops["chol_bd"]).shape == (width, width)
    to = from_reference(opt)
    ops = trb.operands(to, tmath.cholesky_lower(to.corr), "cpu")
    np.testing.assert_array_equal(ops.lt.numpy(), jlt)
    np.testing.assert_array_equal(ops.par.numpy(), jpar)
    np.testing.assert_array_equal(ops.k.numpy(), np.float32([opt.k]))
    assert ops.use_min == (kind == "min")


@pytest.mark.parametrize("a", [3, 16])
def test_block_offset_relabels_streams(a):
    """Blocks [2, 3] at offset 0 equal blocks [0, 1] at offset 2."""
    to = from_reference(_ref_opt(a, "max"))
    ops = trb.operands(to, tmath.cholesky_lower(to.corr), "cpu")
    plan = trb.make_plan(1, 4, ROWS, False, n_assets=a)
    full = trb.partials(ops, 9, 0, plan, 4)
    tail = trb.partials(ops, 9, 2, plan, 2)
    assert torch.equal(full[2:], tail)


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=8,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")


@pytest.mark.parametrize("a,kind,antithetic", [(3, "max", False),
                                               (2, "min", True),
                                               (16, "max", False),
                                               (16, "min", True)])
def test_engine_price_matches_mctpu(a, kind, antithetic):
    opt = _ref_opt(a, kind)
    n = 1 << 14
    want = jengine.price_rainbow(
        opt, n, KEY, dataclasses.replace(JCFG, antithetic=antithetic))
    got = mctpu_torch.price_rainbow(
        from_reference(opt), n, SEED,
        dataclasses.replace(TCFG, antithetic=antithetic))
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    np.testing.assert_allclose(
        [float(got.sum_p), float(got.sum_p2)],
        [float(want.sum_p), float(want.sum_p2)], rtol=1e-5)
    np.testing.assert_allclose(float(got.price), float(want.price),
                               rtol=1e-5)


ARGS = [(100.0, 95.0, 100.0, 0.05, 0.2, 0.3, 0.3, 1.0),
        (100.0, 95.0, 60.0, 0.05, 0.2, 0.3, 0.0, 1.0),
        (80.0, 120.0, 90.0, 0.01, 0.4, 0.15, -0.6, 2.5),
        (100.0, 100.0, 110.0, 0.04879, 0.25, 0.25, 0.9, 0.5)]


@pytest.mark.parametrize("args", ARGS)
def test_stulz_matches_mctpu(args):
    with jax.enable_x64(True):
        for kind in ("min", "max"):
            want = float(getattr(jmath, f"rainbow_{kind}_call")(
                *args, dtype=jnp.float64))
            got = float(getattr(tmath, f"rainbow_{kind}_call")(*args))
            assert abs(got - want) < 1e-10, (kind, got, want)
        a, b, rho = args[4] - args[5], args[6], args[6]
        want = float(jmath.bivariate_norm_cdf(a, b, rho, dtype=jnp.float64))
        assert abs(float(tmath.bivariate_norm_cdf(a, b, rho)) - want) < 1e-10


def test_stulz_autograd_matches_jax_grad():
    """The two-asset Greeks gate differentiates the port's Stulz form with
    autograd, as mctpu's does with ``jax.grad``."""
    args = (100.0, 95.0, 0.2, 0.3, 0.05, 1.0)
    for kind in ("max", "min"):
        jf = getattr(jmath, f"rainbow_{kind}_call")
        with jax.enable_x64(True):
            want = jax.grad(lambda s1, s2, v1, v2, r, t: jf(
                s1, s2, 100.0, r, v1, v2, 0.5, t, dtype=jnp.float64),
                argnums=tuple(range(6)))(*args)
        xs = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in args]
        s1, s2, v1, v2, r, t = xs
        getattr(tmath, f"rainbow_{kind}_call")(s1, s2, 100.0, r, v1, v2, 0.5,
                                               t).backward()
        np.testing.assert_allclose([float(x.grad) for x in xs],
                                   [float(w) for w in want], rtol=1e-9,
                                   atol=1e-10)


@pytest.mark.parametrize("kind", ["max", "min"])
def test_two_asset_price_matches_stulz(kind):
    opt = RainbowOption(s=np.array([100.0, 95.0]), v=np.array([0.2, 0.3]),
                        corr=np.array([[1.0, 0.3], [0.3, 1.0]]), k=100.0,
                        r=0.05, t=1.0, kind=kind)
    res = mctpu_torch.price_rainbow(opt, 1 << 16, SEED, TCFG)
    cf = float(getattr(tmath, f"rainbow_{kind}_call")(
        100.0, 95.0, 100.0, 0.05, 0.2, 0.3, 0.3, 1.0))
    assert abs(float(res.price) - cf) < 4 * float(res.std_error)


def test_k_zero_max_plus_min_is_the_spots():
    """max + min = S1 + S2 path by path: at k = 0 the two estimates on the
    same draws sum to the spots within the sum's own standard error."""
    base = RainbowOption(s=np.array([100.0, 95.0]), v=np.array([0.2, 0.3]),
                         corr=np.array([[1.0, 0.3], [0.3, 1.0]]), k=0.0,
                         r=0.05, t=1.0)
    mx = mctpu_torch.price_rainbow(base, 1 << 16, SEED, TCFG)
    mn = mctpu_torch.price_rainbow(dataclasses.replace(base, kind="min"),
                                   1 << 16, SEED, TCFG)
    # Var(max + min) = Var(S1 + S2): discounted lognormal moments.
    s, v, rho = np.array([100.0, 95.0]), np.array([0.2, 0.3]), 0.3
    var = (np.sum(s * s * np.expm1(v * v))
           + 2 * s[0] * s[1] * np.expm1(rho * v[0] * v[1]))
    se = np.sqrt(var / mx.n)
    assert abs(float(mx.price) + float(mn.price) - 195.0) < 4 * se


def test_single_asset_is_black_scholes():
    opt = RainbowOption(s=np.array([100.0]), v=np.array([0.2]),
                        corr=np.eye(1), k=100.0, r=0.05, t=1.0)
    res = mctpu_torch.price_rainbow(opt, 1 << 16, SEED, TCFG)
    bs = float(tmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    assert abs(float(res.price) - bs) < 4 * float(res.std_error)


@pytest.mark.parametrize("a,kind", [(5, "max"), (16, "min")])
def test_oracle_matches_reference(a, kind):
    """The port's float64 oracle and ``mctpu.reference``'s, on their own
    generators, agree within 4 combined standard errors."""
    opt = _ref_opt(a, kind) if a in STRIKE_MIN else dataclasses.replace(
        _ref_opt(3, kind), s=np.full(a, 100.0), v=np.linspace(0.2, 0.35, a),
        corr=np.eye(a))
    want = jref.price_rainbow(opt, 1 << 16, seed=7)
    price, se = rainbow_oracle(from_reference(opt), 1 << 16, 7)
    assert abs(price - want.price) < 4 * np.hypot(se, want.std_error)


def test_validate_messages_match_mctpu():
    good = _ref_opt(2, "max")
    bad = {"kind": "median", "v": np.array([0.2]), "corr": np.eye(3),
           "s": np.array([100.0, -1.0]), "k": -1.0, "t": 0.0}
    for field, value in bad.items():
        ref = dataclasses.replace(good, **{field: value})
        with pytest.raises(ValueError) as want:
            ref.validate()
        with pytest.raises(ValueError) as got:
            from_reference(ref).validate()
        assert str(got.value) == str(want.value), field


def test_from_reference_carries_the_record():
    ref = _ref_opt(3, "min")
    opt = from_reference(ref)
    assert isinstance(opt, RainbowOption)
    assert opt.kind == "min" and isinstance(opt.kind, str)
    assert opt.n_assets == 3
    np.testing.assert_array_equal(opt.s, ref.s)
    np.testing.assert_array_equal(opt.corr, ref.corr)
    assert (opt.k, opt.r, opt.t) == (ref.k, ref.r, ref.t)
    assert isinstance(opt.k, float)


def test_equicorrelated_matches_mctpu_matrix():
    """``RainbowOption.equicorrelated`` carries its spots and vols and
    ``mctpu``'s equicorrelated matrix."""
    ref = _ref_opt(9, "min")
    opt = RainbowOption.equicorrelated(list(ref.s), list(ref.v), 0.3, ref.k,
                                       ref.r, ref.t, kind="min")
    np.testing.assert_array_equal(opt.corr, ref.corr)
    np.testing.assert_array_equal(opt.s, ref.s)
    np.testing.assert_array_equal(opt.v, ref.v)
    assert (opt.k, opt.r, opt.t, opt.kind) == (ref.k, ref.r, ref.t, "min")
    opt.validate()
