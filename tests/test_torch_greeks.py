"""K6, K7 and K8's plain versions against the JAX Greeks kernels in
interpret mode (CPU).

Both sides draw the same Philox stream, so the per-block partials agree to
f32 rounding.  Each ``(sum x, sum x^2)`` pair is held at ``rtol=2e-5`` by
the scaled bound of ``tests/torch_tolerance.py``: ``|got - want| <= rtol *
(|want sum x| + sqrt(n * want sum x^2))`` with ``n`` the units per block,
and ``rtol * want sum x^2`` on the square column, because a Greek's block
sum can nearly cancel.  The block-offset contract is held bitwise.
"""
import jax
import numpy as np
import pytest

from mctpu import math as jmath
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import basket as jbasket
from mctpu.kernels import greeks as jgreeks
from mctpu_torch import math as tmath
from mctpu_torch.kernels import basket as tbasket
from mctpu_torch.kernels import greeks as tgreeks
from mctpu_torch.types import from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
SEED = int(jrng.key_to_seed(jax.random.key(5)))
NB, ROWS = 2, 8
PLAN_FIELDS = ("num_blocks", "iters", "rows", "paths_per_iter",
               "units_per_iter", "antithetic", "kahan")


def _same_plan(tplan, jplan):
    for f in PLAN_FIELDS:
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert (tplan.total_paths, tplan.total_units) == (jplan.total_paths,
                                                      jplan.total_units)


def _units(plan):
    return plan.iters * plan.units_per_iter


@pytest.mark.parametrize("kind,antithetic,kahan,iters", [
    ("call", False, True, 2),
    ("put", False, True, 2),
    ("call", True, True, 1),
    ("call", False, False, 2),
])
def test_vanilla_partials_match_interpret_mode(kind, antithetic, kahan,
                                               iters):
    opt = jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
    paths = NB * iters * 2 * ROWS * 128
    jplan = jgreeks.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tgreeks.make_plan(paths, NB, ROWS, antithetic, kahan)
    _same_plan(tplan, jplan)
    want = np.asarray(jgreeks.pallas_partials(opt, SEED, 1, jplan, NB,
                                              interpret=True))
    par = tgreeks.params(from_reference(opt), "cpu")
    got = tgreeks.partials(par, SEED, 1, tplan, NB, kind == "put")
    assert got.shape == (NB, tgreeks.N_SUMS)
    assert_pairs_close(got.numpy(), want, _units(tplan), RTOL)


def test_vanilla_params_match_kernel_prep():
    opt = jtypes.VanillaOption(100.0, 95.0, 0.048790, 0.25, 1.5)
    o = opt.astype(np.float32)
    sqt = np.sqrt(o.t)
    want = np.array([o.s, o.k, o.r, o.v, o.t, (o.r - 0.5 * o.v * o.v) * o.t,
                     o.v * sqt, sqt], np.float32)
    got = tgreeks.params(from_reference(opt), "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def _one_asset():
    return jtypes.BasketOption(s=np.array([100.0]), v=np.array([0.2]),
                               w=np.array([1.0]), corr=np.eye(1),
                               d=np.zeros(1), k=100.0, r=0.048790, t=1.0)


def _basket_run(opt, antithetic=False, iters=1, off=0):
    """(JAX interpret partials, port partials, port plan) of one basket."""
    a = opt.n_assets
    jplan = jgreeks.make_basket_plan(1, NB, ROWS, antithetic, n_assets=a)
    paths = NB * iters * jplan.paths_per_iter
    jplan = jgreeks.make_basket_plan(paths, NB, ROWS, antithetic, n_assets=a)
    tplan = tbasket.make_plan(paths, NB, ROWS, antithetic, n_assets=a)
    _same_plan(tplan, jplan)
    tilt = jgreeks.tilt_direction(opt.corr, a)
    with jax.enable_x64(True):
        chol = np.asarray(jmath.cholesky_lower(np.asarray(opt.corr)))
    topt = from_reference(opt)
    tchol = tmath.cholesky_lower(topt.corr).numpy()
    if jbasket.use_asset_major(a):
        want = np.asarray(jgreeks.pallas_basket_am_partials(
            opt, chol, tilt[:2], SEED, off, jplan, NB, interpret=True))
        ops = tgreeks.am_operands(topt, tchol, tilt[:2], "cpu")
        got = tgreeks.am_partials(ops, SEED, off, tplan, NB)
        return want, got.numpy(), tplan
    want = tuple(np.asarray(x) for x in jgreeks.pallas_basket_partials(
        opt, chol, tilt[:2], SEED, off, jplan, NB, interpret=True))
    ops = tgreeks.packed_operands(topt, tchol, tilt[:2], "cpu")
    got = tgreeks.packed_partials(ops, SEED, off, tplan, NB)
    return want, tuple(x.numpy() for x in got), tplan


@pytest.mark.parametrize("name,antithetic", [
    ("one_asset", False),
    ("default_reference_3", False),
    ("equicorrelated_3", True),
])
def test_basket_am_partials_match_interpret_mode(name, antithetic):
    opt = {"one_asset": _one_asset(),
           "default_reference_3": jtypes.BasketOption.default_reference(3),
           "equicorrelated_3": jtypes.BasketOption.equicorrelated(3)}[name]
    want, got, tplan = _basket_run(opt, antithetic, iters=2, off=1)
    assert got.shape == (NB, 6 + 6 * opt.n_assets)
    assert_pairs_close(got, want, _units(tplan), RTOL)


@pytest.mark.parametrize("name", ["equicorrelated_16", "default_reference_10"])
def test_basket_packed_partials_match_interpret_mode(name):
    opt = (jtypes.BasketOption.equicorrelated(16) if name.endswith("16")
           else jtypes.BasketOption.default_reference(10))
    (want, want_vec), (got, got_vec), tplan = _basket_run(opt, off=3)
    width = tbasket.pack_factor(opt.n_assets)[2]
    assert got.shape == (NB, 6) and got_vec.shape == (NB, 6, width)
    assert_pairs_close(got, want, _units(tplan), RTOL)
    assert_pairs_close(got_vec, want_vec, _units(tplan), RTOL)


@pytest.mark.parametrize("a", [3, 10, 16])
@pytest.mark.parametrize("kind", ["equicorrelated", "default_reference"])
def test_tilt_direction_matches(a, kind):
    opt = getattr(jtypes.BasketOption, kind)(a)
    want = jgreeks.tilt_direction(opt.corr, a)
    got = tgreeks.tilt_direction(tmath.cholesky_lower(
        from_reference(opt).corr))
    assert got[2] == want[2]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-10, atol=1e-12)


def test_packed_operands_match_kernel_prep():
    opt = jtypes.BasketOption.equicorrelated(12)
    tilt = jgreeks.tilt_direction(opt.corr, 12)
    with jax.enable_x64(False):
        ops = jgreeks._basket_greek_ops(opt.astype(np.float32), np.eye(12),
                                        tilt, np.float32)
        sqt = np.sqrt(np.float32(opt.t))
        want = np.concatenate([np.asarray(ops[k]).reshape(1, -1) for k in (
            "s0", "drift", "vol", "d", "w_row", "inv_s0", "vg_row", "wv_row",
            "wv2_row")] + [np.asarray(ops["zsel"]).sum(1).reshape(1, -1),
                           np.asarray(ops["vol"]).reshape(1, -1) / sqt])
    got = tgreeks.packed_operands(from_reference(opt), np.eye(12), tilt,
                                  "cpu").rows.numpy()
    np.testing.assert_array_equal(got, want)


def test_block_offset_relabels_streams():
    van = tgreeks.params(from_reference(
        jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)), "cpu")
    plan = tgreeks.make_plan(1, 4, ROWS, False)
    full = tgreeks.partials(van, 9, 0, plan, 4, False)
    tail = tgreeks.partials(van, 9, 2, plan, 2, False)
    assert np.array_equal(full[2:].numpy(), tail.numpy())

    opt = from_reference(jtypes.BasketOption.equicorrelated(12))
    chol = tmath.cholesky_lower(opt.corr)
    tilt = tgreeks.tilt_direction(chol)[:2]
    ops = tgreeks.packed_operands(opt, chol, tilt, "cpu")
    plan = tbasket.make_plan(1, 4, ROWS, False, n_assets=12)
    full = tgreeks.packed_partials(ops, 9, 0, plan, 4)
    tail = tgreeks.packed_partials(ops, 9, 2, plan, 2)
    for f, t in zip(full, tail):
        assert np.array_equal(f[2:].numpy(), t.numpy())
