"""K45-K48's plain versions against the JAX control-variate kernels in
interpret mode (CPU), the block-offset contract, the centers and the pilot
plan against ``mctpu``'s, and the pricers' argument checks.

Both packages draw the same Philox stream and are fed the same float32
centers ``(p0, m)``.  The five moment sums ``(sum d, sum d^2, sum cc, sum
cc^2, sum d cc)`` are held by ``tests/torch_tolerance.py``'s
``assert_moments_close`` at ``rtol=2e-5``: ``sum d`` and ``sum cc`` are
centered and can sit near 0, so each is held by the scaled bound ``rtol *
(|sum x| + sqrt(n * sum x^2))`` (``n`` the units per block), ``sum d cc``
by ``rtol * sqrt(sum d^2 * sum cc^2)``, the squares at ``rtol``.  Each case
runs 2 blocks of ``rows=8`` (one interpret-mode trace a case).
"""
import dataclasses

import jax
import numpy as np
import pytest

from mctpu import engine as jengine
from mctpu import math as jmath
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu import variance as jvariance
from mctpu.kernels import asian as jasian
from mctpu.kernels import basket as jbasket
from mctpu.kernels import vanilla as jvanilla
from mctpu.kernels import varred as jvr
from mctpu_torch import engine as tengine
from mctpu_torch import variance as tvariance
from mctpu_torch.kernels import asian as tasian
from mctpu_torch.kernels import basket as tbasket
from mctpu_torch.kernels import vanilla as tvanilla
from mctpu_torch.kernels import varred as tvr
from mctpu_torch.types import BasketOption, CvaSpec, from_reference
from torch_tolerance import assert_moments_close

RTOL = 2e-5
SEED = int(jrng.key_to_seed(jax.random.key(41)))
NB, ROWS = 2, 8
VAN = jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
ARI = jtypes.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=8)


def _same_plan(tplan, jplan):
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    return tplan


def _units(plan):
    return plan.iters * plan.units_per_iter


def _center(center):
    """The port's float32 centers, as the Python floats fed to both."""
    return tuple(float(x) for x in tvr.center32(center))


@pytest.mark.parametrize("antithetic,kahan,iters", [
    (False, True, 2), (True, False, 1), (False, False, 1)])
def test_vanilla_cv_matches_interpret_mode(antithetic, kahan, iters):
    paths = NB * iters * 2 * ROWS * 128 * (2 if antithetic else 1)
    jplan = jvanilla.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = _same_plan(tvanilla.make_plan(paths, NB, ROWS, antithetic, kahan),
                       jplan)
    center = _center(tvariance._vanilla_center(from_reference(VAN)))
    want = np.asarray(jvr.vanilla_cv_pallas_partials(
        VAN, center, SEED, 3, jplan, NB, interpret=True))
    got = tvr.vanilla_cv_partials(
        tvr.vanilla_cv_params(from_reference(VAN), center, "cpu"), SEED, 3,
        tplan, NB)
    assert got.shape == (NB, tvr.N_MOMENT_SUMS)
    assert_moments_close(got.numpy(), want, _units(tplan), RTOL)


@pytest.mark.parametrize("n_obs,antithetic,kahan", [
    (8, False, True), (8, True, False)])
def test_asian_cv_matches_interpret_mode(n_obs, antithetic, kahan):
    opt = dataclasses.replace(ARI, n_obs=n_obs)
    paths = NB * ROWS * 128 * (2 if antithetic else 1)
    jplan = jasian.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = _same_plan(tasian.make_plan(paths, NB, ROWS, antithetic, kahan),
                       jplan)
    topt = from_reference(opt)
    center = _center(tvariance._asian_center(topt))
    want = np.asarray(jvr.asian_cv_pallas_partials(
        opt, center, SEED, 1, jplan, NB, interpret=True))
    got = tvr.asian_cv_partials(tvr.asian_cv_params(topt, center, "cpu"),
                                SEED, 1, tplan, NB, n_obs)
    assert_moments_close(got.numpy(), want, _units(tplan), RTOL)


@pytest.mark.parametrize("a,antithetic,kahan,iters", [
    (3, False, True, 1), (3, True, False, 1), (8, False, True, 1),
    (16, False, True, 1), (16, True, False, 1), (17, False, True, 2)],
    ids=["K47-a3", "K47-a3-anti-f32", "K47-a8", "K48-a16",
         "K48-a16-anti-f32", "K48-a17-2iters"])
def test_basket_cv_matches_interpret_mode(a, antithetic, kahan, iters):
    """At 17 assets (a_tile 32) over two iterations the moment rows are
    Kahan-carried across iterations, as K48's fold carries them."""
    opt = jtypes.BasketOption.equicorrelated(a, rho=0.3)
    chol = np.asarray(jmath.cholesky_lower(np.asarray(opt.corr)))
    probe = jbasket.make_plan(1, NB, ROWS, antithetic, n_assets=a)
    jplan = jbasket.make_plan(NB * iters * probe.paths_per_iter, NB, ROWS,
                              antithetic, kahan=kahan, n_assets=a)
    assert jplan.iters == iters
    tplan = _same_plan(tbasket.make_plan(jplan.total_paths, NB, ROWS,
                                         antithetic, kahan, n_assets=a),
                       jplan)
    topt = from_reference(opt)
    center = _center(tvariance._basket_center(topt))
    want = np.asarray(jvr.basket_cv_pallas_partials(
        opt, chol, center, SEED, 2, jplan, NB, interpret=True))
    ops = tvr.basket_cv_operands(topt, chol, center, "cpu")
    got = tvr.basket_cv_partials(ops, SEED, 2, tplan, NB)
    assert_moments_close(got.numpy(), want, _units(tplan), RTOL)


def _launchers():
    """``(name, fn(off, nb))`` of each kernel's CPU wrapper at 4 blocks."""
    cfg = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu",
                               auto_shrink=False)
    out = []
    for name, opt in (("K45", from_reference(VAN)),
                      ("K46", from_reference(dataclasses.replace(ARI,
                                                                 n_obs=5))),
                      ("K47", BasketOption.equicorrelated(3)),
                      ("K48", BasketOption.equicorrelated(10))):
        s = tvariance.cv_setup(opt, 1, cfg)
        ops = s.operands(tvr.center32(s.center))
        out.append((name, lambda off, nb, s=s, ops=ops: s.partials(
            ops, 9, off, s.plan, nb)))
    return out


@pytest.mark.parametrize("name,fn", _launchers(),
                         ids=["K45", "K46", "K47", "K48"])
def test_block_offset_relabels_streams(name, fn):
    full = fn(0, 4)
    tail = fn(2, 2)
    assert np.array_equal(full[2:].numpy(), tail.numpy()), name
    assert np.array_equal(full.numpy(), fn(0, 4).numpy()), name


def _mctpu_centers(price_fn, xla_name, opt, n):
    """The float32 centers ``mctpu``'s pricer hands its kernel, pilot's
    and main run's: the XLA twin is wrapped to record its ``center``."""
    seen = []
    original = getattr(jvr, xla_name)

    def recording(*args):
        center = args[2] if xla_name == "basket_cv_xla_partials" else args[1]
        jax.debug.callback(lambda c: seen.append(np.asarray(c)),
                           jax.numpy.stack(center), ordered=True)
        return original(*args)

    cfg = jengine.EngineConfig(num_blocks=8, rows=8, backend="xla",
                               auto_shrink=False)
    jengine._RUNNERS.clear()  # trace anew, through the recording twin
    try:
        setattr(jvr, xla_name, recording)
        jax.block_until_ready(price_fn(opt, n, jax.random.key(3), cfg).price)
    finally:
        setattr(jvr, xla_name, original)
    assert len(seen) == 2
    return seen[0]


@pytest.mark.parametrize("product", ["vanilla", "asian", "basket3",
                                     "basket10-d0.3"])
def test_centers_match_mctpu(product):
    """The a-priori centers, rounded to float32, within 2 ulp of mctpu's
    (XLA's CPU compiler may contract or reorder their scalar float64
    arithmetic)."""
    if product == "vanilla":
        opt, fn, name = VAN, jvariance.price_vanilla_cv, \
            "vanilla_cv_xla_partials"
        center = tvariance._vanilla_center(from_reference(opt))
    elif product == "asian":
        opt, fn, name = ARI, jvariance.price_asian_cv, "asian_cv_xla_partials"
        center = tvariance._asian_center(from_reference(opt))
    else:
        a = 3 if product == "basket3" else 10
        opt = jtypes.BasketOption.equicorrelated(a, rho=0.3)
        if product.endswith("d0.3"):
            opt = dataclasses.replace(opt, d=np.full(a, 0.3))
        fn, name = jvariance.price_basket_cv, "basket_cv_xla_partials"
        center = tvariance._basket_center(from_reference(opt))
    want = _mctpu_centers(fn, name, opt, 1 << 12).astype(np.float32)
    got = tvr.center32(center).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert (ulps <= 2).all(), (got, want, ulps)


def _plan(num_blocks, iters):
    return tvanilla.make_plan(num_blocks * iters * 2 * 8 * 128, num_blocks,
                              8, False)


@pytest.mark.parametrize("num_blocks,iters,frac", [
    (512, 8, 0.1), (4, 2, 0.1), (8, 5, 0.5), (16, 5, 0.25), (128, 1, 0.1),
    (8, 1, 0.999)])
def test_pilot_plan_matches_mctpu(num_blocks, iters, frac):
    tplan = _plan(num_blocks, iters)
    jplan = jvanilla.make_plan(tplan.total_paths, num_blocks, 8, False)
    got = tvariance._pilot_plan(tplan, frac)
    want = jvariance._pilot_plan(jplan, frac)
    _same_plan(got, want)
    assert (got.total_paths, got.total_units) == (want.total_paths,
                                                  want.total_units)


@pytest.mark.parametrize("frac", [0.0, 1.0, 1.5, -0.1])
def test_pilot_frac_outside_unit_interval_raises(frac):
    with pytest.raises(ValueError, match="pilot_frac must be in"):
        jvariance._pilot_plan(jvanilla.make_plan(1, 8, 8, False), frac)
    with pytest.raises(ValueError, match="pilot_frac must be in"):
        tvariance._pilot_plan(_plan(8, 1), frac)


def test_calls_and_arithmetic_only():
    cfg = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")
    put = from_reference(dataclasses.replace(VAN, kind="put"))
    with pytest.raises(ValueError, match="price_vanilla_cv prices calls"):
        tvariance.price_vanilla_cv(put, 1 << 12, 1, cfg)
    geo = from_reference(dataclasses.replace(ARI, average="geometric"))
    with pytest.raises(ValueError, match="prices the arithmetic average"):
        tvariance.price_asian_cv(geo, 1 << 12, 1, cfg)
    with pytest.raises(TypeError, match="no control variate"):
        tvariance.cv_setup(CvaSpec(
            0.03, 0.6, from_reference(VAN), 10), 1 << 12, cfg)
