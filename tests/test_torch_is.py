"""K49's plain version against the JAX importance-sampling kernel in
interpret mode (CPU), the block-offset contract, ``price_vanilla_is``
against ``mctpu.variance.price_vanilla_is`` at the same stream, and the
reference's statistical gates (``tests/test_variance.py``'s
``TestImportanceSampling``) on the CPU.

Both packages draw K1's Philox stream and are fed the same float32 tilt.
The block sums ``(sum p, sum p^2)`` are held at ``rtol=2e-5``: the same
per-path values in other summation orders (and XLA's and libm's ``exp``,
an ulp apart at most).  Each case runs 2 blocks of ``rows=8`` (one
interpret-mode trace a case).
"""
import dataclasses

import jax
import numpy as np
import pytest

import mctpu_torch
from mctpu import engine as jengine
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu import variance as jvariance
from mctpu.kernels import vanilla as jvanilla
from mctpu.kernels import varred as jvr
from mctpu_torch import math as tmath
from mctpu_torch import variance as tvariance
from mctpu_torch.kernels import vanilla as tvanilla
from mctpu_torch.kernels import varred as tvr
from mctpu_torch.types import VanillaOption, from_reference

RTOL = 2e-5
SEED = int(jrng.key_to_seed(jax.random.key(49)))
NB, ROWS = 2, 8
CPU = mctpu_torch.EngineConfig(device="cpu")


def _opt(k):
    return jtypes.VanillaOption(100.0, k, 0.05, 0.2, 1.0)


@pytest.mark.parametrize("k,tilt,antithetic,kahan", [
    (100.0, "zero", False, True), (200.0, "optimal", False, True),
    (200.0, "optimal", True, False), (150.0, "1.5", True, True)])
def test_is_kernel_matches_interpret_mode(k, tilt, antithetic, kahan):
    opt = _opt(k)
    theta = {"zero": 0.0, "optimal": jvariance.optimal_tilt(opt),
             "1.5": 1.5}[tilt]
    paths = NB * 2 * 2 * ROWS * 128 * (2 if antithetic else 1)
    jplan = jvanilla.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tvanilla.make_plan(paths, NB, ROWS, antithetic, kahan)
    assert (tplan.iters, tplan.units_per_iter) == (jplan.iters,
                                                   jplan.units_per_iter)
    want = np.asarray(jvr.is_pallas_partials(opt, theta, SEED, 3, jplan, NB,
                                             interpret=True))
    par = tvr.is_params(from_reference(opt), theta, "cpu")
    got = tvr.is_partials(par, SEED, 3, tplan, NB)
    assert got.shape == (NB, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_is_params_round_theta_to_float32():
    par = tvr.is_params(VanillaOption(100.0, 200.0, 0.05, 0.2, 1.0),
                        0.1, "cpu")
    assert par.dtype.is_floating_point and par.shape == (5,)
    assert float(par[4]) == float(np.float32(0.1))
    np.testing.assert_array_equal(
        par[:4].numpy(),
        tvanilla.params(VanillaOption(100.0, 200.0, 0.05, 0.2, 1.0),
                        "cpu").numpy())


def test_block_offset_relabels_streams():
    plan = tvanilla.make_plan(4 * 2 * 8 * 128, 4, 8, False)
    par = tvr.is_params(VanillaOption(100.0, 150.0, 0.05, 0.2, 1.0), 1.0,
                        "cpu")
    full = tvr.is_partials(par, 9, 0, plan, 4)
    tail = tvr.is_partials(par, 9, 2, plan, 2)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


@pytest.mark.parametrize("k,antithetic", [(200.0, False), (130.0, True)])
def test_price_vanilla_is_matches_mctpu(k, antithetic):
    """The same stream (``key_to_seed`` of mctpu's key) and plan: price
    within rtol 1e-6, ``std_error`` within 2e-5, equal counts."""
    key = jax.random.key(23)
    jcfg = jengine.EngineConfig(backend="pallas", interpret=True,
                                num_blocks=4, rows=8, antithetic=antithetic)
    tcfg = mctpu_torch.EngineConfig(num_blocks=4, rows=8, device="cpu",
                                    antithetic=antithetic)
    want = jvariance.price_vanilla_is(_opt(k), 1 << 14, key, jcfg)
    got = tvariance.price_vanilla_is(from_reference(_opt(k)), 1 << 14,
                                     int(jrng.key_to_seed(key)), tcfg)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    np.testing.assert_allclose(float(got.price), float(want.price), rtol=1e-6)
    np.testing.assert_allclose(float(got.std_error), float(want.std_error),
                               rtol=2e-5)


@pytest.mark.parametrize("k", [100.0, 150.0, 200.0, 60.0])
def test_optimal_tilt_matches_mctpu(k):
    assert tvariance.optimal_tilt(from_reference(_opt(k))) == \
        pytest.approx(jvariance.optimal_tilt(_opt(k)), rel=1e-15, abs=0.0)


def test_unbiased_at_the_money():
    res = tvariance.price_vanilla_is(VanillaOption(100.0, 100.0, 0.05, 0.2,
                                                   1.0), 1 << 15, 7, CPU)
    bs = float(tmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    assert abs(float(res.price) - bs) < 4 * float(res.std_error)


def test_deep_otm_massive_variance_reduction():
    opt = VanillaOption(100.0, 200.0, 0.05, 0.2, 1.0)
    bs = float(tmath.bs_call(100.0, 200.0, 0.05, 0.2, 1.0))
    res = tvariance.price_vanilla_is(opt, 1 << 15, 4, CPU)
    assert abs(float(res.price) - bs) < 4 * float(res.std_error)
    mc = mctpu_torch.price_vanilla(opt, 1 << 15, 4, CPU)
    assert float(res.std_error) < float(mc.std_error) / 10


@pytest.mark.parametrize("theta", [0.5, 1.5, 3.0])
def test_custom_theta_still_unbiased(theta):
    opt = VanillaOption(100.0, 150.0, 0.05, 0.2, 1.0)
    bs = float(tmath.bs_call(100.0, 150.0, 0.05, 0.2, 1.0))
    res = tvariance.price_vanilla_is(opt, 1 << 15, 8, CPU, theta=theta)
    assert abs(float(res.price) - bs) < 5 * float(res.std_error)


def test_put_rejected():
    with pytest.raises(ValueError, match="call"):
        tvariance.price_vanilla_is(
            VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0, kind="put"), 1 << 12,
            0, CPU)


def test_validation_runs_first():
    with pytest.raises(ValueError, match="maturity"):
        tvariance.price_vanilla_is(
            dataclasses.replace(VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0),
                                t=-1.0), 1 << 12, 0, CPU)
