"""The variance swap of the port against mctpu (CPU), GBM and Heston legs:
K19's and K20's plain versions against the JAX kernels in interpret mode,
the entry points against ``mctpu.engine`` on interpret-mode Pallas, the
scalars, the exact-zero delta and the refusal of other records.

Both packages draw the walk kernels' Philox stream.  K19's ``(B, 2)``
partials agree at ``rtol=2e-5`` (other summation orders); K20's ``(B, 8)``
``(sum x, sum x^2)`` pairs by the scaled bound of
``tests/torch_tolerance.py`` at ``rtol=2e-5``: the vega integrand ``(A -
drift B) / v - v dt B`` cancels, so a plain relative bound would test the
cancellation, not the port.  Each case runs 2 blocks of ``rows=8`` for
one or two iterations at up to 13 dates; the scalars are bitwise.  The
Heston leg walks K27's Euler step: its realized variance at ``rtol=2e-5``,
its Greeks' rv and rho pairs by the scaled bound at 2e-5 and the variance
tangents' at ``TANGENT_RTOL`` (``tests/test_torch_heston.py`` says why).
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
from mctpu.kernels import varswap as jvarswap
from mctpu_torch import engine as tengine
from mctpu_torch.kernels import varswap as tvarswap
from mctpu_torch.types import GreeksResult, HestonGreeksResult, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
TANGENT_RTOL = 1e-3
KEY = jax.random.key(252)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8
OPT = jtypes.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)

CASES = {
    # name: (n_obs, antithetic, kahan, iters)
    "n1": (1, False, True, 1),
    "n6_2iters": (6, False, True, 2),
    "n7_antithetic": (7, True, True, 1),
    "n13_f32": (13, False, False, 1),
    "n5_antithetic_f32_2iters": (5, True, False, 2),
}


def _plans(antithetic, kahan, iters):
    paths = NB * iters * ROWS * 128 * (2 if antithetic else 1)
    jplan = jvarswap.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tvarswap.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.iters == iters
    return jplan, tplan


@pytest.mark.parametrize("greeks", [False, True], ids=["K19", "K20"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case, greeks):
    n_obs, antithetic, kahan, iters = CASES[case]
    jplan, tplan = _plans(antithetic, kahan, iters)
    topt = from_reference(OPT)
    if greeks:
        want = np.asarray(jvarswap.greek_pallas_partials(
            OPT, SEED, 1, jplan, NB, n_obs=n_obs, dynamics="gbm",
            interpret=True))
        got = tvarswap.greek_partials(tvarswap.greek_params(topt, n_obs,
                                                            "cpu"),
                                      SEED, 1, tplan, NB, n_obs)
        assert got.shape == (NB, tvarswap.N_GREEK_SUMS_GBM)
        assert_pairs_close(got.numpy(), want,
                           tplan.iters * tplan.units_per_iter, RTOL)
    else:
        want = np.asarray(jvarswap.pallas_partials(
            OPT, SEED, 1, jplan, NB, n_obs=n_obs, dynamics="gbm",
            interpret=True))
        got = tvarswap.partials(tvarswap.params(topt, n_obs, "cpu"), SEED, 1,
                                tplan, NB, n_obs)
        assert got.shape == (NB, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def _jax_scalars(opt, n_obs, greeks):
    """K19's and K20's float32 ``scal`` as the JAX kernels form them
    (``varswap.py:190-195``, ``:447-452``)."""
    o = opt.astype(jnp.float32)
    inv_t = 1.0 / jnp.asarray(o.t, jnp.float32)
    if greeks:
        dt = jnp.asarray(o.t, jnp.float32) / n_obs
        return jnp.stack([inv_t, (o.r - 0.5 * o.v * o.v) * dt,
                          o.v * jnp.sqrt(dt), o.v, dt])
    dt = o.t / n_obs
    return jnp.stack([inv_t, (o.r - 0.5 * o.v * o.v) * dt,
                      o.v * jnp.sqrt(dt)])


@pytest.mark.parametrize("n_obs", [1, 7, 12, 13, 52, 252])
def test_scalars_match_kernel_prep(n_obs):
    """The scalars, bit for bit, as JAX forms them eagerly (as
    ``pallas_partials`` does, operation by operation as the source writes
    them).  Under ``jit`` (as ``mctpu.engine`` forms them) XLA's CPU
    compiler takes ``t / n`` as ``t * (1 / n)`` and contracts ``r - 0.5 v
    v`` into a fused multiply-add, which moves the drift, ``dt`` or the vol
    of some inputs by one or two ulps (the drift at every n here): held to
    two ulps."""
    opt = jtypes.VanillaOption(100.0, 95.0, 0.03, 0.27, 1.7)
    topt = from_reference(opt)
    for greeks, got in ((False, tvarswap.params(topt, n_obs, "cpu")),
                        (True, tvarswap.greek_params(topt, n_obs, "cpu"))):
        assert got.dtype == torch.float32
        with jax.enable_x64(False):
            eager = np.asarray(_jax_scalars(opt, n_obs, greeks))
            jitted = np.asarray(jax.jit(
                lambda o, g=greeks: _jax_scalars(o, n_obs, g))(opt))
        np.testing.assert_array_equal(got.numpy(), eager)
        np.testing.assert_array_max_ulp(got.numpy(), jitted, maxulp=2)


@pytest.mark.parametrize("greeks", [False, True], ids=["K19", "K20"])
def test_block_offset_relabels_streams(greeks):
    opt = from_reference(OPT)
    plan = tvarswap.make_plan(4 * 2 * ROWS * 128, 4, ROWS, False)
    if greeks:
        par, fn = (tvarswap.greek_params(opt, 5, "cpu"),
                   tvarswap.greek_partials)
    else:
        par, fn = tvarswap.params(opt, 5, "cpu"), tvarswap.partials
    full = fn(par, 9, 0, plan, 4, 5)
    tail = fn(par, 9, 2, plan, 2, 5)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


TCFG = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu")


@pytest.mark.parametrize("antithetic", [False, True])
def test_entry_points_match_mctpu(antithetic):
    n, n_obs = 1 << 12, 7
    jcfg = jengine.EngineConfig(backend="pallas", interpret=True,
                                num_blocks=4, rows=8, antithetic=antithetic)
    tcfg = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu",
                                antithetic=antithetic)
    topt = from_reference(OPT)
    want = jengine.fair_variance_strike(OPT, n, KEY, jcfg, n_obs=n_obs)
    got = mctpu_torch.fair_variance_strike(topt, n, SEED, tcfg, n_obs=n_obs)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for field in ("price", "std_error", "ci"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=RTOL)
    gwant = jengine.greeks_varswap(OPT, n, KEY, jcfg, n_obs=n_obs)
    ggot = mctpu_torch.greeks_varswap(topt, n, SEED, tcfg, n_obs=n_obs)
    assert isinstance(ggot, GreeksResult)
    for f in ("price", "vega", "rho", "theta"):
        r, w = getattr(ggot, f), getattr(gwant, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        assert_pairs_close([[float(r.sum_p), float(r.sum_p2)]],
                           [[float(w.sum_p), float(w.sum_p2)]], w.n, 1e-5)
    # Spot delta is an exact 0 +- 0 in both packages; no gamma.
    for res in (ggot.delta, gwant.delta):
        assert float(res.price) == 0.0 and float(res.std_error) == 0.0
    assert ggot.gamma is None
    # The same per-path realized variances, summed in another order.
    np.testing.assert_allclose(float(ggot.price.price), float(got.price),
                               rtol=1e-6)


def test_fair_strike_matches_exact_oracle():
    """The fair strike within 4 standard errors of ``v^2 + (r - v^2/2)^2
    T / n``, with and without antithetic pairs (statistical; the realized
    variance is about even in z, so the pairs do not cut its error)."""
    opt = from_reference(OPT)
    n, n_obs = 1 << 15, 12
    cfg = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")
    plain = mctpu_torch.fair_variance_strike(opt, n, SEED, cfg, n_obs=n_obs)
    anti = mctpu_torch.fair_variance_strike(
        opt, n, SEED, tengine.EngineConfig(num_blocks=8, rows=8,
                                           device="cpu", antithetic=True),
        n_obs=n_obs)
    want = 0.2 ** 2 + (0.05 - 0.5 * 0.2 ** 2) ** 2 / n_obs
    for res in (plain, anti):
        assert abs(float(res.price) - want) < 4 * float(res.std_error)
    assert (anti.n, anti.n_paths) == (n // 2, n)


@pytest.mark.parametrize("record", [
    mctpu_torch.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0),
    mctpu_torch.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, 130.0),
    mctpu_torch.BarrierBook.serving(2),
], ids=["asian", "barrier", "barrier_book"])
def test_other_records_are_refused(record):
    for fn in (mctpu_torch.fair_variance_strike, mctpu_torch.greeks_varswap):
        with pytest.raises(TypeError, match="VanillaOption .* HestonOption"):
            fn(record, 1 << 10, SEED, TCFG)


def test_n_obs_and_validation():
    opt = from_reference(OPT)
    with pytest.raises(ValueError, match="n_obs"):
        mctpu_torch.fair_variance_strike(opt, 1 << 10, SEED, TCFG, n_obs=0)
    bad = mctpu_torch.VanillaOption(100.0, 100.0, 0.05, 0.2, 0.0)
    with pytest.raises(ValueError) as want:
        jtypes.VanillaOption(100.0, 100.0, 0.05, 0.2, 0.0).validate()
    with pytest.raises(ValueError) as got:
        mctpu_torch.greeks_varswap(bad, 1 << 10, SEED, TCFG)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The Heston leg (dynamics="heston"): K27's Euler step and stream
# ---------------------------------------------------------------------------

HOPT = jtypes.HestonOption(s=100.0, k=100.0, r=0.03, t=1.0, v0=0.09,
                           kappa=2.0, theta=0.09, xi=0.4, rho=-0.6)
HESTON_CASES = {
    # name: (option, n_obs, antithetic, kahan, iters)
    "n1": (HOPT, 1, False, True, 1),
    "n8_antithetic": (HOPT, 8, True, True, 1),
    "n5_f32_2iters_feller_violated": (
        jtypes.HestonOption(100.0, 100.0, 0.03, 1.0, 0.04, 1.5, 0.04, 0.5,
                            -0.7), 5, False, False, 2),
    "n6_antithetic_2iters": (HOPT, 6, True, True, 2),
}
# K20's Heston pairs: rv, dv0, dtheta, dkappa, dxi, rho.
HESTON_GREEK_RTOLS = (RTOL,) + (TANGENT_RTOL,) * 4 + (RTOL,)


@pytest.mark.parametrize("greeks", [False, True], ids=["K19", "K20"])
@pytest.mark.parametrize("case", sorted(HESTON_CASES))
def test_heston_partials_match_interpret_mode(case, greeks):
    opt, n_obs, antithetic, kahan, iters = HESTON_CASES[case]
    jplan, tplan = _plans(antithetic, kahan, iters)
    topt = from_reference(opt)
    if greeks:
        want = np.asarray(jvarswap.greek_pallas_partials(
            opt, SEED, 1, jplan, NB, n_obs=n_obs, dynamics="heston",
            interpret=True))
        got = tvarswap.greek_partials(
            tvarswap.heston_greek_params(topt, n_obs, "cpu"), SEED, 1, tplan,
            NB, n_obs)
        assert got.shape == (NB, tvarswap.N_GREEK_SUMS_HESTON)
        assert_pairs_close(got.numpy(), want,
                           tplan.iters * tplan.units_per_iter,
                           HESTON_GREEK_RTOLS)
    else:
        want = np.asarray(jvarswap.pallas_partials(
            opt, SEED, 1, jplan, NB, n_obs=n_obs, dynamics="heston",
            interpret=True))
        got = tvarswap.partials(tvarswap.heston_params(topt, n_obs, "cpu"),
                                SEED, 1, tplan, NB, n_obs)
        assert got.shape == (NB, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("n_obs", [1, 13, 252])
def test_heston_scalars_match_kernel_prep(n_obs):
    """The Heston leg's scalars bit for bit as the JAX kernels form them
    eagerly (``varswap.py:197-201``, ``:455-459``; the roots correctly
    rounded in both)."""
    topt = from_reference(HOPT)
    with jax.enable_x64(False):
        o = HOPT.astype(jnp.float32)
        inv_t = 1.0 / jnp.asarray(o.t, jnp.float32)
        dt = o.t / n_obs
        tail = [o.kappa * dt, o.theta, o.xi, o.rho,
                jnp.sqrt(1.0 - o.rho * o.rho), o.r * dt, jnp.sqrt(dt)]
        price = np.asarray(jnp.stack([inv_t, o.s, o.v0] + tail))
        greek = np.asarray(jnp.stack([inv_t, o.v0] + tail + [0.5 * dt, dt]))
    np.testing.assert_array_equal(
        tvarswap.heston_params(topt, n_obs, "cpu").numpy(), price)
    np.testing.assert_array_equal(
        tvarswap.heston_greek_params(topt, n_obs, "cpu").numpy(), greek)


@pytest.mark.parametrize("greeks", [False, True], ids=["K19", "K20"])
def test_heston_block_offset_relabels_streams(greeks):
    opt = from_reference(HOPT)
    plan = tvarswap.make_plan(4 * 2 * ROWS * 128, 4, ROWS, False)
    if greeks:
        par, fn = (tvarswap.heston_greek_params(opt, 5, "cpu"),
                   tvarswap.greek_partials)
    else:
        par, fn = tvarswap.heston_params(opt, 5, "cpu"), tvarswap.partials
    full = fn(par, 9, 0, plan, 4, 5)
    tail = fn(par, 9, 2, plan, 2, 5)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


@pytest.mark.parametrize("cap", [0, 1, 1 << 20])
@pytest.mark.parametrize("leg", ["gbm", "heston"])
def test_partials_scratch_cap_runs_plain_on_cpu(leg, cap):
    """On the CPU, K19's wrapper runs the plain version whatever the
    scratch cap of its split walk (a CUDA-only argument)."""
    plan = tvarswap.make_plan(2 * 2 * ROWS * 128 * 2, 2, ROWS, True)
    assert plan.iters == 2
    par = (tvarswap.heston_params(from_reference(HOPT), 6, "cpu")
           if leg == "heston"
           else tvarswap.params(from_reference(OPT), 6, "cpu"))
    got = tvarswap.partials(par, SEED, 1, plan, 2, 6, scratch_cap=cap)
    want = tvarswap.plain_partials(par, SEED, 1, plan, 2, 6)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cap", [0, 1, 1 << 20])
def test_greek_partials_scratch_cap_runs_plain_on_cpu(cap):
    """On the CPU, K20's wrapper runs the plain version whatever the
    scratch cap of its Heston leg's split walk (a CUDA-only argument)."""
    plan = tvarswap.make_plan(2 * 2 * ROWS * 128 * 2, 2, ROWS, True)
    assert plan.iters == 2
    gp = tvarswap.heston_greek_params(from_reference(HOPT), 6, "cpu")
    got = tvarswap.greek_partials(gp, SEED, 1, plan, 2, 6, scratch_cap=cap)
    want = tvarswap.greek_plain_partials(gp, SEED, 1, plan, 2, 6)
    assert torch.equal(got, want)


@pytest.mark.parametrize("antithetic", [False, True])
def test_heston_entry_points_match_mctpu(antithetic):
    n, n_obs = 1 << 12, 5
    jcfg = jengine.EngineConfig(backend="pallas", interpret=True,
                                num_blocks=4, rows=8, antithetic=antithetic)
    tcfg = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu",
                                antithetic=antithetic)
    topt = from_reference(HOPT)
    want = jengine.fair_variance_strike(HOPT, n, KEY, jcfg, n_obs=n_obs)
    got = mctpu_torch.fair_variance_strike(topt, n, SEED, tcfg, n_obs=n_obs)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for field in ("price", "std_error", "ci"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=RTOL)
    gwant = jengine.greeks_varswap(HOPT, n, KEY, jcfg, n_obs=n_obs)
    ggot = mctpu_torch.greeks_varswap(topt, n, SEED, tcfg, n_obs=n_obs)
    assert isinstance(ggot, HestonGreeksResult)
    for f, rtol in (("price", 1e-5), ("vega", TANGENT_RTOL),
                    ("dtheta", TANGENT_RTOL), ("dkappa", TANGENT_RTOL),
                    ("dxi", TANGENT_RTOL), ("rho", 1e-5)):
        r, w = getattr(ggot, f), getattr(gwant, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        assert_pairs_close([[float(r.sum_p), float(r.sum_p2)]],
                           [[float(w.sum_p), float(w.sum_p2)]], w.n, rtol)
    for res in (ggot.delta, gwant.delta):
        assert float(res.price) == 0.0 and float(res.std_error) == 0.0
    assert ggot.theta is None and ggot.gamma is None
    # The same per-path realized variances, summed in another order.
    np.testing.assert_allclose(float(ggot.price.price), float(got.price),
                               rtol=1e-6)


def test_heston_fair_strike_near_the_continuous_limit():
    """Statistical, 2^15 paths at 52 dates: within 4 standard errors plus
    the discrete-sampling and Euler gap (5e-4) of ``theta + (v0 -
    theta)(1 - e^{-kappa T}) / (kappa T)``."""
    opt = from_reference(dataclasses.replace(HOPT, v0=0.04))
    cfg = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")
    res = mctpu_torch.fair_variance_strike(opt, 1 << 15, SEED, cfg, n_obs=52)
    kt = opt.kappa * opt.t
    want = opt.theta + (opt.v0 - opt.theta) * (1 - np.exp(-kt)) / kt
    assert abs(float(res.price) - want) < 4 * float(res.std_error) + 5e-4
