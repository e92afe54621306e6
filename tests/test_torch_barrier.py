"""The knock-out barrier path of the port against mctpu (CPU): K12's and
K13's plain versions against the JAX kernels in interpret mode, the engine
entry points against ``mctpu.engine`` on interpret-mode Pallas, the
closed forms, and the CRN delta of the autodiff tier.

Both packages draw the same Philox stream.  K12's ``(B, 2)`` partials
agree at ``rtol=2e-5``; K13's ``(B, 8)`` ``(sum x, sum x^2)`` pairs by the
scaled bound of ``tests/torch_tolerance.py`` at ``rtol=2e-5``: the LR
vega integrand ``p (z2s / v - zs sqrt(dt) - n / v)`` cancels heavily, so a
plain relative bound would test the cancellation, not the port.  Each case
runs 2 blocks of ``rows=8`` for one or two iterations.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import mctpu_torch
from mctpu import engine as jengine
from mctpu import math as jmath
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import barrier as jbarrier
from mctpu_torch import autodiff
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import barrier as tbarrier
from mctpu_torch.types import GreeksResult, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(29)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8

CASES = {
    # name: (n_obs, kind, barrier, antithetic, kahan, iters)
    "n1_up": (1, "up-and-out", 115.0, False, True, 1),
    "n6_down_2iters": (6, "down-and-out", 90.0, False, True, 2),
    "n7_up_antithetic": (7, "up-and-out", 120.0, True, True, 1),
    "n7_down_antithetic_f32": (7, "down-and-out", 90.0, True, False, 1),
    "n6_up_f32_2iters": (6, "up-and-out", 120.0, False, False, 2),
}


def _case(case):
    n_obs, kind, h, antithetic, kahan, iters = CASES[case]
    opt = jtypes.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, h, n_obs=n_obs,
                               kind=kind)
    paths = NB * iters * ROWS * 128 * (2 if antithetic else 1)
    jplan = jbarrier.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tbarrier.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    return opt, jplan, tplan, from_reference(opt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case):
    opt, jplan, tplan, topt = _case(case)
    want = np.asarray(jbarrier.pallas_partials(opt, SEED, 1, jplan, NB,
                                               interpret=True))
    got = tbarrier.partials(tbarrier.params(topt, "cpu"), SEED, 1, tplan, NB,
                            opt.n_obs, opt.kind == "up-and-out")
    assert got.shape == (NB, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greek_partials_match_interpret_mode(case):
    opt, jplan, tplan, topt = _case(case)
    want = np.asarray(jbarrier.greek_pallas_partials(opt, SEED, 1, jplan, NB,
                                                     interpret=True))
    got = tbarrier.greek_partials(tbarrier.greek_params(topt, "cpu"), SEED,
                                  1, tplan, NB, opt.n_obs,
                                  opt.kind == "up-and-out")
    assert got.shape == (NB, tbarrier.N_GREEK_SUMS)
    assert_pairs_close(got.numpy(), want,
                       tplan.iters * tplan.units_per_iter, RTOL)


def test_greek_scalars_match():
    opt = jtypes.BarrierOption(100.0, 95.0, 0.05, 0.25, 1.5, 130.0, n_obs=50)
    with jax.enable_x64(False):
        c = jbarrier._greek_scalars(opt.astype(np.float32), opt.n_obs,
                                    np.float32)
        want = [np.log(np.float32(100.0)), np.float32(95.0),
                np.log(np.float32(130.0))]
        want += [np.asarray(c[k]) for k in ("drift", "vol", "c_d", "inv_v",
                                            "sqdt", "n_over_v", "c_r", "t")]
    got = tbarrier.greek_params(from_reference(opt), "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.float32))
    np.testing.assert_array_equal(
        tbarrier.params(from_reference(opt), "cpu").numpy(), got[:5].numpy())


@pytest.mark.parametrize("greeks", [False, True], ids=["K12", "K13"])
def test_block_offset_relabels_streams(greeks):
    opt = from_reference(jtypes.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                              115.0, n_obs=5))
    plan = tbarrier.make_plan(4 * 2 * ROWS * 128, 4, ROWS, False)
    if greeks:
        par, fn = tbarrier.greek_params(opt, "cpu"), tbarrier.greek_partials
    else:
        par, fn = tbarrier.params(opt, "cpu"), tbarrier.partials
    full = fn(par, 9, 0, plan, 4, opt.n_obs, True)
    tail = fn(par, 9, 2, plan, 2, opt.n_obs, True)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


@pytest.mark.parametrize("h", [110.0, 130.0, 1e7])
def test_closed_forms_match(h):
    for up in (True, False):
        np.testing.assert_allclose(
            float(tmath.barrier_continuity_correction(h, 100.0, 0.2, 1.0, 50,
                                                      up=up)),
            float(jmath.barrier_continuity_correction(h, 100.0, 0.2, 1.0, 50,
                                                      up=up)), rtol=1e-12)
    np.testing.assert_allclose(
        float(tmath.up_and_out_call(100.0, 95.0, 0.05, 0.2, 1.0, h)),
        float(jmath.up_and_out_call(100.0, 95.0, 0.05, 0.2, 1.0, h)),
        rtol=1e-12)


def test_up_and_out_knocked_out_regions_are_zero():
    assert float(tmath.up_and_out_call(130.0, 100.0, 0.05, 0.2, 1.0,
                                       120.0)) == 0.0
    assert float(tmath.up_and_out_call(100.0, 130.0, 0.05, 0.2, 1.0,
                                       120.0)) == 0.0


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=4,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu")


@pytest.mark.parametrize("kind,h", [("up-and-out", 120.0),
                                    ("down-and-out", 90.0)])
def test_price_and_greeks_barrier_match_mctpu(kind, h):
    opt = jtypes.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, h, n_obs=6,
                               kind=kind)
    n = 1 << 12
    want = jengine.price_barrier(opt, n, KEY, JCFG)
    got = mctpu_torch.price_barrier(from_reference(opt), n, SEED, TCFG)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for field in ("price", "std_error", "ci"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=RTOL)
    gwant = jengine.greeks_barrier(opt, n, KEY, JCFG)
    ggot = mctpu_torch.greeks_barrier(from_reference(opt), n, SEED, TCFG)
    for f in ("price", "delta", "vega", "rho"):
        r, w = getattr(ggot, f), getattr(gwant, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        assert_pairs_close([[float(r.sum_p), float(r.sum_p2)]],
                           [[float(w.sum_p), float(w.sum_p2)]], w.n, 1e-5)
    # Same per-path payoffs; the two sum them in other orders.
    np.testing.assert_allclose(float(ggot.price.price), float(got.price),
                               rtol=1e-6)


def test_greeks_dispatcher_and_validation():
    opt = mctpu_torch.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, 120.0,
                                    n_obs=3)
    g = mctpu_torch.greeks(opt, 1 << 10, SEED, TCFG)
    assert isinstance(g, GreeksResult) and g.rho is not None
    assert g.gamma is None
    with pytest.raises(ValueError, match="knocked out"):
        mctpu_torch.price_barrier(dataclasses.replace(opt, s=125.0), 1 << 10,
                                  SEED, TCFG)


def test_crn_delta_matches_bgk_finite_difference():
    """CRN central differences of the port's price_barrier against the
    finite difference of the BGK-corrected closed form (the gate of
    tests/test_greeks.py; statistical)."""
    opt = mctpu_torch.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, 130.0,
                                    n_obs=50)

    def cf(s):
        beff = tmath.barrier_continuity_correction(130.0, s, 0.2, 1.0, 50)
        return float(tmath.up_and_out_call(s, 100.0, 0.05, 0.2, 1.0, beff))

    want = cf(100.5) - cf(99.5)
    cfg = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")
    got = autodiff.barrier_delta_crn(opt, 1 << 16, SEED, cfg)
    assert got == pytest.approx(want, abs=0.02)
