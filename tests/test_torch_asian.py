"""The Asian path of the port against mctpu (CPU): K9's and K10's plain
versions against the JAX kernels in interpret mode, the engine entry points
against ``mctpu.engine`` on interpret-mode Pallas, the geometric closed
form, and the autodiff tier.

Both packages draw the same Philox stream.  K9's ``(B, 2)`` partials agree
at ``rtol=2e-5`` (other summation orders, libm ``exp`` within an ulp).
K10's ``(B, 10)`` ``(sum x, sum x^2)`` pairs are held by the scaled bound
of ``tests/torch_tolerance.py`` at ``rtol=2e-5``, because a Greek's block
sum can nearly cancel.  Each case runs 2 blocks of ``rows=8`` for one or
two iterations (interpret-mode walks are slow).
"""
import jax
import numpy as np
import pytest
import torch

import mctpu_torch
from mctpu import engine as jengine
from mctpu import math as jmath
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import asian as jasian
from mctpu.models import asian as jmasian
from mctpu_torch import autodiff
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import asian as tasian
from mctpu_torch.models import asian as tmasian
from mctpu_torch.types import GreeksResult, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(23)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8

CASES = {
    # name: (n_obs, average, antithetic, kahan, iters)
    "n1_arithmetic": (1, "arithmetic", False, True, 1),
    "n6_geometric_2iters": (6, "geometric", False, True, 2),
    "n7_arithmetic_antithetic": (7, "arithmetic", True, True, 1),
    "n7_geometric_antithetic_f32": (7, "geometric", True, False, 1),
    "n6_arithmetic_f32_2iters": (6, "arithmetic", False, False, 2),
    # The per-iteration reseed under antithetic, which K10's fold replays
    # once an iteration.
    "n6_arithmetic_antithetic_2iters": (6, "arithmetic", True, True, 2),
}


def _case(case):
    n_obs, average, antithetic, kahan, iters = CASES[case]
    opt = jtypes.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=n_obs,
                             average=average)
    paths = NB * iters * ROWS * 128 * (2 if antithetic else 1)
    jplan = jasian.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tasian.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    return opt, jplan, tplan, from_reference(opt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case):
    opt, jplan, tplan, topt = _case(case)
    want = np.asarray(jasian.pallas_partials(opt, SEED, 1, jplan, NB,
                                             interpret=True))
    got = tasian.partials(tasian.params(topt, "cpu"), SEED, 1, tplan, NB,
                          opt.n_obs, opt.average == "geometric")
    assert got.shape == (NB, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greek_partials_match_interpret_mode(case):
    opt, jplan, tplan, topt = _case(case)
    want = np.asarray(jasian.greek_pallas_partials(opt, SEED, 1, jplan, NB,
                                                   interpret=True))
    got = tasian.greek_partials(tasian.greek_params(topt, "cpu"), SEED, 1,
                                tplan, NB, opt.n_obs,
                                opt.average == "geometric")
    assert got.shape == (NB, tasian.N_GREEK_SUMS)
    assert_pairs_close(got.numpy(), want,
                       tplan.iters * tplan.units_per_iter, RTOL)


def test_step_constants_match():
    opt = jtypes.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=50)
    with jax.enable_x64(False):
        want = jmasian.step_constants(opt.astype(np.float32), np.float32)
    got = tmasian.step_constants(from_reference(opt))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float(g) == float(w)


def test_path_payoff_matches():
    rng = np.random.default_rng(3)
    z = rng.standard_normal((7, 64))
    for average in ("arithmetic", "geometric"):
        opt = jtypes.AsianOption(100.0, 95.0, 0.05, 0.3, 1.5, n_obs=7,
                                 average=average)
        want = np.asarray(jmasian.path_payoff(opt, jax.numpy.asarray(z)))
        got = tmasian.path_payoff(from_reference(opt), torch.tensor(z))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("greeks", [False, True], ids=["K9", "K10"])
def test_block_offset_relabels_streams(greeks):
    opt = from_reference(jtypes.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                            n_obs=5))
    plan = tasian.make_plan(4 * 2 * ROWS * 128, 4, ROWS, False)
    if greeks:
        par, fn = tasian.greek_params(opt, "cpu"), tasian.greek_partials
    else:
        par, fn = tasian.params(opt, "cpu"), tasian.partials
    full = fn(par, 9, 0, plan, 4, opt.n_obs, False)
    tail = fn(par, 9, 2, plan, 2, opt.n_obs, False)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


@pytest.mark.parametrize("n_obs", [1, 12, 50])
def test_geometric_closed_form_matches(n_obs):
    np.testing.assert_allclose(
        float(tmath.geometric_asian_call(100.0, 95.0, 0.05, 0.3, 1.5, n_obs)),
        float(jmath.geometric_asian_call(100.0, 95.0, 0.05, 0.3, 1.5, n_obs)),
        rtol=1e-12)


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=4,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu")


@pytest.mark.parametrize("average", ["arithmetic", "geometric"])
def test_price_and_greeks_asian_match_mctpu(average):
    opt = jtypes.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=6,
                             average=average)
    n = 1 << 12
    want = jengine.price_asian(opt, n, KEY, JCFG)
    got = mctpu_torch.price_asian(from_reference(opt), n, SEED, TCFG)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for field in ("price", "std_error", "ci"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=RTOL)
    gwant = jengine.greeks_asian(opt, n, KEY, JCFG)
    ggot = mctpu_torch.greeks_asian(from_reference(opt), n, SEED, TCFG)
    for f in ("price", "delta", "vega", "rho", "gamma"):
        r, w = getattr(ggot, f), getattr(gwant, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        assert_pairs_close([[float(r.sum_p), float(r.sum_p2)]],
                           [[float(w.sum_p), float(w.sum_p2)]], w.n, 1e-5)
    # The Greeks walk forms the average as acc * f32(1/n), the pricer as
    # acc / n: an ulp per path, plus the rounding of f32(1/n) (up to 3e-8
    # relative), which the geometric average takes on a log-average of
    # size ln s0 before exp; so 1e-6 relative, times ln s0 there.
    rtol = 1e-6 * (np.log(100.0) if average == "geometric" else 1.0)
    np.testing.assert_allclose(float(ggot.price.price), float(got.price),
                               rtol=rtol)


def test_greeks_dispatcher_and_validation():
    opt = mctpu_torch.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=3)
    g = mctpu_torch.greeks(opt, 1 << 10, SEED, TCFG)
    assert isinstance(g, GreeksResult) and g.gamma is not None
    assert g.theta is None
    with pytest.raises(ValueError, match="average"):
        mctpu_torch.price_asian(mctpu_torch.AsianOption(
            100.0, 100.0, 0.05, 0.2, 1.0, average="harmonic"), 1 << 10,
            SEED, TCFG)


def test_autodiff_asian_greeks_match_closed_form():
    """Pathwise autograd through the walk against autograd of the exact
    geometric price (statistical: 2^17 paths, tolerances of
    tests/test_greeks.py)."""
    opt = mctpu_torch.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=12,
                                  average="geometric")
    mc = autodiff.asian_greeks(opt, 1 << 17, torch.Generator().manual_seed(2))
    s, v, r = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
               for x in (100.0, 0.2, 0.05))
    cf = tmath.geometric_asian_call(s, 100.0, r, v, 1.0, 12)
    d_s, d_v, d_r = torch.autograd.grad(cf, (s, v, r))
    assert float(mc["delta"]) == pytest.approx(float(d_s), abs=0.005)
    assert float(mc["vega"]) == pytest.approx(float(d_v), rel=0.02)
    assert float(mc["rho"]) == pytest.approx(float(d_r), rel=0.02)
    assert float(mc["price"]) == pytest.approx(float(cf.detach()), rel=0.01)
