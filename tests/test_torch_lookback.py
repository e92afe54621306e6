"""The lookback path of the port against mctpu (CPU): K15's and K16's plain
versions against the JAX kernels in interpret mode, the engine entry points
against ``mctpu.engine`` on interpret-mode Pallas, the Goldman-Sosin-Gatto
closed form and its gradients, and the records.

Both packages draw the same Philox stream.  K15's ``(B, 2)`` partials agree
at ``rtol=2e-5`` (other summation orders, libm ``exp`` within an ulp);
K16's ``(B, 8)`` ``(sum x, sum x^2)`` pairs by the scaled bound of
``tests/torch_tolerance.py`` at ``rtol=2e-5``: the floating vega integrand
``s_T f_T - ext f_ext`` cancels, so a plain relative bound would test the
cancellation, not the port.  Each case runs 2 blocks of ``rows=8`` for one
or two iterations.
"""
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
from mctpu.kernels import lookback as jlookback
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import lookback as tlookback
from mctpu_torch.types import GreeksResult, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(37)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8

CASES = {
    # name: (n_obs, kind, payoff, k, antithetic, kahan, iters)
    "n7_floating_call": (7, "floating", "call", 0.0, False, True, 1),
    "n6_floating_put_2iters": (6, "floating", "put", 0.0, False, True, 2),
    "n7_fixed_call_antithetic": (7, "fixed", "call", 105.0, True, True, 1),
    "n6_fixed_put_f32": (6, "fixed", "put", 95.0, False, False, 1),
    "n1_fixed_call": (1, "fixed", "call", 103.0, False, True, 1),
    "n6_floating_call_antithetic_2iters": (6, "floating", "call", 0.0, True,
                                           True, 2),
}


def _case(case):
    n_obs, kind, payoff, k, antithetic, kahan, iters = CASES[case]
    opt = jtypes.LookbackOption(100.0, 0.05, 0.2, 1.0, k=k, n_obs=n_obs,
                                kind=kind, payoff=payoff)
    paths = NB * iters * ROWS * 128 * (2 if antithetic else 1)
    jplan = jlookback.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tlookback.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    topt = from_reference(opt)
    return opt, jplan, tplan, topt, tlookback.mode_of(topt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case):
    opt, jplan, tplan, topt, mode = _case(case)
    want = np.asarray(jlookback.pallas_partials(opt, SEED, 1, jplan, NB,
                                                interpret=True))
    got = tlookback.partials(tlookback.params(topt, "cpu"), SEED, 1, tplan,
                             NB, opt.n_obs, mode)
    assert got.shape == (NB, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greek_partials_match_interpret_mode(case):
    opt, jplan, tplan, topt, mode = _case(case)
    want = np.asarray(jlookback.greek_pallas_partials(opt, SEED, 1, jplan,
                                                      NB, interpret=True))
    got = tlookback.greek_partials(tlookback.greek_params(topt, "cpu"), SEED,
                                   1, tplan, NB, opt.n_obs, mode)
    assert got.shape == (NB, tlookback.N_GREEK_SUMS)
    assert_pairs_close(got.numpy(), want,
                       tplan.iters * tplan.units_per_iter, RTOL)


def test_modes():
    modes = {(kind, payoff): tlookback.mode_of(mctpu_torch.LookbackOption(
        100.0, 0.05, 0.2, 1.0, k=90.0, kind=kind, payoff=payoff))
        for kind in ("floating", "fixed") for payoff in ("call", "put")}
    assert modes == {("floating", "call"): 0, ("floating", "put"): 1,
                     ("fixed", "call"): 2, ("fixed", "put"): 3}


def test_scalars_match():
    """K15's and K16's scalars, formed as ``greek_pallas_partials`` forms
    them in float32."""
    opt = jtypes.LookbackOption(100.0, 0.05, 0.25, 1.5, k=95.0, n_obs=50,
                                kind="fixed", payoff="put")
    with jax.enable_x64(False):
        o = opt.astype(jnp.float32)
        dt = o.t / opt.n_obs
        drift = (o.r - 0.5 * o.v * o.v) * dt
        vol = o.v * jnp.sqrt(dt)
        inv_v = 1.0 / o.v
        c1 = -(o.r + 0.5 * o.v * o.v) * dt * inv_v
        want = np.array([jnp.log(o.s), o.s, o.k, drift, vol, inv_v, c1, dt,
                         o.t], np.float32)
    got = tlookback.greek_params(from_reference(opt), "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tlookback.params(from_reference(opt), "cpu").numpy(),
        want[[0, 2, 3, 4]])


@pytest.mark.parametrize("greeks", [False, True], ids=["K15", "K16"])
def test_block_offset_relabels_streams(greeks):
    opt = mctpu_torch.LookbackOption(100.0, 0.05, 0.2, 1.0, k=105.0, n_obs=5,
                                     kind="fixed")
    plan = tlookback.make_plan(4 * 2 * ROWS * 128, 4, ROWS, False)
    if greeks:
        par, fn = tlookback.greek_params(opt, "cpu"), tlookback.greek_partials
    else:
        par, fn = tlookback.params(opt, "cpu"), tlookback.partials
    full = fn(par, 9, 0, plan, 4, opt.n_obs, 2)
    tail = fn(par, 9, 2, plan, 2, opt.n_obs, 2)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


@pytest.mark.parametrize("cap", [0, 1, 1 << 20])
def test_partials_scratch_cap_runs_plain_on_cpu(cap):
    """On the CPU, K15's wrapper runs the plain version whatever the
    scratch cap of its split walk (a CUDA-only argument)."""
    opt = mctpu_torch.LookbackOption(100.0, 0.05, 0.2, 1.0, n_obs=6)
    plan = tlookback.make_plan(2 * 2 * ROWS * 128 * 2, 2, ROWS, True)
    assert plan.iters == 2
    par = tlookback.params(opt, "cpu")
    got = tlookback.partials(par, SEED, 1, plan, 2, 6, 0, scratch_cap=cap)
    want = tlookback.plain_partials(par, SEED, 1, plan, 2, 6, 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("s,r,v,t,m", [(100.0, 0.05, 0.2, 1.0, None),
                                       (100.0, 0.03, 0.35, 2.0, 90.0)])
def test_gsg_closed_form_and_gradients_match(s, r, v, t, m):
    want = float(jmath.lookback_floating_call(s, r, v, t, m))
    got = tmath.lookback_floating_call(s, r, v, t, m)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    jg = jax.grad(lambda a, b, c: jmath.lookback_floating_call(a, b, c, t, m),
                  argnums=(0, 1, 2))(s, r, v)
    xs = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
          for x in (s, r, v)]
    tg = torch.autograd.grad(tmath.lookback_floating_call(*xs, t, m), xs)
    np.testing.assert_allclose([float(x) for x in tg],
                               [float(x) for x in jg], rtol=1e-10)


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=4,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu")


@pytest.mark.parametrize("kind,payoff,k", [("floating", "call", 0.0),
                                           ("fixed", "put", 95.0)])
def test_price_and_greeks_lookback_match_mctpu(kind, payoff, k):
    opt = jtypes.LookbackOption(100.0, 0.05, 0.2, 1.0, k=k, n_obs=5,
                                kind=kind, payoff=payoff)
    n = 1 << 12
    want = jengine.price_lookback(opt, n, KEY, JCFG)
    got = mctpu_torch.price_lookback(from_reference(opt), n, SEED, TCFG)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for field in ("price", "std_error", "ci"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=RTOL)
    gwant = jengine.greeks_lookback(opt, n, KEY, JCFG)
    ggot = mctpu_torch.greeks_lookback(from_reference(opt), n, SEED, TCFG)
    for f in ("price", "delta", "vega", "rho"):
        r, w = getattr(ggot, f), getattr(gwant, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        assert_pairs_close([[float(r.sum_p), float(r.sum_p2)]],
                           [[float(w.sum_p), float(w.sum_p2)]], w.n, 1e-5)
    # The same per-path payoffs, summed in another order.
    np.testing.assert_allclose(float(ggot.price.price), float(got.price),
                               rtol=1e-6)
    if kind == "floating":  # homogeneity: delta == price / s0
        np.testing.assert_allclose(float(ggot.delta.price),
                                   float(ggot.price.price) / 100.0,
                                   rtol=1e-5)


def test_greeks_dispatcher():
    opt = mctpu_torch.LookbackOption(100.0, 0.05, 0.2, 1.0, n_obs=3)
    g = mctpu_torch.greeks(opt, 1 << 10, SEED, TCFG)
    assert isinstance(g, GreeksResult) and g.rho is not None
    assert g.gamma is None and g.theta is None


BAD = [dict(kind="american"), dict(payoff="straddle"), dict(n_obs=0),
       dict(s=-1.0), dict(kind="fixed", k=0.0), dict(v=-0.1), dict(t=0.0)]


@pytest.mark.parametrize("bad", BAD, ids=[next(iter(b)) + str(i)
                                          for i, b in enumerate(BAD)])
def test_validation_errors_match_mctpu(bad):
    base = dict(s=100.0, r=0.05, v=0.2, t=1.0, k=100.0)
    with pytest.raises(ValueError) as want:
        jtypes.LookbackOption(**{**base, **bad}).validate()
    opt = mctpu_torch.LookbackOption(**{**base, **bad})
    with pytest.raises(ValueError) as got:
        mctpu_torch.price_lookback(opt, 1 << 10, SEED, TCFG)
    assert str(got.value) == str(want.value)
