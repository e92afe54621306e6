"""The American path of the port (CPU): the engine tier against ``mctpu`` on
interpret-mode Pallas under ``mctpu``'s own rule and pricing stream, the
reference's statistical gates (``tests/test_american.py``,
``tests/test_greeks.py``'s ``TestEngineGreeksAmerican``) on the CPU at
2^13-2^15 paths, the dual bracket, the Heston American, the records.

Given ``mctpu``'s beta and ``seed = key_to_seed(k_price)``, K50's and K51's
plain versions draw ``mctpu``'s pricing stream, so the prices agree within
``rtol=1e-6`` (their block sums agree to float32 rounding, about 1e-7) and
``std_error`` within ``rtol=2e-5`` (a difference of the quadratic sums,
each held at 2e-5 per block).  Counts must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mctpu_torch
from mctpu import engine as jengine
from mctpu import lsm as jlsm
from mctpu import reference as jreference
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu_torch import engine as tengine
from mctpu_torch import lsm as tlsm
from mctpu_torch import math as tmath
from mctpu_torch.types import (AmericanBounds, AmericanOption, GreeksResult,
                               HestonOption, McResult, from_reference)

KEY = jax.random.key(606)
JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=4,
                            rows=8)
TCFG = mctpu_torch.EngineConfig(num_blocks=4, rows=8, device="cpu")
CPU = mctpu_torch.EngineConfig(num_blocks=16, rows=8, device="cpu")
PUT = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=50, payoff="put")
CRR = tmath.binomial_american(100.0, 100.0, 0.05, 0.2, 1.0, 2000, "put")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The gates run many small float64 torch operations; beside other
    test workers, torch's per-process thread pool oversubscribes the cores
    and stalls them (the bracket test ran many times its solo time in the
    six-worker Tier-1 run), so this module runs torch on one thread and
    restores the setting after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mctpu_rule(opt, n_paths, key):
    """``mctpu``'s fit and the pricing seed its engine tier runs on."""
    k_fit, k_price = jax.random.split(jax.random.fold_in(key, tlsm.FIT_WORD))
    beta = np.asarray(jlsm.fit_exercise_rule(
        opt.s, opt.k, opt.r, opt.v, opt.t, k_fit, min(n_paths, 1 << 15),
        opt.n_steps, opt.payoff, dtype=jnp.float64))
    return beta, int(jrng.key_to_seed(k_price))


def _close(got, want, rtol_se=2e-5):
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    np.testing.assert_allclose(float(got.price), float(want.price), rtol=1e-6)
    np.testing.assert_allclose(float(got.std_error), float(want.std_error),
                               rtol=rtol_se)


@pytest.mark.parametrize("payoff,n_steps,antithetic", [
    ("put", 8, True), ("call", 5, False), ("put", 1, True)])
def test_engine_tier_matches_mctpu(payoff, n_steps, antithetic):
    jopt = jtypes.AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                 n_steps=n_steps, payoff=payoff)
    n = 1 << 13
    want = jlsm.price_american(jopt, n, KEY, antithetic=antithetic,
                               config=JCFG)
    beta, seed = _mctpu_rule(jopt, n, KEY)
    got = tlsm._price_forward_engine(from_reference(jopt), beta, seed, n,
                                     TCFG, antithetic)
    _close(got, want)


@pytest.mark.parametrize("payoff", ["put", "call"])
def test_greeks_american_matches_mctpu(payoff):
    jopt = jtypes.AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=6,
                                 payoff=payoff)
    n = 1 << 13
    want = jengine.greeks_american(jopt, n, KEY, JCFG)
    beta, seed = _mctpu_rule(jopt, n, KEY)
    topt = from_reference(jopt)
    got = tengine._greeks_american_run(
        topt, *tengine.american_setup(topt, beta, n, TCFG), seed)
    for name in ("price", "delta", "vega", "rho"):
        _close(getattr(got, name), getattr(want, name))


def test_greeks_american_at_zero_vol_matches_mctpu():
    """``v = 0``: every path is the forward, K51's ``inv_v = 1 / v`` is
    infinite and the vega integrand ``wp (log_s inv_v + vc)`` is NaN in
    both packages; there is no guard in either.  The identical per-path
    cashflows make the float32 block sums' rounding the only difference,
    so price, delta and rho are held at rtol 1e-5."""
    jopt = jtypes.AmericanOption(100.0, 110.0, 0.05, 0.0, 1.0, n_steps=8)
    n = 1 << 13
    want = jengine.greeks_american(jopt, n, jax.random.key(3), JCFG)
    beta, seed = _mctpu_rule(jopt, n, jax.random.key(3))
    topt = from_reference(jopt)
    got = tengine._greeks_american_run(
        topt, *tengine.american_setup(topt, beta, n, TCFG), seed)
    assert np.isnan(float(want.vega.price)) and np.isnan(
        float(got.vega.price))
    for name in ("price", "delta", "rho"):
        np.testing.assert_allclose(float(getattr(got, name).price),
                                   float(getattr(want, name).price),
                                   rtol=1e-5)


def test_price_equals_pricer_bit_for_bit():
    """greeks_american's price sums are price_american's K50 sums at the
    same seed, rule and plan (``antithetic=config.antithetic``)."""
    opt = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=9)
    for anti in (False, True):
        cfg = dataclasses.replace(TCFG, antithetic=anti)
        g = mctpu_torch.greeks_american(opt, 1 << 13, 21, cfg)
        p = mctpu_torch.price_american(opt, 1 << 13, 21, antithetic=anti,
                                       config=cfg)
        assert float(g.price.sum_p) == float(p.sum_p)
        assert float(g.price.sum_p2) == float(p.sum_p2)
        assert float(g.price.price) == float(p.price)
    assert isinstance(mctpu_torch.greeks(opt, 1 << 12, 21, TCFG),
                      GreeksResult)


# ---- the reference's gates (tests/test_american.py) on the CPU -----------

def test_put_matches_binomial():
    res = mctpu_torch.price_american(PUT, 1 << 15, 606, device="cpu")
    assert abs(float(res.price) - CRR) < 4 * float(res.std_error) + 0.02


def test_call_equals_european():
    opt = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=25,
                         payoff="call")
    res = mctpu_torch.price_american(opt, 1 << 15, 606, device="cpu")
    bs = float(tmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    assert abs(float(res.price) - bs) < 4 * float(res.std_error) + 0.02


def test_put_above_european_put():
    res = mctpu_torch.price_american(PUT, 1 << 15, 606, device="cpu")
    eur = float(tmath.bs_put(100.0, 100.0, 0.05, 0.2, 1.0))
    assert float(res.price) > eur + 3 * float(res.std_error)


def test_deep_itm_put_exercises_immediately():
    opt = AmericanOption(50.0, 100.0, 0.10, 0.2, 1.0, n_steps=50)
    res = mctpu_torch.price_american(opt, 1 << 14, 606, device="cpu")
    assert float(res.price) == pytest.approx(50.0, abs=0.5)


def test_reproducible_and_honest_second_moment():
    a = mctpu_torch.price_american(PUT, 1 << 13, 606, device="cpu")
    b = mctpu_torch.price_american(PUT, 1 << 13, 606, device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.sum_p2) > 0
    n, s, s2 = a.n, float(a.sum_p), float(a.sum_p2)
    want_se = np.sqrt(max(n * s2 - s * s, 0.0) / (n * (n - 1.0)) / n)
    assert float(a.std_error) == pytest.approx(want_se, rel=1e-10)


def test_out_of_sample_rule_is_low_biased():
    res = mctpu_torch.price_american(PUT, 1 << 15, 7, pilot_paths=1 << 10,
                                     device="cpu")
    assert float(res.price) < CRR + 3 * float(res.std_error)


def test_f32_path_option():
    res = mctpu_torch.price_american(PUT, 1 << 14, 606, dtype=torch.float32,
                                     device="cpu")
    assert abs(float(res.price) - CRR) < 4 * float(res.std_error) + 0.03


def test_single_step_prices_the_european_put():
    one = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=1)
    eur = float(tmath.bs_put(100.0, 100.0, 0.05, 0.2, 1.0))
    res = mctpu_torch.price_american(one, 1 << 14, 606, device="cpu")
    assert abs(float(res.price) - eur) < 4 * float(res.std_error)
    eng = mctpu_torch.price_american(one, 1 << 14, 606, config=CPU)
    assert abs(float(eng.price) - eur) < 5 * float(eng.std_error)


def test_engine_tier_gates():
    """The oracle tier within 5 combined standard errors, the lattice gate
    of a lower bound (3 standard errors above, 0.06 below CRR-1000), the
    antithetic variant within 0.08 and the call at 20 dates within 5
    standard errors of Black-Scholes."""
    base = mctpu_torch.price_american(PUT, 1 << 15, 606, device="cpu")
    eng = mctpu_torch.price_american(PUT, 1 << 15, 606, antithetic=False,
                                     config=CPU)
    se = float(np.hypot(float(base.std_error), float(eng.std_error)))
    assert abs(float(base.price) - float(eng.price)) < 5 * se
    bino = tmath.binomial_american(100.0, 100.0, 0.05, 0.2, 1.0, 1000, "put")
    assert float(eng.price) < bino + 3 * float(eng.std_error)
    assert float(eng.price) > bino - 0.06
    anti = mctpu_torch.price_american(PUT, 1 << 14, 606, config=CPU)
    assert abs(float(anti.price) - bino) < 0.08
    call = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=20,
                          payoff="call")
    res = mctpu_torch.price_american(call, 1 << 15, 606, antithetic=False,
                                     config=CPU)
    bs = float(tmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    assert abs(float(res.price) - bs) < 5 * float(res.std_error)


def test_fit_seed_is_folded_and_device_free():
    """The rule comes from ``seed`` folded with 0x15A1, not from ``seed``'s
    own stream, and a repeated fit is the same bits."""
    a = tlsm.fit_exercise_rule(100.0, 100.0, 0.05, 0.2, 1.0, 5, 1 << 11, 6,
                               "put", device="cpu")
    b = tlsm.fit_exercise_rule(100.0, 100.0, 0.05, 0.2, 1.0, 5, 1 << 11, 6,
                               "put", device="cpu")
    assert torch.equal(a, b)
    z = tlsm._normal(tlsm._generator(5, tlsm.FIT_WORD), (6, 1 << 11),
                     torch.float64, "cpu")
    assert torch.equal(a, tlsm._fit_rule(100.0, 100.0, 0.05, 0.2, 1.0, z,
                                         "put"))
    assert not torch.equal(z, tlsm._normal(tlsm._generator(5), (6, 1 << 11),
                                           torch.float64, "cpu"))


# ---- the Greeks' gates (tests/test_greeks.py) on the CPU -----------------

@pytest.fixture(scope="module")
def bino_fd():
    def fd(h, **kw):
        def at(sign):
            p = dict(s=100.0, r=0.05, v=0.2)
            for name, dh in kw.items():
                p[name] += sign * dh
            return tmath.binomial_american(p["s"], 100.0, p["r"], p["v"], 1.0,
                                           4000, "put")
        return (at(1) - at(-1)) / (2 * h)

    return {"delta": fd(0.25, s=0.25), "vega": fd(0.005, v=0.005),
            "rho": fd(0.002, r=0.002)}


def test_greeks_match_binomial(bino_fd):
    res = mctpu_torch.greeks_american(PUT, 1 << 15, 606, CPU)
    for name in ("delta", "vega"):
        r = getattr(res, name)
        z = (float(r.price) - bino_fd[name]) / float(r.std_error)
        assert abs(z) < 4.0, (name, float(r.price), bino_fd[name])
    # rho carries the frozen rule's boundary term: 0.5 on top of the CI.
    assert abs(float(res.rho.price) - bino_fd["rho"]) < \
        4 * float(res.rho.std_error) + 0.5
    assert res.theta is None and res.gamma is None


def test_call_greeks_match_black_scholes():
    call = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=20,
                          payoff="call")
    cf = tmath.bs_greeks(100.0, 100.0, 0.05, 0.2, 1.0)
    g = mctpu_torch.greeks_american(call, 1 << 15, 606, CPU)
    for name in ("delta", "vega", "rho"):
        r = getattr(g, name)
        z = (float(r.price) - float(cf[name])) / float(r.std_error)
        assert abs(z) < 4.0, (name, float(r.price), float(cf[name]))


# ---- the dual bracket and the Heston American ------------------------------

def test_bracket_contains_crr():
    b = mctpu_torch.price_american_bounds(PUT, 1 << 15, 31, n_sub=64,
                                          device="cpu")
    crr = tmath.binomial_american(100.0, 100.0, 0.05, 0.2, 1.0, 4000, "put")
    lo = float(b.lower.price) - float(b.lower.ci)
    hi = float(b.upper.price) + float(b.upper.ci)
    assert lo <= crr <= hi, (lo, crr, hi)
    assert b.gap < 0.005 * crr + float(b.lower.ci) + float(b.upper.ci)
    assert b.upper.n == 1 << 13


def test_call_bracket_is_tight():
    call = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=20,
                          payoff="call")
    b = mctpu_torch.price_american_bounds(call, 1 << 15, 31, n_sub=32,
                                          device="cpu")
    bs = float(tmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    lo = float(b.lower.price) - float(b.lower.ci)
    hi = float(b.upper.price) + float(b.upper.ci)
    assert lo < hi and lo <= bs <= hi
    assert b.gap < 0.01 * bs


def test_engine_lower_bound_is_price_american():
    opt = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=10)
    cfg = mctpu_torch.EngineConfig(num_blocks=8, rows=8, device="cpu")
    b = mctpu_torch.price_american_bounds(opt, 1 << 13, 31, n_sub=16,
                                          config=cfg)
    direct = mctpu_torch.price_american(opt, 1 << 13, 31, config=cfg)
    assert float(b.lower.price) == float(direct.price)
    assert set(b.to_dict()) == {"lower", "upper", "gap"}
    assert "gap=" in repr(b)


def _heston(**kw):
    base = dict(s=100.0, k=100.0, r=0.05, t=1.0, v0=0.04, kappa=1.5,
                theta=0.04, xi=0.5, rho=-0.7)
    base.update(kw)
    return HestonOption(**base)


def test_heston_early_exercise_premium_positive():
    from mctpu_torch.models import heston as mheston
    opt = _heston()
    res = mctpu_torch.price_american_heston(opt, 1 << 15, 12, n_steps=50,
                                            device="cpu")
    eur_put = mheston.cf_call_price(opt) - 100.0 + 100.0 * np.exp(-0.05)
    assert float(res.price) > eur_put + 3 * float(res.std_error)


def test_heston_xi_zero_limit_is_gbm_american():
    opt = _heston(xi=1e-4, rho=0.0, kappa=2.0)
    res = mctpu_torch.price_american_heston(opt, 1 << 15, 13, n_steps=50,
                                            device="cpu")
    crr = tmath.binomial_american(100.0, 100.0, 0.05, 0.2, 1.0, 50, "put")
    assert abs(float(res.price) - crr) < 4 * float(res.std_error) + 0.02


@pytest.mark.parametrize("scheme", ["qe", "euler"])
def test_heston_deep_itm_and_single_step(scheme):
    res = mctpu_torch.price_american_heston(_heston(s=50.0, r=0.10), 1 << 13,
                                            14, n_steps=25, scheme=scheme,
                                            device="cpu")
    assert float(res.price) == pytest.approx(50.0, abs=0.5)
    one = mctpu_torch.price_american_heston(_heston(), 1 << 12, 14,
                                            n_steps=1, scheme=scheme,
                                            device="cpu")
    assert np.isfinite(float(one.price))


# ---- records --------------------------------------------------------------

@pytest.mark.parametrize("bad,match", [
    (dict(payoff="straddle"), "payoff"), (dict(n_steps=0), "n_steps"),
    (dict(s=-1.0), "positive"), (dict(v=-0.1), "volatility"),
    (dict(t=0.0), "maturity")])
def test_validate_messages_match_mctpu(bad, match):
    args = dict(s=100.0, k=100.0, r=0.05, v=0.2, t=1.0, n_steps=50,
                payoff="put")
    args.update(bad)
    with pytest.raises(ValueError, match=match) as want:
        jtypes.AmericanOption(**args).validate()
    with pytest.raises(ValueError) as got:
        AmericanOption(**args).validate()
    assert str(got.value) == str(want.value)


def test_from_reference_round_trip():
    jopt = jtypes.AmericanOption(100.0, 95.0, 0.05, 0.2, 1.0, n_steps=13,
                                 payoff="call")
    got = from_reference(jopt)
    assert isinstance(got, AmericanOption) and type(got.n_steps) is int
    assert dataclasses.astuple(got) == (100.0, 95.0, 0.05, 0.2, 1.0, 13,
                                        "call")
    jb = jlsm.AmericanBounds(
        lower=jlsm.McResult(price=1.0, ci=0.1, std_error=0.05, sum_p=2.0,
                            sum_p2=4.0, n=2, n_paths=4),
        upper=jlsm.McResult(price=1.5, ci=0.2, std_error=0.1, sum_p=3.0,
                            sum_p2=9.0, n=2, n_paths=2))
    b = from_reference(jb)
    assert isinstance(b, AmericanBounds) and isinstance(b.lower, McResult)
    assert b.gap == pytest.approx(jb.gap) and b.to_dict() == jb.to_dict()


def test_binomial_matches_reference():
    for payoff in ("put", "call"):
        assert tmath.binomial_american(100.0, 95.0, 0.05, 0.25, 1.5, 500,
                                       payoff) == \
            jreference.binomial_american(100.0, 95.0, 0.05, 0.25, 1.5, 500,
                                         payoff)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mctpu_torch.price_american(PUT, 1 << 10, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        mctpu_torch.price_american_heston(_heston(), 1 << 10, 1)
