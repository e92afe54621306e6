"""Heston pricing and Greeks of the port against mctpu (CPU): K27's and
K28's plain versions against the JAX kernels in interpret mode, the
scalars, the characteristic-function oracle, the entry points against
``mctpu.engine`` on interpret-mode Pallas, the records and the autodiff
tier.

Both packages draw the same stream: one Philox block per step, its two
Box-Muller branches ``z_v`` and ``z_perp``.  They agree to a tolerance, not
bit for bit: on the CPU ``torch.sqrt``, ``torch.exp`` and ``torch.log`` are
not XLA's to the ulp, XLA contracts multiply-adds into FMAs under ``jit``,
and the port takes ``1 / sqrt(vp)`` where ``mctpu`` takes ``rsqrt(vp)``.
K27's ``(B, 2)`` partials are held at ``rtol=2e-5`` (a path whose QE
variance sits at the ``psi = 1.5`` switch or whose payoff sits at the
strike may land on the other side; the block sums absorb it).  K28's
``(sum x, sum x^2)`` pairs are held by the scaled bound of
``tests/torch_tolerance.py``; see :func:`test_greek_partials_match_
interpret_mode` for the variance tangents.  Each case runs 2 blocks of
``rows=8`` for one or two iterations at up to 8 steps.
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
from mctpu.kernels import heston as jheston
from mctpu.models import heston as jmheston
from mctpu_torch import autodiff
from mctpu_torch import engine as tengine
from mctpu_torch.kernels import heston as theston
from mctpu_torch.models import heston as tmheston
from mctpu_torch.types import HestonGreeksResult, HestonOption, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
TANGENT_RTOL = 1e-3  # see test_greek_partials_match_interpret_mode
KEY = jax.random.key(1234)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8
# tests/test_heston.py's option and its Feller-violating QE option; the
# Greeks' option of tests/test_greeks.py (2 kappa theta = 0.36 > xi^2).
OPT = jtypes.HestonOption(s=100.0, k=100.0, r=0.05, t=1.0, v0=0.04,
                          kappa=2.0, theta=0.04, xi=0.3, rho=-0.7)
STEEP = jtypes.HestonOption(s=100.0, k=100.0, r=0.03, t=1.0, v0=0.04,
                            kappa=1.5, theta=0.04, xi=0.5, rho=-0.7)
GOPT = jtypes.HestonOption(s=100.0, k=100.0, t=1.0, r=0.03, v0=0.09,
                           kappa=2.0, theta=0.09, xi=0.4, rho=-0.6)

CASES = {
    # name: (option, scheme, n_steps, antithetic, kahan, iters)
    "euler_n7": (OPT, "euler", 7, False, True, 1),
    "euler_n8_antithetic_2iters": (OPT, "euler", 8, True, True, 2),
    "euler_n5_f32": (STEEP, "euler", 5, False, False, 1),
    "qe_n8": (STEEP, "qe", 8, False, True, 1),
    "qe_n7_antithetic_f32": (STEEP, "qe", 7, True, False, 1),
    "qe_n4_2iters": (OPT, "qe", 4, False, True, 2),
    "qe_n4_antithetic_2iters": (OPT, "qe", 4, True, True, 2),
}


def _plans(antithetic, kahan, iters):
    paths = NB * iters * ROWS * 128 * (2 if antithetic else 1)
    jplan = jheston.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = theston.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.iters == iters
    return jplan, tplan


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case):
    opt, scheme, n_steps, antithetic, kahan, iters = CASES[case]
    jplan, tplan = _plans(antithetic, kahan, iters)
    want = np.asarray(jheston.pallas_partials(
        opt, SEED, 1, jplan, NB, n_steps, interpret=True, scheme=scheme))
    par = theston.params(from_reference(opt), n_steps, scheme == "qe", "cpu")
    got = theston.partials(par, SEED, 1, tplan, NB, n_steps, scheme == "qe")
    assert got.shape == (NB, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


GREEK_CASES = {
    # name: (option, n_steps, antithetic, kahan, iters)
    "n6": (GOPT, 6, False, True, 1),
    "n7_antithetic": (GOPT, 7, True, True, 1),
    "n4_f32_2iters": (OPT, 4, False, False, 2),
    # The vp = 0 guard at the first step, and a vol-of-vol that drives v
    # below 0 on many paths (the m mask).
    "v0_zero": (dataclasses.replace(GOPT, v0=0.0), 6, False, True, 1),
    "large_xi": (dataclasses.replace(GOPT, xi=1.2), 8, False, True, 1),
}
# K28's pairs: p, delta, vega (v0), rho, dtheta, dkappa, dxi; vega, dtheta,
# dkappa and dxi are the variance tangents.
GREEK_RTOLS = (RTOL, RTOL, TANGENT_RTOL, RTOL, TANGENT_RTOL, TANGENT_RTOL,
               TANGENT_RTOL)


@pytest.mark.parametrize("case", sorted(GREEK_CASES))
def test_greek_partials_match_interpret_mode(case):
    """The price, delta and rho pairs by the scaled pair bound at
    ``rtol=2e-5`` (measured: 2.3e-7), the variance tangents' at
    ``TANGENT_RTOL``: their step divides by ``sqrt(vp)``, so on a path whose
    variance comes near 0 a tangent moves by about ``(ulp of v) / v``
    relative when XLA's fused multiply-add moves ``v`` by an ulp, and one
    such path can hold a fifth of its block's ``sum x^2`` (measured, in
    units of the bound's scale: up to 3e-6 on a ``sum x`` and 9.3e-5 on a
    ``sum x^2`` in these cases, 2.8e-4 in
    :func:`test_greeks_heston_matches_mctpu` and 3.1e-4 in the variance
    swap's Heston Greeks, ``tests/test_torch_varswap.py``)."""
    opt, n_steps, antithetic, kahan, iters = GREEK_CASES[case]
    jplan, tplan = _plans(antithetic, kahan, iters)
    want = np.asarray(jheston.greek_pallas_partials(
        opt, SEED, 1, jplan, NB, n_steps, interpret=True))
    gp = theston.greek_params(from_reference(opt), n_steps, "cpu")
    got = theston.greek_partials(gp, SEED, 1, tplan, NB, n_steps).numpy()
    assert got.shape == (NB, theston.N_GREEK_SUMS)
    assert_pairs_close(got, want, tplan.iters * tplan.units_per_iter,
                       GREEK_RTOLS)


@pytest.mark.parametrize("kind", ["euler", "qe", "greeks"])
def test_block_offset_relabels_streams(kind):
    opt = from_reference(STEEP)
    plan = theston.make_plan(4 * 2 * ROWS * 128, 4, ROWS, False)
    if kind == "greeks":
        par = theston.greek_params(opt, 5, "cpu")

        def fn(off, n):
            return theston.greek_partials(par, 9, off, plan, n, 5)
    else:
        par = theston.params(opt, 5, kind == "qe", "cpu")

        def fn(off, n):
            return theston.partials(par, 9, off, plan, n, 5, kind == "qe")
    full = fn(0, 4)
    tail = fn(2, 2)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


def _jax_scalars(opt, n_steps):
    """K27's and K28's float32 scalars as ``mctpu.kernels.heston`` forms
    them (``heston.py:587-602``, ``:386-394``)."""
    o = opt.astype(jnp.float32)
    dt = o.t / n_steps
    euler = [o.s, o.k, o.v0, o.kappa * dt, o.theta, o.xi, o.rho,
             jnp.sqrt(1.0 - o.rho * o.rho), o.r * dt, jnp.sqrt(dt)]
    qe_c = jmheston.qe_constants(opt, n_steps, jnp.float32)
    qe = [jnp.asarray(qe_c[name], jnp.float32) for name in jheston._QE_KEYS]
    greek = euler + [0.5 * dt, o.t * o.k, dt]
    return jnp.stack(euler), jnp.stack(qe), jnp.stack(greek)


# Of the QE constants, e = exp(-kappa dt) and c1, c2 (through 1 - e) take
# an exp, which torch and XLA round differently on the CPU; the others are
# sums and products only.
_QE_EXP = [0, 1, 2]


@pytest.mark.parametrize("n_steps", [1, 7, 16, 100])
@pytest.mark.parametrize("opt", [OPT, STEEP, GOPT], ids=["opt", "steep",
                                                         "gopt"])
def test_scalars_match_kernel_prep(opt, n_steps):
    """The Euler and Greek scalars bit for bit as JAX forms them eagerly
    (the roots correctly rounded in both); the QE constants bit for bit but
    ``e``, ``c1`` and ``c2``, which take an exp: ``e`` within 1 ulp, ``c1``
    and ``c2`` within 2 ulps plus the cancellation of ``1 - e`` (an ulp of
    ``e`` is ``ulp(1) / (1 - e)`` ulps of ``1 - e``)."""
    topt = from_reference(opt)
    par = theston.params(topt, n_steps, True, "cpu")
    gp = theston.greek_params(topt, n_steps, "cpu")
    assert par.dtype == gp.dtype == torch.float32
    with jax.enable_x64(False):
        euler, qe, greek = (np.asarray(x) for x in _jax_scalars(opt, n_steps))
    np.testing.assert_array_equal(par[:10].numpy(), euler)
    np.testing.assert_array_equal(gp.numpy(), greek)
    np.testing.assert_array_equal(np.delete(par[10:].numpy(), _QE_EXP),
                                  np.delete(qe, _QE_EXP))
    e = float(qe[0])
    amp = int(np.ceil(np.spacing(np.float32(1.0)) / (1.0 - e)
                      / np.spacing(np.float32(1.0 - e))))
    np.testing.assert_array_max_ulp(par[10].numpy(), qe[0], maxulp=1)
    np.testing.assert_array_max_ulp(par[11:13].numpy(), qe[1:3],
                                    maxulp=2 + amp)
    # The Euler scheme ships zeros where K27 has the QE constants.
    zero = theston.params(topt, n_steps, False, "cpu")
    assert torch.equal(zero[:10], par[:10])
    assert not zero[10:].any()


def test_qe_zeros_survive_degenerate_parameters():
    """``kappa = 0`` or ``xi = 0`` make the QE constants inf or NaN; the
    Euler scheme never forms them."""
    for bad in (dict(kappa=0.0), dict(xi=0.0)):
        opt = from_reference(dataclasses.replace(OPT, **bad))
        assert torch.isfinite(theston.params(opt, 8, False, "cpu")).all()


@pytest.mark.parametrize("opt", [OPT, STEEP, GOPT,
                                 dataclasses.replace(OPT, xi=1e-6, rho=0.0),
                                 dataclasses.replace(STEEP, k=80.0, t=2.5)],
                         ids=["opt", "steep", "gopt", "bs_limit", "itm_2y"])
def test_cf_call_price_matches_mctpu(opt):
    want = float(jmheston.cf_call_price(opt))
    got = tmheston.cf_call_price(from_reference(opt))
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


def test_qe_step_matches_mctpu():
    """One QE step on a grid of variances across both branches and the
    mass at zero, in float64 with the exact CDF, as the autodiff tier takes
    it."""
    rng = np.random.default_rng(7)
    v = rng.uniform(0.0, 0.2, 4096)
    v[:64] = 0.0
    z_v, z_s = rng.standard_normal((2, 4096))
    from mctpu import math as jmath
    from mctpu_torch import math as tmath
    with jax.enable_x64(True):
        jc = jmheston.qe_constants(STEEP, 16, jnp.float64)
        jx, jv = jmheston.qe_step(jnp.zeros(4096), jnp.asarray(v),
                                  jnp.asarray(z_v), jnp.asarray(z_s), jc,
                                  jmath.norm_cdf)
        jx, jv = np.asarray(jx), np.asarray(jv)
    tc = tmheston.qe_constants(from_reference(STEEP), 16, torch.float64)
    tx, tv = tmheston.qe_step(torch.zeros(4096, dtype=torch.float64),
                              torch.tensor(v), torch.tensor(z_v),
                              torch.tensor(z_s), tc, tmath.norm_cdf)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=1e-12, atol=1e-15)
    assert (jv == 0).any() and (jv > 0).any()  # both ends of the exp branch


# ---------------------------------------------------------------------------
# Entry points against mctpu.engine (backend="pallas", interpret=True)
# ---------------------------------------------------------------------------

def _configs(antithetic=False):
    return (jengine.EngineConfig(backend="pallas", interpret=True,
                                 num_blocks=4, rows=8, antithetic=antithetic),
            tengine.EngineConfig(num_blocks=4, rows=8, device="cpu",
                                 antithetic=antithetic))


def _same_estimate(got, want, rtol):
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for field in ("price", "std_error", "ci"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=rtol)


@pytest.mark.parametrize("scheme,antithetic", [("euler", False),
                                               ("qe", False),
                                               ("euler", True)])
def test_price_heston_matches_mctpu(scheme, antithetic):
    jcfg, tcfg = _configs(antithetic)
    n, n_steps = 1 << 12, 6
    want = jengine.price_heston(STEEP, n, KEY, jcfg, n_steps=n_steps,
                                scheme=scheme)
    got = mctpu_torch.price_heston(from_reference(STEEP), n, SEED, tcfg,
                                   n_steps=n_steps, scheme=scheme)
    _same_estimate(got, want, RTOL)


def test_greeks_heston_matches_mctpu():
    """Every output's combined ``(sum x, sum x^2)`` by the scaled bound,
    at 1e-5 for the price, delta and rho and ``TANGENT_RTOL`` for the
    variance tangents (as the partials); the dispatcher sends a
    ``HestonOption`` here; the price is ``price_heston``'s paths, with
    ``half_dt vp`` for ``0.5 vp sqdt^2``."""
    jcfg, tcfg = _configs()
    n, n_steps = 1 << 12, 6
    topt = from_reference(GOPT)
    want = jengine.greeks_heston(GOPT, n, KEY, jcfg, n_steps=n_steps)
    got = mctpu_torch.greeks_heston(topt, n, SEED, tcfg, n_steps=n_steps)
    assert isinstance(got, HestonGreeksResult)
    for f in ("price", "delta", "vega", "rho", "dtheta", "dkappa", "dxi"):
        r, w = getattr(got, f), getattr(want, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        tangent = f in ("vega", "dtheta", "dkappa", "dxi")
        assert_pairs_close([[float(r.sum_p), float(r.sum_p2)]],
                           [[float(w.sum_p), float(w.sum_p2)]], w.n,
                           TANGENT_RTOL if tangent else 1e-5)
    assert got.theta is None and got.gamma is None
    disp = mctpu_torch.greeks(topt, n, SEED, tcfg)
    assert isinstance(disp, HestonGreeksResult)
    price = mctpu_torch.price_heston(topt, n, SEED, tcfg, n_steps=100)
    assert float(disp.price.price) == pytest.approx(float(price.price),
                                                    rel=1e-4)
    # The result carried across from mctpu has the same fields and counts.
    carried = from_reference(want)
    assert isinstance(carried, HestonGreeksResult)
    assert carried.dxi.n == got.dxi.n
    assert float(carried.dxi.sum_p) == float(want.dxi.sum_p)


def test_validation_and_scheme_errors():
    cfg = _configs()[1]
    bads = [dict(s=0.0), dict(k=-1.0), dict(t=0.0), dict(v0=-0.1),
            dict(theta=-0.01), dict(kappa=-1.0), dict(xi=-0.2),
            dict(rho=1.5)]
    for bad in bads:
        jopt = dataclasses.replace(OPT, **bad)
        with pytest.raises(ValueError) as want:
            jopt.validate()
        for fn in (mctpu_torch.price_heston, mctpu_torch.greeks_heston,
                   mctpu_torch.fair_variance_strike):
            with pytest.raises(ValueError) as got:
                fn(from_reference(jopt), 1 << 10, SEED, cfg)
            assert str(got.value) == str(want.value)
    opt = from_reference(OPT)
    with pytest.raises(ValueError, match="scheme"):
        mctpu_torch.price_heston(opt, 1 << 10, SEED, cfg, scheme="milstein")
    with pytest.raises(ValueError, match="n_steps"):
        mctpu_torch.price_heston(opt, 1 << 10, SEED, cfg, n_steps=0)
    with pytest.raises(ValueError, match="scheme"):
        autodiff.heston_greeks(opt, 16, torch.Generator().manual_seed(0),
                               n_steps=2, scheme="milstein")


def test_records_carry_across():
    opt = from_reference(GOPT)
    assert isinstance(opt, HestonOption)
    assert dataclasses.astuple(opt) == tuple(
        float(x) for x in dataclasses.astuple(GOPT))
    assert "HestonOption" in mctpu_torch.__all__
    assert "HestonGreeksResult" in mctpu_torch.__all__


def test_euler_and_qe_against_the_characteristic_function():
    """Statistical, at 2^15 paths on the CPU: QE at 16 steps on STEEP
    within 4 standard errors of the CF price (Euler there carries ~0.075
    of bias, mctpu's tests/test_heston.py), and Euler with xi = 0, v0 =
    theta exact against Black-Scholes (the log-Euler step of GBM has no
    bias)."""
    from mctpu_torch import math as tmath
    cfg = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")
    n = 1 << 15
    steep = from_reference(STEEP)
    qe = mctpu_torch.price_heston(steep, n, SEED, cfg, n_steps=16,
                                  scheme="qe")
    cf = tmheston.cf_call_price(steep)
    assert abs(float(qe.price) - cf) < 4 * float(qe.std_error)
    gbm = HestonOption(100.0, 100.0, 0.05, 1.0, 0.04, 2.0, 0.04, 0.0, -0.7)
    eu = mctpu_torch.price_heston(gbm, n, SEED, cfg, n_steps=16)
    bs = float(tmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    assert abs(float(eu.price) - bs) < 4 * float(eu.std_error)


@pytest.mark.parametrize("scheme,n_steps", [("qe", 24), ("euler", 64)])
def test_autodiff_heston_greeks_match_cf_differences(scheme, n_steps):
    """``mctpu``'s gate (``tests/test_greeks.py``: STEEP, QE at 24 steps,
    2^16 paths; delta within 0.02 of the CF central difference, dv0 within
    15%), on the same number of paths; Euler at 64 steps likewise.  dxi
    within 4 of its own standard errors plus 15% (a CRN bump of the same
    float64 walk)."""
    opt = from_reference(STEEP)
    n = 1 << 16
    g = autodiff.heston_greeks(opt, n, torch.Generator().manual_seed(3),
                               n_steps=n_steps, scheme=scheme)

    def cf(**bump):
        return tmheston.cf_call_price(dataclasses.replace(opt, **bump))

    fd_s = (cf(s=100.5) - cf(s=99.5)) / 1.0
    fd_v0 = (cf(v0=0.045) - cf(v0=0.035)) / 0.01
    assert float(g["delta"]) == pytest.approx(fd_s, abs=0.02)
    assert float(g["dv0"]) == pytest.approx(fd_v0, rel=0.15)
    assert float(g["price"]) == pytest.approx(cf(), rel=0.05)

    def bumped(xi):
        return float(autodiff.heston_greeks(
            dataclasses.replace(opt, xi=xi), n,
            torch.Generator().manual_seed(3), n_steps=n_steps,
            scheme=scheme)["price"])

    fd_xi = (bumped(0.5 + 1e-3) - bumped(0.5 - 1e-3)) / 2e-3
    assert float(g["dxi"]) == pytest.approx(fd_xi, rel=0.15, abs=1e-3)
