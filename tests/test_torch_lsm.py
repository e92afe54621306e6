"""K50's and K51's plain versions against the JAX Longstaff-Schwartz kernels
in interpret mode (CPU), the operand tables against ``mctpu``'s, the rule
fit against ``mctpu.lsm.fit_exercise_rule`` on the same normals, and the
block-offset contract.

Both packages draw the same Philox stream and read the same rule: ``beta``
is ``mctpu``'s own fit (float64, rounded to float32 by both).  K50's ``(B,
2)`` partials agree at ``rtol=2e-5`` (other summation orders, XLA's and
libm's ``exp``/``log`` an ulp apart at most).  K51's ``(B, 8)`` ``(sum x,
sum x^2)`` pairs are held by ``tests/torch_tolerance.py``'s scaled bound
at ``rtol=2e-5``.  An exercise decision that flipped on an ulp would move a
block sum by a whole cashflow (about 5e-4 of it at 2048 units a block), so
these tolerances also count flips: none is allowed.  Each case runs 2
blocks of ``rows=8`` (one interpret-mode trace a case).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mctpu import lsm as jlsm
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import lsm as jklsm
from mctpu_torch import lsm as tlsm
from mctpu_torch.kernels import lsm as tklsm
from mctpu_torch.types import from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(50)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8

CASES = {
    # name: (n_steps, payoff, antithetic, kahan, iters)
    "n7_put": (7, "put", False, True, 1),
    "n7_call_antithetic": (7, "call", True, True, 1),
    "n7_put_f32_2iters": (7, "put", False, False, 2),
    "n1_put": (1, "put", False, True, 1),
}
GREEK_CASES = {
    "n7_put_antithetic": (7, "put", True, True, 1),
    "n7_call": (7, "call", False, True, 1),
}


def _beta(opt):
    """``mctpu``'s float64 rule for ``opt`` on a 2^12-path pilot."""
    if opt.n_steps == 1:
        return np.zeros((0, 4))
    return np.asarray(jlsm.fit_exercise_rule(
        opt.s, opt.k, opt.r, opt.v, opt.t, jax.random.key(7), 1 << 12,
        opt.n_steps, opt.payoff, dtype=jnp.float64))


def _case(spec):
    n_steps, payoff, antithetic, kahan, iters = spec
    opt = jtypes.AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                n_steps=n_steps, payoff=payoff)
    paths = NB * iters * ROWS * 128 * (2 if antithetic else 1)
    jplan = jklsm.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tklsm.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    beta = _beta(opt)
    return opt, beta, jplan, tplan, tklsm.operands(from_reference(opt), beta,
                                                   "cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_lsm_kernel_matches_interpret_mode(case):
    opt, beta, jplan, tplan, ops = _case(CASES[case])
    put = opt.payoff == "put"
    want = np.asarray(jklsm.pallas_partials(opt, beta, SEED, 3, jplan, NB,
                                            opt.n_steps, put, interpret=True))
    got = tklsm.partials(ops, SEED, 3, tplan, NB, put)
    assert got.shape == (NB, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(GREEK_CASES))
def test_lsm_greek_kernel_matches_interpret_mode(case):
    opt, beta, jplan, tplan, ops = _case(GREEK_CASES[case])
    put = opt.payoff == "put"
    want = np.asarray(jklsm.greek_pallas_partials(
        opt, beta, SEED, 1, jplan, NB, opt.n_steps, put, interpret=True))
    got = tklsm.greek_partials(ops, SEED, 1, tplan, NB, put)
    assert got.shape == (NB, tklsm.N_GREEK_SUMS)
    assert_pairs_close(got.numpy(), want, tplan.iters * tplan.units_per_iter,
                       RTOL)
    # K51's price sums are K50's, bit for bit, on the same operands.
    price = tklsm.partials(ops, SEED, 1, tplan, NB, put)
    assert torch.equal(got[:, :2], price)


def _ulps(got, want):
    got = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    want = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return np.abs(got - want)


@pytest.mark.parametrize("n_steps,payoff", [(50, "put"), (13, "call"),
                                            (1, "put")])
def test_operand_tables_match_mctpu(n_steps, payoff):
    """The scalars and the df, vc, rhoc tables against ``mctpu``'s K50 and
    K51 wrappers' expressions in float32: the arithmetic scalars equal,
    the exp/log-derived entries within 1 ulp (XLA's and libm's ``exp`` and
    ``log`` may differ by one), beta's rows equal after the pad."""
    opt = jtypes.AmericanOption(100.0, 95.0, 0.05, 0.25, 1.5,
                                n_steps=n_steps, payoff=payoff)
    beta = _beta(opt)
    ops = tklsm.operands(from_reference(opt), beta, "cpu")
    with jax.enable_x64(False):
        s0, k, r, v, t = (jnp.asarray(x, jnp.float32)
                          for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
        dt = t / n_steps
        log_s0 = jnp.log(s0)
        df50 = jnp.exp(-r * dt * jnp.arange(1, n_steps + 1,
                                            dtype=jnp.float32))
        _, vc, rhoc, inv_v, psign = jklsm._greek_tables(
            k, r, v, t, n_steps, payoff == "put", jnp.float32, log_s0)
        exact = np.asarray(jnp.stack([s0, k, (r - 0.5 * v * v) * dt,
                                      v * jnp.sqrt(dt), 1.0 / k, inv_v,
                                      psign, 1.0 / s0]))
        want_tables = np.asarray(jnp.stack([df50, vc, rhoc]))
        want_log = np.asarray(log_s0)
    scal = ops.scal.numpy()
    np.testing.assert_array_equal(scal[:8], exact)
    assert _ulps(scal[8], want_log) <= 1
    # vc and rhoc are products of an exp/log-derived value: 1 ulp in, about
    # 2 out after the rounding of the products.
    assert (_ulps(ops.tables.numpy()[0], want_tables[0]) <= 1).all()
    assert (_ulps(ops.tables.numpy()[1:], want_tables[1:]) <= 2).all()
    assert ops.beta.shape == (n_steps, 4)
    np.testing.assert_array_equal(ops.beta.numpy()[:n_steps - 1],
                                  beta.astype(np.float32))
    assert not ops.beta[n_steps - 1:].any()


@pytest.mark.parametrize("payoff,n_steps", [("put", 10), ("call", 5),
                                            ("put", 2)])
def test_fit_matches_mctpu_on_the_same_normals(payoff, n_steps):
    """``mctpu``'s pilot normals fed to the port's fit: the same rule to
    rtol 1e-8 (float64 throughout; the normal-equation sums differ in
    order, and the 4x4 solves amplify that by their condition number)."""
    opt = jtypes.AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                n_steps=n_steps, payoff=payoff)
    k_fit = jax.random.key(11)
    n_pilot = 1 << 12
    want = np.asarray(jlsm.fit_exercise_rule(
        opt.s, opt.k, opt.r, opt.v, opt.t, k_fit, n_pilot, n_steps, payoff,
        dtype=jnp.float64))
    z = torch.as_tensor(np.array(jax.random.normal(
        k_fit, (n_steps, n_pilot), jnp.float64)))
    got = tlsm._fit_rule(opt.s, opt.k, opt.r, opt.v, opt.t, z, payoff)
    assert got.dtype == torch.float64 and got.shape == (n_steps - 1, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)


def test_block_offset_relabels_streams():
    opt = jtypes.AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=5)
    ops = tklsm.operands(from_reference(opt), _beta(opt), "cpu")
    plan = tklsm.make_plan(4 * 8 * 128, 4, 8, False)
    for fn in (tklsm.partials, tklsm.greek_partials):
        full = fn(ops, 9, 0, plan, 4, True)
        tail = fn(ops, 9, 2, plan, 2, True)
        assert torch.equal(full[2:], tail)


def test_unsupported_device_raises():
    opt = jtypes.AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=3)
    ops = tklsm.operands(from_reference(opt), _beta(opt), "meta")
    plan = tklsm.make_plan(8 * 128, 1, 8, False)
    with pytest.raises(ValueError, match="device"):
        tklsm.partials(ops, 9, 0, plan, 1, True)
    with pytest.raises(ValueError, match="device"):
        tklsm.greek_partials(ops, 9, 0, plan, 1, True)
