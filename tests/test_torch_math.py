"""The port's closed forms, host setup math, compensated sums and estimator
against mctpu's.

Float64 oracles (Black-Scholes, CVA closed forms, default-leg weights, the
estimator) agree to 1e-12 relative — the same formulas, libm within an ulp.
The Hastings CDF in float32 (the kernels' CDF) agrees to 1e-6 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mctpu import estimator as jest
from mctpu import math as jmath
from mctpu.utils import accum as jaccum
from mctpu_torch import estimator as tmest
from mctpu_torch import math as tmath
from mctpu_torch.utils import accum as taccum

TIGHT = 1e-12


@pytest.mark.parametrize("s,k,r,v,t", [(100.0, 100.0, 0.048790, 0.2, 1.0),
                                       (90.0, 110.0, 0.01, 0.35, 2.5),
                                       (100.0, 80.0, 0.05, 0.2, 0.0)])
def test_black_scholes_matches(s, k, r, v, t):
    np.testing.assert_allclose(float(tmath.bs_call(s, k, r, v, t)),
                               float(jmath.bs_call(s, k, r, v, t)),
                               rtol=TIGHT)
    if t > 0:
        np.testing.assert_allclose(float(tmath.bs_put(s, k, r, v, t)),
                                   float(jmath.bs_put(s, k, r, v, t)),
                                   rtol=TIGHT)


@pytest.mark.parametrize("n_grid", [1, 10, 500])
def test_cva_closed_forms_match(n_grid):
    np.testing.assert_allclose(
        float(tmath.cva_closed_form(0.03, 0.6, 100.0, 100.0, 0.05, 0.2, 1.0,
                                    n_grid)),
        float(jmath.cva_closed_form(0.03, 0.6, 100.0, 100.0, 0.05, 0.2, 1.0,
                                    n_grid)), rtol=TIGHT)
    args = (0.03, 0.6, 100.0, 0.05, 0.2, 1.0, np.array([90.0, 110.0]),
            np.array([0.5, 1.5]), n_grid)
    np.testing.assert_allclose(float(tmath.cva_portfolio_closed_form(*args)),
                               float(jmath.cva_portfolio_closed_form(*args)),
                               rtol=TIGHT)
    np.testing.assert_allclose(
        tmath.default_leg_weights(0.03, 1.0, n_grid).numpy(),
        np.asarray(jmath.default_leg_weights(0.03, 1.0, n_grid,
                                             dtype=jnp.float64)), rtol=TIGHT)


def test_portfolio_closed_form_rejects_short_weights():
    with pytest.raises(ValueError):
        tmath.cva_portfolio_closed_form(0.03, 0.6, 100.0, 0.05, 0.2, 1.0,
                                        [100.0], [-1.0], 10)


def test_hastings_cdf_matches_in_float32():
    d = np.linspace(-8.0, 8.0, 4001, dtype=np.float32)
    want = np.asarray(jmath.norm_cdf_hastings(jnp.asarray(d)))
    got = tmath.norm_cdf_hastings(torch.tensor(d))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_compensated_sums_bit_equal():
    """Neumaier ``kahan_add``, ``two_sum`` and ``ds_add`` are IEEE adds in
    float32 in both packages, so they agree to the bit."""
    rng = np.random.default_rng(5)
    s, c, x = (rng.normal(size=4096).astype(np.float32) * m
               for m in (1e4, 1e-3, 1.0))
    j = jaccum.kahan_add((jnp.asarray(s), jnp.asarray(c)), jnp.asarray(x))
    t = taccum.kahan_add((torch.tensor(s), torch.tensor(c)), torch.tensor(x))
    j += jaccum.two_sum(jnp.asarray(s), jnp.asarray(x))
    t += taccum.two_sum(torch.tensor(s), torch.tensor(x))
    j += jaccum.ds_add(jnp.asarray(s), jnp.asarray(c), jnp.asarray(x))
    t += taccum.ds_add(torch.tensor(s), torch.tensor(c), torch.tensor(x))
    for got, want in zip(t, j):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_estimator_matches():
    rng = np.random.default_rng(4)
    partials = np.abs(rng.normal(size=(37, 2))) * 1e5
    want = jest.estimate(*jest.combine_block_partials(partials), 123456,
                         discount=0.95, n_paths=246912)
    got = tmest.estimate(*tmest.combine_block_partials(torch.tensor(partials)),
                         123456, discount=0.95, n_paths=246912)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for f in ("price", "ci", "std_error", "sum_p", "sum_p2"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=TIGHT)
