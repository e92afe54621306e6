"""K2/K3's plain version against the JAX basket kernels in interpret mode.

Both stream maps: asset-major (a <= 8, K2) and lane-packed (a > 8, K3).  The
same Cholesky factor (``mctpu.math.cholesky_lower`` in f64) feeds both
packages, so the comparison isolates the kernels.  ``rtol=2e-5``: same
draws, other summation orders (the TPU kernel's packed product is an MXU
matmul), libm ``exp``/``log`` within an ulp.
"""
import jax
import numpy as np
import pytest
import torch

from mctpu import math as jmath
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import basket as jbasket
from mctpu_torch import math as tmath
from mctpu_torch.kernels import basket as tbasket
from mctpu_torch.types import from_reference

RTOL = 2e-5
SEED = int(jrng.key_to_seed(jax.random.key(5)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The wide baskets' plain products beside other test workers: torch's
    per-process thread pool oversubscribes the cores, so this module runs
    torch on one thread and restores the setting after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _option(a):
    if a == 1:
        return jtypes.BasketOption(s=np.array([100.0]), v=np.array([0.2]),
                                   w=np.array([1.0]), corr=np.eye(1),
                                   d=np.zeros(1), k=100.0, r=0.048790, t=1.0)
    if a >= 100:
        return jtypes.BasketOption.equicorrelated(a)
    return jtypes.BasketOption.default_reference(a)


def _plans(a, nb, rows, iters, antithetic):
    probe = jbasket.make_plan(1, nb, rows, antithetic, n_assets=a)
    paths = nb * iters * probe.paths_per_iter
    jplan = jbasket.make_plan(paths, nb, rows, antithetic, n_assets=a)
    tplan = tbasket.make_plan(paths, nb, rows, antithetic, n_assets=a)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f)
    return jplan, tplan


@pytest.mark.parametrize("a,nb,iters", [(1, 2, 2), (3, 2, 2), (10, 2, 2),
                                        (100, 2, 1), (100, 2, 2),
                                        (129, 2, 1)])
@pytest.mark.parametrize("antithetic", [False, True])
def test_partials_match_interpret_mode(a, nb, iters, antithetic):
    opt = _option(a)
    chol = np.asarray(jmath.cholesky_lower(np.asarray(opt.corr)))
    jplan, tplan = _plans(a, nb, 8, iters, antithetic)
    want = np.asarray(jbasket.pallas_partials(opt, chol, SEED, 3, jplan, nb,
                                              interpret=True))
    ops = tbasket.operands(from_reference(opt), chol, "cpu")
    got = tbasket.partials(ops, SEED, 3, tplan, nb)
    assert got.shape == (nb, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("a", [1, 3, 8, 9, 10, 64, 65, 100, 129, 256])
def test_pack_factor_and_path_choice_match(a):
    assert tbasket.pack_factor(a) == jbasket.pack_factor(a)
    assert tbasket.use_asset_major(a) == jbasket.use_asset_major(a)


@pytest.mark.parametrize("a", [3, 10])
def test_cholesky_matches(a):
    corr = np.asarray(jtypes.BasketOption.default_reference(a).corr)
    want = np.asarray(jmath.cholesky_lower(corr))
    np.testing.assert_allclose(tmath.cholesky_lower(corr).numpy(), want,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("a", [3, 10])
def test_block_offset_relabels_streams(a):
    opt = from_reference(_option(a))
    _, tplan = _plans(a, 4, 8, 1, False)
    ops = tbasket.operands(opt, tmath.cholesky_lower(opt.corr), "cpu")
    full = tbasket.partials(ops, 9, 0, tplan, 4)
    tail = tbasket.partials(ops, 9, 2, tplan, 2)
    assert np.array_equal(full[2:].numpy(), tail.numpy())
