"""The port's QMC building blocks against ``mctpu``'s: the Giles normal
quantile (``mctpu_torch.math``), the Sobol direction table and nets and
the Brownian bridge (``mctpu_torch.sobol``), the lattice rules
(``mctpu_torch.qmc``), and the reference's cheap statistical gates of
``tests/test_sobol.py`` and ``tests/test_qmc.py`` on the port's plain
path (``device="cpu"``).

Tolerances: the Sobol integers, the bridge plan and the lattice are
exact, so they are held bit for bit.  The quantile's polynomials agree bit
for bit on equal ``w``; the whole quantile within 4 ulp, because XLA's and
PyTorch's float32 ``log`` differ by up to 1 ulp in ``w`` and the
polynomial carries that to up to 3 ulp of the result.  The float64 bridge
paths are held at rtol 1e-6 (the same operations in another engine).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mctpu_torch as mt
from mctpu import math as jmath
from mctpu import qmc as jqmc
from mctpu import sobol as jsobol
from mctpu_torch import math as tmath
from mctpu_torch import qmc as tqmc
from mctpu_torch import sobol as tsobol
from mctpu_torch.types import AsianOption, BasketOption, VanillaOption

OPT = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
BS = float(tmath.bs_call(100.0, 100.0, 0.048790, 0.2, 1.0))
CPU_MC = mt.EngineConfig(num_blocks=8, rows=8, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Beside other test workers, torch's per-process thread pool
    oversubscribes the cores (these small tensors gain nothing from it),
    so this module runs torch on one thread and restores the setting
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _uniform_grid():
    """Uniforms over (0, 1), both tails down to the clip, the clip itself,
    and a neighbourhood of the branch point w = 5."""
    u_w5 = np.float32((1.0 - np.sqrt(1.0 - np.exp(-5.0))) / 2.0)
    near = u_w5 + np.arange(-64, 64, dtype=np.float32) * np.spacing(u_w5)
    tails = np.float32(np.exp(-np.linspace(0.0, 18.0, 20001)))
    return np.concatenate([
        np.linspace(0.0, 1.0, 100001, dtype=np.float32), tails, 1.0 - tails,
        np.float32([0.0, 1e-9, 1e-7, 2e-7, 0.5, 1.0]), near,
        1.0 - near]).astype(np.float32)


# ---------------------------------------------------------------- math


def test_giles_polynomials_bitwise_on_equal_w():
    u = np.clip(_uniform_grid(), np.float32(1e-7), np.float32(1 - 1e-7))
    x = (np.float32(2.0) * u - np.float32(1.0)).astype(np.float32)
    w = -np.asarray(jnp.log(jnp.asarray(4.0 * u * (1.0 - u),
                                        jnp.float32)))
    want = np.asarray(jmath._giles_from_w(jnp.asarray(w), jnp.asarray(x)))
    got = tmath._giles_from_w(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_norm_ppf_f32_matches_mctpu_within_4_ulp():
    u = _uniform_grid()
    want = np.asarray(jmath.norm_ppf_f32(jnp.asarray(u)))
    got = tmath.norm_ppf_f32(torch.from_numpy(u))
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= 4


def test_erf_inv_f32_matches_mctpu_within_4_ulp():
    x = np.concatenate([np.linspace(-0.999999, 0.999999, 1 << 16,
                                    dtype=np.float32),
                        np.float32([0.0, -0.5, 0.5, 0.999, -0.999])])
    want = np.asarray(jmath.erf_inv_f32(jnp.asarray(x)))
    got = tmath.erf_inv_f32(torch.from_numpy(x)).numpy()
    assert _ulps(got, want).max() <= 4


def test_norm_ppf_f32_accuracy_and_tails():
    from scipy.special import ndtri

    u = np.linspace(1e-6, 1.0 - 1e-6, 1 << 17).astype(np.float32)
    got = tmath.norm_ppf_f32(torch.from_numpy(u)).numpy()
    assert np.max(np.abs(got - ndtri(u.astype(np.float64)))) < 5e-5
    z = tmath.norm_ppf_f32(torch.tensor([0.0, 1e-9, 1e-7, 0.5, 1.0],
                                        dtype=torch.float32)).numpy()
    assert np.isfinite(z).all() and z[0] == z[1] == z[2]
    assert abs(z[3]) < 1e-6 and abs(z[0] + 5.199) < 0.05
    for lo in (2.0 ** -20, 2.0 ** -7, 0.25, 0.375):
        pair = tmath.norm_ppf_f32(torch.tensor([lo, 1.0 - lo],
                                               dtype=torch.float32))
        assert float(pair[0]) == -float(pair[1])


# --------------------------------------------------------------- sobol


def test_direction_table_is_mctpus_byte_for_byte():
    from pathlib import Path

    import mctpu
    mine = Path(tsobol.__file__).parent / "data" / \
        "sobol_directions_2048x30.npy"
    theirs = Path(mctpu.__file__).parent / "data" / \
        "sobol_directions_2048x30.npy"
    assert mine.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(tsobol._directions(), jsobol._directions())
    assert tsobol.MAX_DIM == jsobol.MAX_DIM == 2048


@pytest.mark.parametrize("dim", [1, 5, 40, 2048])
@pytest.mark.parametrize("shifted", [False, True])
def test_sobol_points_match_mctpu(dim, shifted):
    n = 300 if dim < 2048 else 20
    shift = None
    if shifted:
        shift = np.random.default_rng(dim).integers(0, 1 << 32, dim,
                                                    dtype=np.uint32)
    want = np.asarray(jsobol.sobol_points(
        n, dim, None if shift is None else jnp.asarray(shift)))
    got = tsobol.sobol_points(n, dim, shift, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sobol_points_match_torch_sobol_engine():
    n, d = 256, 8
    want = torch.quasirandom.SobolEngine(dimension=d).draw(n,
                                                           dtype=torch.float64)
    got = tsobol.sobol_points(n, d, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-7)


def test_sobol_dim_limit():
    with pytest.raises(ValueError, match="2048"):
        tsobol.sobol_points(16, 2049, device="cpu")


def test_digital_shift_preserves_balance():
    shift = np.random.default_rng(3).integers(0, 1 << 32, 4, dtype=np.uint32)
    pts = tsobol.sobol_points(1 << 10, 4, shift, torch.float64,
                              device="cpu").numpy()
    for d in range(4):
        counts = np.histogram(pts[:, d], bins=16, range=(0, 1))[0]
        assert (counts == (1 << 10) // 16).all()


@pytest.mark.parametrize("m", [1, 2, 3, 7, 12, 50, 252])
def test_brownian_bridge_plan_equals_mctpus(m):
    for a, b in zip(tsobol.brownian_bridge_plan(m),
                    jsobol.brownian_bridge_plan(m)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("m", [1, 12, 50])
def test_bridge_paths_match_mctpu(m):
    z = np.random.default_rng(m).standard_normal((257, m))
    want = np.asarray(jsobol.bridge_paths(jnp.asarray(z), 2.0, jnp.float64))
    got = tsobol.bridge_paths(torch.from_numpy(z), 2.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)


def test_bridge_covariance_is_brownian():
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (100000, 10)))
    w = tsobol.bridge_paths(z, 2.0).numpy()
    t = 2.0 * np.arange(1, 11) / 10
    np.testing.assert_allclose(w @ w.T / z.shape[0], np.minimum.outer(t, t),
                               atol=0.02)


# ----------------------------------------------------------------- qmc


def test_next_prime_and_korobov_match_mctpu():
    for n in (1, 2, 10, 11, 512, 1 << 14, 65536):
        assert tqmc.next_prime(n) == jqmc.next_prime(n)
    for n, dim, a in ((16411, 5, 1571), (1571, 4, 1571), (97, 30, 3)):
        np.testing.assert_array_equal(tqmc.korobov_vector(n, dim, a),
                                      jqmc.korobov_vector(n, dim, a))


@pytest.mark.parametrize("dim", [1, 5])
def test_lattice_points_match_mctpu(dim):
    n = tqmc.next_prime(1000)
    shift = np.random.default_rng(dim).random(dim)
    want = np.asarray(jqmc.lattice_points(n, dim, jnp.asarray(shift),
                                          jnp.float64))
    got = tqmc.lattice_points(n, dim, shift, torch.float64, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).all() and (got < 1).all()


# ------------------------------------------- statistical gates (plain path)


def test_vanilla_sobol_unbiased_and_tight():
    res = tsobol.price_vanilla_sobol(OPT, 1 << 12, 777, device="cpu")
    assert abs(float(res.price) - BS) < 4 * float(res.std_error)
    mc = mt.price_vanilla(OPT, res.n_paths, 3, CPU_MC)
    assert float(res.ci) < float(mc.ci) / 5


def test_basket_sobol_matches_mc():
    opt = BasketOption.equicorrelated(3, rho=0.3)
    res = tsobol.price_basket_sobol(opt, 1 << 11, 777, replicates=8,
                                    device="cpu")
    mc = mt.price_basket(opt, 1 << 18, 4, CPU_MC)
    se = np.hypot(float(res.std_error), float(mc.std_error))
    assert abs(float(res.price) - float(mc.price)) < 4 * se


def test_asian_sobol_geometric_and_arithmetic_bracket():
    geo = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=12,
                      average="geometric")
    res = tsobol.price_asian_sobol(geo, 1 << 12, 5, device="cpu")
    want = float(tmath.geometric_asian_call(100.0, 100.0, 0.05, 0.2, 1.0,
                                            12))
    assert abs(float(res.price) - want) < 5 * float(res.std_error)
    ari = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=12)
    res = tsobol.price_asian_sobol(ari, 1 << 12, 6, device="cpu")
    vanilla = float(tmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    assert want < float(res.price) < vanilla
    with pytest.raises(ValueError, match="n_obs"):
        tsobol.price_asian_sobol(AsianOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                             n_obs=2500), 16, 0,
                                 device="cpu")


def test_vanilla_qmc_unbiased_tight_and_reproducible():
    res = tqmc.price_vanilla_qmc(OPT, 1 << 12, 404, device="cpu")
    assert abs(float(res.price) - BS) < 4 * float(res.std_error)
    mc = mt.price_vanilla(OPT, res.n_paths, 7, CPU_MC)
    assert float(res.ci) < float(mc.ci) / 5
    again = tqmc.price_vanilla_qmc(OPT, 1 << 12, 404, device="cpu")
    assert float(again.price) == float(res.price)
    assert res.n_paths == tqmc.next_prime(1 << 12) * 16


def test_basket_qmc_matches_mc():
    opt = BasketOption.default_reference(3)
    res = tqmc.price_basket_qmc(opt, 1 << 11, 404, replicates=8,
                                device="cpu")
    mc = mt.price_basket(opt, 1 << 18, 8, CPU_MC)
    se = np.hypot(float(res.std_error), float(mc.std_error))
    assert abs(float(res.price) - float(mc.price)) < 4 * se
