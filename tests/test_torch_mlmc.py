"""Multilevel Monte Carlo of the port against mctpu (CPU): the plain
versions of the coupled level kernels K29 (Heston Euler), K11 (Asian) and
K14 (knock-out barrier) against the JAX kernels in interpret mode, their
scalars, the level plans, the engine-tier level functions against
``mctpu.mlmc``'s, the Giles loop bit for bit on a synthetic level function,
and the cheap statistical gates of ``tests/test_mlmc.py`` on the port's
plain path.

Tolerance: a level's sample is a payoff difference ``d``, whose block sum
can cancel (K29's ``sum d`` falls to 17.8 on terms of order 10 at level 2,
antithetic), so the ``(sum d, sum d^2)`` partials are held by the scaled
pair bound of ``tests/torch_tolerance.py`` at ``rtol=2e-5``: ``|got -
want| <= rtol (|sum d| + sqrt(n sum d^2))`` (measured: at most 9.4e-7 of
it).  Both packages draw the same normals; the per-path values differ only
where torch's and XLA's ``exp``/``log``/``sqrt`` round apart on the CPU.
Each interpret-mode case runs 2 blocks of ``rows=8``, one trace per kernel
and variant; the statistical gates run on one torch thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mctpu_torch
from mctpu import engine as jengine
from mctpu import mlmc as jmlmc
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import asian as jasian
from mctpu.kernels import barrier as jbarrier
from mctpu.kernels import heston as jheston
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch import mlmc as tmlmc
from mctpu_torch.kernels import asian as tasian
from mctpu_torch.kernels import barrier as tbarrier
from mctpu_torch.kernels import heston as theston
from mctpu_torch.models import heston as tmheston
from mctpu_torch.types import MlmcLevel, MlmcResult, from_reference
from mctpu_torch.variance import level_seed
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(4321)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS, N0 = 2, 8, 2
# tests/test_heston.py's option; tests/test_mlmc.py's Heston option, its
# Asian (S=K=100, r=0.05, v=0.2, T=1) and its up-and-out at H=130.
HOPT = jtypes.HestonOption(s=100.0, k=100.0, r=0.05, t=1.0, v0=0.04,
                           kappa=2.0, theta=0.04, xi=0.3, rho=-0.7)
MOPT = jtypes.HestonOption(s=100.0, k=100.0, r=0.03, t=1.0, v0=0.04,
                           kappa=1.5, theta=0.04, xi=0.4, rho=-0.6)
ASIAN = jtypes.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=4)
GEO = dataclasses.replace(ASIAN, average="geometric")
# Barriers near the spot, so that paths knock out on the odd dates.
UP = jtypes.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, barrier=115.0,
                          n_obs=4)
DOWN = dataclasses.replace(UP, kind="down-and-out", barrier=90.0)


def _heston(opt, lv, plan, nb, off, seed=SEED):
    nf = N0 * 2 ** lv
    lp = theston.level_params(from_reference(opt), nf, "cpu")
    return theston.level_partials(lp, seed, off, plan, nb, nf)


def _asian(opt, lv, plan, nb, off, seed=SEED):
    nf = N0 * 2 ** lv
    lp = tasian.level_params(from_reference(opt), nf, "cpu")
    return tasian.level_partials(lp, seed, off, plan, nb, nf,
                                 opt.average == "geometric")


def _barrier(opt, lv, plan, nb, off, seed=SEED):
    nf = N0 * 2 ** lv
    lp = tbarrier.level_params(from_reference(opt), nf, "cpu")
    return tbarrier.level_partials(lp, seed, off, plan, nb, nf,
                                   opt.kind == "up-and-out")


KERNELS = {"K29": (jheston, _heston), "K11": (jasian, _asian),
           "K14": (jbarrier, _barrier)}
# K29 and K11 also at 2 iterations a block, plain and antithetic: the
# stream's per-iteration reseed, which the card's split walks fold in the
# plain version's order.
CASES = {
    # name: (kernel, option, level, antithetic, kahan, iterations)
    "K29_l1": ("K29", HOPT, 1, False, True, 1),
    "K29_l2": ("K29", MOPT, 2, False, True, 1),
    "K29_l1_antithetic_f32": ("K29", HOPT, 1, True, False, 1),
    "K29_l1_iters2": ("K29", HOPT, 1, False, True, 2),
    "K29_l1_iters2_antithetic": ("K29", MOPT, 1, True, True, 2),
    "K11_arithmetic_l1": ("K11", ASIAN, 1, False, True, 1),
    "K11_geometric_l2": ("K11", GEO, 2, False, True, 1),
    "K11_geometric_l1_antithetic_f32": ("K11", GEO, 1, True, False, 1),
    "K11_arithmetic_l1_iters2": ("K11", ASIAN, 1, False, True, 2),
    "K11_geometric_l1_iters2_antithetic": ("K11", GEO, 1, True, True, 2),
    "K14_up_l1": ("K14", UP, 1, False, True, 1),
    "K14_down_l2": ("K14", DOWN, 2, False, True, 1),
    "K14_up_l2_antithetic_f32": ("K14", UP, 2, True, False, 1),
}


def _plans(jmod, antithetic, kahan, iters=1):
    paths = NB * ROWS * 128 * (2 if antithetic else 1) * iters
    jplan = jmod.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = theston.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.iters == iters
    return jplan, tplan


@pytest.mark.parametrize("case", sorted(CASES))
def test_level_partials_match_interpret_mode(case):
    kernel, opt, lv, antithetic, kahan, iters = CASES[case]
    jmod, run = KERNELS[kernel]
    jplan, tplan = _plans(jmod, antithetic, kahan, iters)
    want = np.asarray(jmod.level_pallas_partials(
        opt, SEED, 1, jplan, NB, N0, lv, interpret=True))
    got = run(opt, lv, tplan, NB, 1)
    assert got.shape == (NB, 2) and got.dtype == torch.float32
    assert_pairs_close(got.numpy(), want, tplan.iters * tplan.units_per_iter,
                       RTOL)
    if kernel == "K14":  # finer monitoring only knocks out more
        assert (want[:, 0] < 0).all()


@pytest.mark.parametrize("cap", [0, 1, 1 << 20])
def test_asian_level_scratch_cap_runs_plain_on_cpu(cap):
    """``level_partials`` takes K11's scratch cap on every device; on a CPU
    ``lp`` it runs the plain version, whatever the cap."""
    lp = tasian.level_params(from_reference(ASIAN), 8, "cpu")
    plan = theston.make_plan(NB * 2 * ROWS * 128 * 2, NB, ROWS, True)
    assert plan.iters == 2
    want = tasian.level_plain_partials(lp, SEED, 1, plan, NB, 8, False)
    got = tasian.level_partials(lp, SEED, 1, plan, NB, 8, False,
                                scratch_cap=cap)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_block_offset_relabels_streams(kernel):
    opt = {"K29": HOPT, "K11": ASIAN, "K14": UP}[kernel]
    run = KERNELS[kernel][1]
    plan = theston.make_plan(4 * ROWS * 128, 4, ROWS, False)
    full = run(opt, 2, plan, 4, 0, seed=9)
    tail = run(opt, 2, plan, 2, 2, seed=9)
    assert torch.equal(full[2:], tail)
    assert not torch.equal(full[:2], tail)


def test_level_wrappers_refuse_odd_grids_and_other_devices():
    lp = theston.level_params(from_reference(HOPT), 4, "cpu")
    plan = theston.make_plan(1, 1, 8, False)
    for n_fine in (0, 3):
        with pytest.raises(ValueError, match="even"):
            theston.level_partials(lp, 1, 0, plan, 1, n_fine)
    ap = tasian.level_params(from_reference(ASIAN), 4, "cpu")
    with pytest.raises(ValueError, match="even"):
        tasian.level_partials(ap, 1, 0, plan, 1, 5, False)
    bp = tbarrier.level_params(from_reference(UP), 4, "cpu")
    with pytest.raises(ValueError, match="even"):
        tbarrier.level_plain_partials(bp, 1, 0, plan, 1, 1, True)
    with pytest.raises(ValueError, match="unsupported device"):
        tbarrier.level_partials(bp.to("meta"), 1, 0, plan, 1, 4, True)


def _jax_level_scal(kernel, opt, nf):
    """K29's, K11's and K14's float32 ``scal`` as ``mctpu``'s eager
    ``level_pallas_partials`` forms it (``kernels/heston.py:431-437,
    581-586``, ``asian.py:539-543``, ``barrier.py:507-512``)."""
    o = opt.astype(jnp.float32)
    if kernel == "K29":
        dt_f = o.t / nf
        dt_c = 2.0 * dt_f
        return jnp.stack([o.s, o.k, o.v0, o.theta, o.xi, o.rho,
                          jnp.sqrt(1.0 - o.rho * o.rho), o.kappa * dt_f,
                          o.r * dt_f, jnp.sqrt(dt_f), o.kappa * dt_c,
                          o.r * dt_c, jnp.sqrt(dt_c)])
    dt = jnp.asarray(o.t, jnp.float32) / nf
    drift = (o.r - 0.5 * o.v * o.v) * dt
    vol = o.v * jnp.sqrt(dt)
    log_s0 = jnp.log(jnp.asarray(o.s, jnp.float32))
    if kernel == "K11":
        return jnp.stack([log_s0, o.k, drift, vol])
    return jnp.stack([log_s0, o.k, jnp.log(jnp.asarray(o.barrier,
                                                        jnp.float32)),
                      drift, vol])


SCAL_OPTS = {
    "K29": [HOPT, MOPT, jtypes.HestonOption(
        s=90.0, k=105.0, r=0.0311, t=2.7, v0=0.0913, kappa=1.3, theta=0.07,
        xi=0.61, rho=-0.33)],
    "K11": [ASIAN, jtypes.AsianOption(93.0, 107.0, 0.0311, 0.37, 2.7,
                                      n_obs=4)],
    "K14": [UP, jtypes.BarrierOption(93.0, 107.0, 0.0311, 0.37, 2.7,
                                     barrier=81.0, n_obs=4,
                                     kind="down-and-out")],
}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_level_params_match_kernel_prep(kernel):
    """Bit for bit at fine grids of 2 to 3072 steps, the roots correctly
    rounded in both packages."""
    params = {"K29": theston.level_params, "K11": tasian.level_params,
              "K14": tbarrier.level_params}[kernel]
    for opt in SCAL_OPTS[kernel]:
        for nf in (2, 4, 6, 16, 24, 128, 1000, 3072):
            with jax.enable_x64(False):
                want = np.asarray(_jax_level_scal(kernel, opt, nf))
            got = params(from_reference(opt), nf, "cpu")
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_paths,num_blocks,rows,antithetic", [
    (1 << 14, 8, 8, False), (50_000_000, 8, 8, False),
    (1 << 20, 512, 256, True), (3 * 4096 + 1, 4, 8, False),
    (524_288, 512, 256, False)])
def test_level_plan_matches_mctpu(n_paths, num_blocks, rows, antithetic):
    """``_pow2_iters`` of the level plan, field by field, against
    ``mctpu.mlmc``'s for each product's ``make_plan`` (50M level-0 paths on
    8 x 8 are 8192 iterations)."""
    jcfg = jengine.EngineConfig(num_blocks=num_blocks, rows=rows,
                                antithetic=antithetic)
    tcfg = tengine.EngineConfig(num_blocks=num_blocks, rows=rows,
                                antithetic=antithetic, device="cpu")
    got = tmlmc._level_plan(n_paths, tcfg)
    blocks, r = jcfg.layout_for(n_paths, 128)
    for jmod in (jheston, jasian, jbarrier):
        want = jmlmc._pow2_iters(jmod.make_plan(
            n_paths, blocks, r, jcfg.antithetic, jcfg.dtype_str,
            jcfg.precision.kahan))
        for f in ("num_blocks", "iters", "rows", "paths_per_iter",
                  "units_per_iter", "antithetic", "kahan", "total_units"):
            assert getattr(got, f) == getattr(want, f), f
    assert got.iters & (got.iters - 1) == 0
    assert got.total_units >= n_paths // (2 if antithetic else 1)


LEVEL_FNS = {"heston": (MOPT, jmlmc.level_partials, tmlmc.level_partials),
             "asian": (GEO, jmlmc.asian_level_partials,
                       tmlmc.asian_level_partials),
             "barrier": (UP, jmlmc.barrier_level_partials,
                         tmlmc.barrier_level_partials)}


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("product", sorted(LEVEL_FNS))
def test_engine_level_matches_mctpu(product, level):
    """The engine-tier level functions at the key whose ``key_to_seed`` is
    the port's seed: ``n`` equal, ``(s, s2)`` at rtol 2e-5 (measured: 1.4e-6
    at most, K29's level-1 ``sum d``)."""
    opt, jfn, tfn = LEVEL_FNS[product]
    jcfg = jengine.EngineConfig(backend="pallas", interpret=True,
                                num_blocks=4, rows=8)
    tcfg = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu")
    n_paths = 3 * 4096  # 4 blocks x 4 power-of-two iterations of 1024
    s, s2, n = jfn(opt, KEY, level, N0, n_paths, jcfg)
    got = tfn(from_reference(opt), SEED, level, N0, n_paths, tcfg)
    assert got[2] == n == 16384
    np.testing.assert_allclose(got[:2], (s, s2), rtol=RTOL)


def _synthetic(seed, level, n_paths):
    """A deterministic stand-in for a level run: ``(sum, sum2, n)`` with
    the mean and variance decaying as a Heston level's, perturbed by the
    run's seed (so that the seed map is part of what is compared)."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, level, n_paths])
    n = -(-n_paths // 1024) * 1024
    m = (10.0 if level == 0 else 2.0 ** -level) \
        * (1.0 + 0.05 * rng.standard_normal())
    v = 150.0 * 2.0 ** -(1.3 * level) * (1.0 + 0.2 * rng.random())
    return m * n, (v + m * m) * n, n


def _jax_seed_of(key):
    def seed_of(level, n_so_far):
        k = jax.random.fold_in(jax.random.fold_in(key, level), n_so_far)
        return int(jrng.key_to_seed(k))
    return seed_of


@pytest.mark.parametrize("eps,max_levels", [(0.05, 8), (0.01, 5)])
def test_giles_loop_matches_mctpu_bit_for_bit(eps, max_levels):
    """``_giles_price`` fed the same synthetic level function: equal
    price, CI, standard error, level table and path-steps, to the bit."""
    def cost(lv):
        return 8 * (2 ** lv) * (1.0 if lv == 0 else 1.5)

    jcfg = jengine.EngineConfig(num_blocks=8, rows=8)
    tcfg = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")
    disc = float(np.exp(-0.03))
    want = jmlmc._giles_price(
        lambda k, lv, n: _synthetic(jrng.key_to_seed(k), lv, n), cost, eps,
        KEY, jcfg, 1 << 14, max_levels, 1.0 / np.sqrt(2.0), disc,
        lambda lv: 8 * 2 ** lv)
    got = tmlmc._giles_price(_synthetic, cost, eps, SEED, tcfg, 1 << 14,
                             max_levels, 1.0 / np.sqrt(2.0), disc,
                             lambda lv: 8 * 2 ** lv,
                             seed_of=_jax_seed_of(KEY))
    assert isinstance(got, MlmcResult)
    assert got == from_reference(want)
    assert len(got.levels) >= 3 and all(isinstance(lv, MlmcLevel)
                                        for lv in got.levels)


def test_level_seed_folds_level_and_path_count():
    """Distinct per level and per top-up, int32, the path count taken mod
    2^32, and never a function of the seed alone."""
    seeds = {level_seed(SEED, lv, n) for lv in range(6)
             for n in (0, 16384, 1 << 31, (1 << 32) - 1)}
    assert len(seeds) == 24
    assert all(-(1 << 31) <= s < (1 << 31) for s in seeds)
    assert level_seed(SEED, 3, 5) == level_seed(SEED, 3, 5 + (1 << 32))
    assert level_seed(SEED, 3, 5) == level_seed(SEED + (1 << 32), 3, 5)
    assert level_seed(SEED, 0, 0) != level_seed(SEED + 1, 0, 0)


# ---------------------------------------------------------------------------
# The cheap statistical gates of tests/test_mlmc.py on the port's plain path
# ---------------------------------------------------------------------------

CPU = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_geometric_level_means_match_closed_form(one_thread):
    """E[d_l] = cf(n_l) - cf(n_l / 2), undiscounted, within 4 standard
    errors at 2^16 paths, levels 1 and 3 of n0 = 4."""
    geo = from_reference(dataclasses.replace(GEO, n_obs=4))
    disc = np.exp(-0.05)
    for lv in (1, 3):
        s, s2, n = tmlmc.asian_level_partials(geo, SEED + lv, lv, 4, 1 << 16,
                                              CPU)
        m = s / n
        se = np.sqrt(max(s2 / n - m * m, 0) / n)
        want = float(
            tmath.geometric_asian_call(100., 100., 0.05, 0.2, 1., 4 * 2 ** lv)
            - tmath.geometric_asian_call(100., 100., 0.05, 0.2, 1.,
                                         2 * 2 ** lv)) / disc
        assert abs(m - want) < 4 * se, (lv, m, want)


def test_barrier_level_variance_decays_at_beta_half(one_thread):
    """Two levels shed about 2x of the level variance (beta ~ 1/2); gate at
    1.5x; every level mean below 0 (finer monitoring knocks out more)."""
    opt = from_reference(jtypes.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                              barrier=130.0, n_obs=8))
    var = {}
    for lv in (1, 3):
        s, s2, n = tmlmc.barrier_level_partials(opt, SEED + lv, lv, 8,
                                                1 << 16, CPU)
        m = s / n
        assert m < 0
        var[lv] = max(s2 / n - m * m, 0.0)
    assert var[3] < var[1] / 1.5, var


@pytest.fixture(scope="module")
def small_run():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return tmlmc.price_heston_mlmc(from_reference(MOPT), eps=0.1,
                                       seed=SEED, config=CPU,
                                       n_pilot=1 << 12)
    finally:
        torch.set_num_threads(n)


def test_small_estimator_within_tolerance_of_cf(small_run):
    res = small_run
    assert abs(res.price - tmheston.cf_call_price(from_reference(MOPT))) \
        < 3 * 0.1
    assert 0 < res.std_error < 0.1
    assert res.ci == pytest.approx(1.96 * res.std_error)


def test_small_estimator_level_table_and_allocation(small_run):
    levels = small_run.levels
    assert [lv.level for lv in levels] == list(range(len(levels)))
    assert len(levels) >= 3
    for lv in levels:
        assert lv.n_steps == 8 * 2 ** lv.level
        assert lv.n_paths > 0 and np.isfinite(lv.var) and lv.var > 0
        assert lv.cost == 8 * 2 ** lv.level * (1.0 if lv.level == 0 else 1.5)
    n = [lv.n_paths for lv in levels]
    assert n[0] == max(n) and n[-1] <= n[0]
    ratios = np.asarray([lv.n_paths / np.sqrt(lv.var / lv.cost)
                         for lv in levels])
    assert ratios.max() / ratios.min() < 3.0  # N_l ~ sqrt(V_l / C_l)
    assert small_run.total_path_steps == sum(lv.cost * lv.n_paths
                                             for lv in levels)


def test_small_estimator_reproducible(small_run, one_thread):
    again = tmlmc.price_heston_mlmc(from_reference(MOPT), eps=0.1, seed=SEED,
                                    config=CPU, n_pilot=1 << 12)
    assert again == small_run
    other = tmlmc.price_heston_mlmc(from_reference(MOPT), eps=0.1,
                                    seed=SEED + 1, config=CPU,
                                    n_pilot=1 << 12)
    assert other.price != small_run.price


def test_records_carry_across_and_entry_points_validate():
    def cost(lv):
        return 4.0 * 2 ** lv

    want = jmlmc._giles_price(
        lambda k, lv, n: _synthetic(jrng.key_to_seed(k), lv, n), cost, 0.05,
        KEY, jengine.EngineConfig(num_blocks=8, rows=8), 1 << 12, 6,
        1.0 / np.sqrt(2.0), 1.0, lambda lv: 4 * 2 ** lv)
    got = from_reference(want)
    assert isinstance(got, MlmcResult)
    assert got.price == want.price and got.ci == want.ci
    assert len(got.levels) == len(want.levels)
    for g, w in zip(got.levels, want.levels):
        assert isinstance(g, MlmcLevel)
        assert isinstance(g.n_paths, int) and g.n_paths == w.n_paths
        assert dataclasses.astuple(g) == dataclasses.astuple(w)
    assert "mlmc" in mctpu_torch.__all__ and "MlmcResult" in \
        mctpu_torch.__all__
    assert mctpu_torch.mlmc.price_heston_mlmc is tmlmc.price_heston_mlmc
    bad = from_reference(dataclasses.replace(MOPT, v0=-0.1))
    with pytest.raises(ValueError):
        tmlmc.price_heston_mlmc(bad, 0.1, SEED, CPU)
    with pytest.raises(ValueError):
        tmlmc.price_asian_mlmc(from_reference(
            dataclasses.replace(ASIAN, k=-1.0)), 0.1, SEED, CPU)
    with pytest.raises(ValueError):
        tmlmc.price_barrier_mlmc(from_reference(
            dataclasses.replace(UP, barrier=-1.0)), 0.1, SEED, CPU)
    # The entry points run on the card unless the caller asks for the CPU.
    assert tmlmc.price_heston_mlmc.__defaults__[0].device == "cuda"
