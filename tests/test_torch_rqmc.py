"""K52-K55's plain versions against ``mctpu``'s RQMC Pallas kernels in
interpret mode (CPU), the block-offset contract, the engine tier
(``mctpu_torch.qmc_engine``) against ``mctpu.qmc_engine`` at the same seed,
and the reference's statistical gates (``tests/test_qmc_engine.py``) on
the port's plain path (``device="cpu"``).

Both packages shift replicate ``b`` by the Philox words of ``(0, seed)``
(``key_data(PRNGKey(seed))``), so the nets are the same integers and the
per-replicate quads ``[s, c, s2, c2]`` differ only in the float32 order of
each chunk's sum and in an ulp of ``log``.  ``s`` and ``c`` each depend on
that order, so only the folded ``s + c`` and ``s2 + c2`` are compared: K52,
K54 and K55 at rtol 2e-5; K53's eight outputs by the scaled pair bound of
``tests/torch_tolerance.py`` at 2e-5 (vanna and volga sums can cancel).
The engine's price is held at rtol 1e-6, its ``std_error`` at rtol 1e-3
(the replicate spread is ~1e-6 of the price, so the quads' rounding moves
it), ``n`` and ``n_paths`` exactly.  Each interpret-mode call runs 2
replicates of 8 rows (one trace per kernel and variant).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import mctpu_torch as mt
from mctpu import engine as jengine
from mctpu import math as jmath
from mctpu import qmc_engine as jq
from mctpu import types as jtypes
from mctpu_torch import math as tmath
from mctpu_torch import qmc_engine as tq
from mctpu_torch.kernels import rqmc as kr
from mctpu_torch.types import (AsianOption, BasketOption, Precision,
                               VanillaOption, from_reference)
from torch_tolerance import assert_quads_close

RTOL = 2e-5
SEED = 55
KEY = jax.random.PRNGKey(SEED)
KD = tq.rqmc_key(SEED)
NB = 2
CPU = mt.EngineConfig(device="cpu", rows=8)
OPT = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
BS = float(tmath.bs_call(100.0, 100.0, 0.048790, 0.2, 1.0))


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


def _plan(jplan):
    plan = tq.rqmc_plan(1, jplan.num_blocks, jplan.rows,
                        jplan.paths_per_iter)
    return dataclasses.replace(plan, iters=jplan.iters)


def test_seed_map_is_prngkey_words():
    """The int32 seeds' key words with x64 off (JAX's default; with x64 on,
    a negative seed's high word is 0xFFFFFFFF instead)."""
    with jax.enable_x64(False):
        for seed in (7, -5, 2 ** 31 - 1, 0):
            words = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
            assert tuple(int(w) for w in words) == tq.rqmc_key(seed)


@pytest.mark.parametrize("offset,n,dim", [(0, 3, 1), (5, 2, 12),
                                          (2 ** 32 - 1, 2, 3)])
def test_rep_shifts_equal_mctpus(offset, n, dim):
    want = np.asarray(jq._rep_shifts(KEY, offset, n, dim), np.int64)
    got = kr.rep_shifts(*KD, offset, n, dim)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["call", "put"])
def test_k52_matches_interpret_mode(kind):
    opt = jtypes.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0, kind=kind)
    jplan = jq.rqmc_plan(3 * 1024, NB, 8)
    want = jq.vanilla_pallas_partials(opt, KEY, 2, jplan, NB, interpret=True)
    ops = kr.vanilla_operands(from_reference(opt), "cpu")
    got = kr.vanilla_partials(ops, KD, 2, _plan(jplan), NB, kind == "put")
    assert got.shape == (NB, 4) and got.dtype == torch.float32
    assert_quads_close(got, want, RTOL)


@pytest.mark.parametrize("kind", ["call", "put"])
def test_k53_matches_interpret_mode(kind):
    opt = jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
    jplan = jq.rqmc_plan(2 * 1024, NB, 8)
    want = jq.vanilla_greek_pallas_partials(opt, KEY, 0, jplan, NB,
                                            interpret=True)
    ops = kr.greek_operands(from_reference(opt), "cpu")
    got = kr.greek_partials(ops, KD, 0, _plan(jplan), NB, kind == "put")
    assert got.shape == (NB, 32)
    assert_quads_close(got, want, RTOL, jplan.paths_per_block)


@pytest.mark.parametrize("n_assets", [3, 12, 100, 300])
def test_k54_matches_interpret_mode(n_assets):
    import jax.numpy as jnp

    opt = jtypes.BasketOption.equicorrelated(n_assets, 0.3)
    _, c, _ = jq.kbasket.pack_factor(n_assets)
    jplan = jq.rqmc_plan(2 * 8 * c, NB, 8, pts_per_chunk=8 * c)
    chol = jmath.cholesky_lower(jnp.asarray(opt.corr, jnp.float64))
    want = jq.basket_pallas_partials(opt, chol, KEY, 1, jplan, NB,
                                     interpret=True)
    ops = kr.basket_operands(from_reference(opt),
                             tmath.cholesky_lower(opt.corr), "cpu")
    got = kr.basket_partials(ops, KD, 1, _plan(jplan), NB)
    assert_quads_close(got, want, RTOL)


@pytest.mark.parametrize("average,rows,n_obs,chunks", [
    pytest.param("geometric", 8, 12, 2, id="geometric-8"),
    pytest.param("arithmetic", 24, 12, 2, id="arithmetic-24"),
    pytest.param("geometric", 24, 12, 3, id="geometric-24-3chunks"),
    pytest.param("arithmetic", 163, 50, 1, id="arithmetic-163-50dates"),
    pytest.param("geometric", 8, 252, 1, id="geometric-8-252dates"),
    pytest.param("arithmetic", 8, 300, 1, id="arithmetic-8-300dates")])
def test_k55_matches_interpret_mode(average, rows, n_obs, chunks):
    """rows 8: a 1024-point chunk (mctpu's hoisted construction); rows 24:
    3072 points, not a power of two (its 30-bit form), at 2 and 3 chunks a
    replicate (the chunk carry); the bridge, the tree
    sum and the chunk also at the depths the engine runs: 50 dates on rows
    163 (the Asian's cap, a 20864-point chunk) and 252 dates; and 300
    dates, past 256, where the CUDA kernel takes its 2048-date instance."""
    opt = jtypes.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=n_obs,
                             average=average)
    jplan = jq.rqmc_plan(chunks * rows * 128, NB, rows)
    want = jq.asian_pallas_partials(opt, KEY, 0, jplan, NB, interpret=True)
    ops = kr.asian_operands(from_reference(opt), "cpu")
    got = kr.asian_partials(ops, KD, 0, _plan(jplan), NB,
                            average == "geometric")
    assert_quads_close(got, want, RTOL)


def test_asian_operands_match_mctpus_float32_scalars():
    import jax.numpy as jnp

    m = 50
    ops = kr.asian_operands(AsianOption(100.0, 95.0, 0.05, 0.2, 1.0,
                                        n_obs=m), "cpu")
    with jax.enable_x64(False):
        t = jnp.float32(1.0)
        t_j = t * jnp.arange(1, m + 1, dtype=jnp.float32) / m
        drift = (jnp.float32(0.05) - 0.5 * jnp.float32(0.2)
                 * jnp.float32(0.2)) * t_j
        step = jnp.sqrt(t / m)
        scal = [jnp.log(jnp.float32(100.0)), jnp.float32(95.0),
                jnp.float32(0.2), step, jnp.float32(1.0 / m)]
    np.testing.assert_array_equal(ops.drift.numpy(), np.asarray(drift))
    np.testing.assert_array_equal(ops.par.numpy(),
                                  np.asarray(scal, np.float32))
    sd = jq.msobol.brownian_bridge_plan(m)[5]
    np.testing.assert_array_equal(
        ops.bridge[5].numpy(),
        np.asarray([np.float32(s) * np.asarray(step) for s in sd],
                   np.float32))


def _offset_contract(fn):
    full = fn(0, 4)
    np.testing.assert_array_equal(full.numpy(), fn(0, 4).numpy())
    np.testing.assert_array_equal(full[2:].numpy(), fn(2, 2).numpy())


@pytest.mark.parametrize("kernel", ["vanilla", "greeks", "basket", "asian"])
def test_block_offset_contract(kernel):
    plan = tq.rqmc_plan(2 * 1024, 4, 8)
    if kernel == "vanilla":
        ops = kr.vanilla_operands(OPT, "cpu")
        _offset_contract(lambda off, n: kr.vanilla_partials(
            ops, KD, off, plan, n, False))
    elif kernel == "greeks":
        ops = kr.greek_operands(OPT, "cpu")
        _offset_contract(lambda off, n: kr.greek_partials(
            ops, KD, off, plan, n, True))
    elif kernel == "basket":
        bo = BasketOption.equicorrelated(5, 0.3)
        plan = tq.rqmc_plan(2 * 8 * 16, 4, 8, pts_per_chunk=8 * 16)
        ops = kr.basket_operands(bo, tmath.cholesky_lower(bo.corr), "cpu")
        _offset_contract(lambda off, n: kr.basket_partials(
            ops, KD, off, plan, n))
    else:
        ops = kr.asian_operands(AsianOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                            n_obs=7), "cpu")
        _offset_contract(lambda off, n: kr.asian_partials(
            ops, KD, off, plan, n, False))


@pytest.mark.parametrize("cap", [0, 1, 1 << 20])
def test_asian_scratch_cap_runs_plain_on_cpu(cap):
    """On the CPU, K55's wrapper runs the plain version whatever the
    scratch cap of its split net (a CUDA-only argument)."""
    plan = tq.rqmc_plan(3 * 24 * 128, NB, 24)
    ops = kr.asian_operands(AsianOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                        n_obs=12), "cpu")
    got = kr.asian_partials(ops, KD, 1, plan, NB, True, scratch_cap=cap)
    want = kr.asian_plain_partials(ops, KD, 1, plan, NB, True)
    assert torch.equal(got, want)


def test_wrappers_refuse_other_devices():
    ops = kr.vanilla_operands(OPT, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kr.vanilla_partials(ops, KD, 0, tq.rqmc_plan(1024, 2, 8), 2, False)


# ------------------------------------------------------ the engine tier

_JCFG = jengine.EngineConfig(backend="pallas", interpret=True, rows=8)


def _same(got, want, greek=False):
    """A price at rtol 1e-6; a Greek, whose mean can nearly cancel, within
    RTOL of its integrand's root mean square (the pair bound's term)."""
    if greek:
        rms = float(np.sqrt(float(want.sum_p2) / want.n_paths))
        disc = float(want.price) * want.n_paths / float(want.sum_p)
        assert abs(float(got.price) - float(want.price)) <= RTOL * disc * rms
    else:
        assert float(got.price) == pytest.approx(float(want.price),
                                                 rel=1e-6)
    assert float(got.std_error) == pytest.approx(float(want.std_error),
                                                 rel=1e-3)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)


def test_engine_vanilla_matches_mctpu():
    opt = jtypes.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0, kind="put")
    want = jq.price_vanilla_rqmc(opt, 2048, KEY, _JCFG, replicates=4)
    got = mt.price_vanilla_rqmc(from_reference(opt), 2048, SEED, CPU,
                                replicates=4)
    _same(got, want)


def test_engine_greeks_match_mctpu():
    opt = jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
    want = jq.greeks_vanilla_rqmc(opt, 2048, KEY, _JCFG, replicates=4)
    got = tq.greeks_vanilla_rqmc(from_reference(opt), 2048, SEED, CPU,
                                 replicates=4)
    for name in ("price", "delta", "vega", "rho", "theta", "gamma",
                 "vanna", "volga"):
        _same(getattr(got, name), getattr(want, name),
              greek=name != "price")


def test_engine_basket_matches_mctpu():
    opt = jtypes.BasketOption.equicorrelated(3, 0.3)
    want = jq.price_basket_rqmc(opt, 512, KEY, _JCFG, replicates=4)
    got = mt.price_basket_rqmc(from_reference(opt), 512, SEED, CPU,
                               replicates=4)
    _same(got, want)


def test_engine_asian_matches_mctpu():
    opt = jtypes.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=12,
                             average="geometric")
    want = jq.price_asian_rqmc(opt, 2048, KEY, _JCFG, replicates=4)
    got = mt.price_asian_rqmc(from_reference(opt), 2048, SEED, CPU,
                              replicates=4)
    _same(got, want)


# ------------------------------------- statistical gates (plain path)

CPU_MC = mt.EngineConfig(num_blocks=8, rows=8, device="cpu")


def test_vanilla_rqmc_unbiased_and_much_tighter_than_mc():
    res = mt.price_vanilla_rqmc(OPT, 1 << 12, SEED, CPU)
    assert abs(float(res.price) - BS) < 4 * float(res.std_error)
    mc = mt.price_vanilla(OPT, res.n_paths, 3, CPU_MC)
    assert float(res.ci) < float(mc.ci) / 5
    disc = np.exp(-OPT.r * OPT.t)
    assert float(res.price) == pytest.approx(
        disc * float(res.sum_p) / res.n_paths, rel=1e-9)
    assert float(res.sum_p2) > 0
    assert float(res.std_error) >= (tq.F32_ACCURACY_FLOOR
                                    * abs(float(res.price)) * 0.999)


def test_put_prices_by_parity():
    put = dataclasses.replace(OPT, kind="put")
    res = mt.price_vanilla_rqmc(put, 1 << 12, SEED, CPU)
    want = BS - 100.0 + 100.0 * np.exp(-OPT.r * OPT.t)
    assert abs(float(res.price) - want) < 5 * float(res.std_error)


def test_basket_rqmc_matches_mc():
    opt = BasketOption.default_reference(3)
    res = mt.price_basket_rqmc(opt, 1 << 12, SEED, CPU)
    mc = mt.price_basket(opt, 1 << 18, 4, CPU_MC)
    se = float(np.hypot(float(res.std_error), float(mc.std_error)))
    assert abs(float(res.price) - float(mc.price)) < 4 * se
    assert float(res.ci) < float(mc.ci)


def test_asian_rqmc_matches_geometric_closed_form():
    geo = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=12,
                      average="geometric")
    res = mt.price_asian_rqmc(geo, 1 << 11, SEED, CPU, replicates=8)
    want = float(tmath.geometric_asian_call(100.0, 100.0, 0.05, 0.2, 1.0,
                                            12))
    assert abs(float(res.price) - want) < 5 * float(res.std_error)


@pytest.mark.parametrize("kind", ["call", "put"])
def test_greeks_rqmc_match_bs(kind):
    cf = {k: float(v) for k, v in
          tmath.bs_greeks(100.0, 100.0, 0.048790, 0.2, 1.0).items()}
    if kind == "put":
        disc = np.exp(-0.048790)
        cf["price"] -= 100.0 - 100.0 * disc
        cf["delta"] -= 1.0
        cf["rho"] -= 100.0 * disc
        cf["theta"] -= 0.048790 * 100.0 * disc
    g = tq.greeks_vanilla_rqmc(dataclasses.replace(OPT, kind=kind), 1 << 13,
                               SEED, CPU)
    for name in ("price", "delta", "vega", "rho", "theta", "gamma",
                 "vanna", "volga"):
        r = getattr(g, name)
        z = (float(r.price) - cf[name]) / max(float(r.std_error), 1e-15)
        assert abs(z) < 4.0, (name, float(r.price), cf[name], z)


def test_one_replicate_and_f64_refused():
    with pytest.raises(ValueError, match="replicates"):
        mt.price_vanilla_rqmc(OPT, 1024, SEED, CPU, replicates=1)
    with pytest.raises(NotImplementedError):
        mt.price_vanilla_rqmc(OPT, 1024, SEED, dataclasses.replace(
            CPU, precision=Precision.F64))


def test_asian_rows_cap_and_basket_rows():
    plan, _ = tq.asian_rqmc_setup(AsianOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                              n_obs=50), 1 << 18,
                                  mt.EngineConfig(device="cpu"), 16)
    assert (plan.rows, plan.paths_per_iter) == (163, 163 * 128)
    plan, _ = tq.basket_rqmc_setup(BasketOption.equicorrelated(3, 0.3),
                                   1 << 20, mt.EngineConfig(device="cpu"), 16)
    assert (plan.rows, plan.paths_per_iter, plan.iters) == (256, 256 * 32,
                                                            128)
