"""The multi-asset walk pricers of the port against mctpu (CPU): K30's and
K31's plain versions against the JAX kernels in interpret mode, the operand
tables against ``mctpu``'s builders bit for bit, the engine entry points
against ``mctpu.engine`` on interpret-mode Pallas, the float64 oracle
against ``mctpu.reference``'s, and the records.

Both packages draw the same Philox stream, so the ``(B, 2)`` partials agree
at ``rtol=2e-5`` (the two sum a block in other orders, and XLA may contract
or reorder the operand arithmetic and the packed regime's dot).  Each
interpret-mode call costs several seconds here, so each case runs once: 2
blocks of ``rows=8``, one or two iterations, short walks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mctpu_torch
from mctpu import engine as jengine
from mctpu import math as jmath
from mctpu import reference as jref
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import multi_walk as jmw
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import common as tcommon
from mctpu_torch.kernels import multi_walk as tmw
from mctpu_torch.models import basket as tmodels
from mctpu_torch.types import (BasketAsianOption, BasketBarrierOption,
                               BasketOption, from_reference)

RTOL = 2e-5
KEY = jax.random.key(31)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8

# A basket whose every operand row differs by asset (spots, vols, weights,
# drift shifts), for the bitwise table checks.
MIXED = jtypes.BasketOption(
    s=np.array([95.0, 100.0, 110.0]), v=np.array([0.2, 0.3, 0.25]),
    w=np.array([0.5, 0.3, 0.2]),
    corr=np.array([[1.0, 0.3, -0.2], [0.3, 1.0, 0.4], [-0.2, 0.4, 1.0]]),
    d=np.array([0.1, -0.05, 0.0]), k=100.0, r=0.03, t=1.5)

CASES = {
    # name: (assets, product, n_obs, up, barrier, antithetic, kahan, iters)
    "K30_a3_asian_n5": (3, "asian", 5, True, None, False, True, 1),
    "K30_a3_up_n4_antithetic_f32_2iters": (3, "barrier", 4, True, 104.0,
                                           True, False, 2),
    "K30_a1_down_n7": (1, "barrier", 7, False, 97.0, False, True, 1),
    "K30_a8_asian_n2": (8, "asian", 2, True, None, False, True, 1),
    "K31_a16_asian_n5": (16, "asian", 5, True, None, False, True, 1),
    "K31_a16_up_n4_antithetic": (16, "barrier", 4, True, 104.0, True, True,
                                 1),
    "K31_a16_down_n3_f32_2iters": (16, "barrier", 3, False, 97.0, False,
                                   False, 2),
}


def _chol64(bk):
    """``mctpu.engine``'s float64 factor of ``bk.corr`` (as a NumPy array)."""
    with jax.enable_x64(True):
        return np.asarray(jmath.cholesky_lower(jnp.asarray(bk.corr,
                                                           jnp.float64)))


def _plans(a: int, antithetic: bool, kahan: bool, iters: int):
    probe = jmw.make_plan(1, NB, ROWS, antithetic, kahan=kahan, n_assets=a)
    paths = NB * iters * probe.paths_per_iter
    jplan = jmw.make_plan(paths, NB, ROWS, antithetic, kahan=kahan,
                          n_assets=a)
    tplan = tmw.make_plan(paths, NB, ROWS, antithetic, kahan, n_assets=a)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    return jplan, tplan


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_interpret_mode(case):
    a, product, n_obs, up, h, antithetic, kahan, iters = CASES[case]
    bk = jtypes.BasketOption.equicorrelated(a, 0.3)
    jplan, tplan = _plans(a, antithetic, kahan, iters)
    want = np.asarray(jmw.pallas_partials(
        bk, _chol64(bk), SEED, 1, jplan, NB, product=product, n_obs=n_obs,
        barrier=h, up=up, interpret=True))
    tb = from_reference(bk)
    lt, par = tmw.walk_ops(tb, tmath.cholesky_lower(tb.corr), n_obs)
    got = tmw.partials(lt, par, tmw.scalars(tb, h), SEED, 1, tplan, NB,
                       product, n_obs, up)
    assert got.shape == (NB, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("basket", ["mixed", "eq1", "eq8", "eq16", "eq100"])
@pytest.mark.parametrize("n_obs", [7, 50])
def test_walk_ops_match_mctpu_builders(basket, n_obs):
    """The port's step rows equal ``_am_walk_ops`` (a <= 8) or
    ``_step_ops`` on a path's lanes (packed), as ``mctpu``'s source forms
    them (eagerly), bit for bit."""
    bk = (MIXED if basket == "mixed"
          else jtypes.BasketOption.equicorrelated(int(basket[2:]), 0.3))
    a = bk.n_assets
    ch = _chol64(bk)
    with jax.enable_x64(False):
        o = bk.astype(jnp.float32)
        if a <= 8:
            jlt, jpar = jmw._am_walk_ops(o, ch, jnp.float32, n_obs)
            want_lt, want = np.asarray(jlt), np.asarray(jpar)
        else:
            ops = jmw._step_ops(o, ch, jnp.float32, n_obs)
            want = np.stack([np.asarray(ops[k])[0, :a] for k in
                             ("log_s0", "drift", "vol", "d")]
                            + [np.asarray(ops["wsel"])[:a, 0]])
            want_lt = np.asarray(ops["chol_bd"])[:a, :a].T
            a_tile = jmw.pack_factor(a)[0]
            lanes = np.arange(np.asarray(ops["log_s0"]).shape[1])
            assert (np.asarray(ops["log_s0"])[0, lanes % a_tile >= a]
                    == 0).all()
    tb = from_reference(bk)
    lt, par = tmw.walk_ops(tb, tmath.cholesky_lower(tb.corr), n_obs)
    assert lt.dtype == par.dtype == torch.float32
    np.testing.assert_array_equal(par.numpy(), want)
    np.testing.assert_array_equal(lt.numpy(), want_lt)


@pytest.mark.parametrize("n_steps", [1, 4, 5])
def test_walk_pairwise_multi_counter_map(n_steps):
    """Pair jj draws counter jj * n + i for draw i; cosine branches feed step
    2jj, sine branches 2jj+1; an odd count ends on the cosine branches of
    pair n_steps // 2."""
    n = 3
    key = tcommon.block_keys(SEED, [5], "cpu")
    idx = tcommon.tile_index(16, "cpu")
    seen = {}

    def step(j, zs, carry):
        seen[j] = zs
        return carry + 1

    assert tcommon.walk_pairwise_multi(key, idx, n, n_steps, step,
                                       0) == n_steps
    for j in range(n_steps):
        for i in range(n):
            pair = tcommon.draw_normal_pair(key, idx, (j // 2) * n + i)
            assert torch.equal(seen[j][i], pair[j % 2])


@pytest.mark.parametrize("a", [3, 16])
def test_block_offset_relabels_streams(a):
    tb = BasketOption.equicorrelated(a, 0.3)
    lt, par = tmw.walk_ops(tb, tmath.cholesky_lower(tb.corr), 5)
    scal = tmw.scalars(tb, 104.0)
    probe = tmw.make_plan(1, 4, ROWS, False, n_assets=a)
    plan = tmw.make_plan(4 * 2 * probe.paths_per_iter, 4, ROWS, False,
                         n_assets=a)
    full = tmw.partials(lt, par, scal, 9, 0, plan, 4, "barrier", 5)
    tail = tmw.partials(lt, par, scal, 9, 2, plan, 2, "barrier", 5)
    assert torch.equal(full[2:], tail)


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=8,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")


@pytest.mark.parametrize("case", ["asian_default_reference3",
                                  "up_equicorrelated3",
                                  "down_equicorrelated16"])
def test_engine_prices_match_mctpu(case):
    if case == "asian_default_reference3":
        opt = jtypes.BasketAsianOption(jtypes.BasketOption.default_reference(3),
                                       n_obs=6)
        jfn, tfn = jengine.price_basket_asian, mctpu_torch.price_basket_asian
    else:
        a = 3 if case.startswith("up") else 16
        opt = jtypes.BasketBarrierOption(
            jtypes.BasketOption.equicorrelated(a, 0.3),
            104.0 if case.startswith("up") else 97.0, n_obs=5,
            kind="up-and-out" if case.startswith("up") else "down-and-out")
        jfn, tfn = (jengine.price_basket_barrier,
                    mctpu_torch.price_basket_barrier)
    n = 1 << 13
    want = jfn(opt, n, KEY, JCFG)
    got = tfn(from_reference(opt), n, SEED, TCFG)
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for field in ("price", "std_error", "ci"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=RTOL)


def test_single_asset_basket_asian_is_price_asian():
    """At a = 1 the asset-major walk draws K9's stream (counter jj) and
    steps the same log-spot: the prices agree to the drift's last ulp."""
    one = BasketOption(s=[100.0], v=[0.2], w=[1.0], corr=[[1.0]], d=[0.0],
                       k=100.0, r=0.05, t=1.0)
    n = 1 << 13
    got = mctpu_torch.price_basket_asian(BasketAsianOption(one, n_obs=7), n,
                                         SEED, TCFG)
    want = mctpu_torch.price_asian(
        mctpu_torch.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=7), n,
        SEED, TCFG)
    assert got.n_paths == want.n_paths
    np.testing.assert_allclose(float(got.price), float(want.price),
                               rtol=1e-5)


@pytest.mark.parametrize("product", ["asian", "barrier"])
def test_oracle_matches_mctpu_reference(product):
    """The port's float64 oracle and ``mctpu.reference``'s draw their own
    streams: they agree within 4 combined standard errors."""
    bk = jtypes.BasketOption.equicorrelated(3, 0.3)
    n = 1 << 15
    if product == "asian":
        opt = jtypes.BasketAsianOption(bk, n_obs=12)
        want = jref.price_basket_asian(opt, n, seed=3)
        got = tmodels.basket_asian_oracle(from_reference(opt), n, seed=3)
    else:
        opt = jtypes.BasketBarrierOption(bk, 115.0, n_obs=12)
        want = jref.price_basket_barrier(opt, n, seed=3)
        got = tmodels.basket_barrier_oracle(from_reference(opt), n, seed=3)
    se = np.hypot(got[1], float(want.std_error))
    assert abs(got[0] - float(want.price)) < 4 * se


def test_records_carry_and_validate():
    bk = jtypes.BasketOption.equicorrelated(3, 0.3)
    ja = jtypes.BasketAsianOption(bk, n_obs=9)
    jb = jtypes.BasketBarrierOption(bk, 120.0, n_obs=11, kind="up-and-out")
    ta, tb = from_reference(ja), from_reference(jb)
    assert isinstance(ta, BasketAsianOption) and ta.n_obs == 9
    assert isinstance(tb, BasketBarrierOption)
    assert (tb.barrier, tb.n_obs, tb.kind) == (120.0, 11, "up-and-out")
    assert isinstance(ta.basket, BasketOption)
    np.testing.assert_array_equal(tb.basket.corr, np.asarray(bk.corr))
    ta.validate()
    tb.validate()
    with pytest.raises(ValueError, match="already knocked out"):
        dataclasses.replace(tb, barrier=99.0).validate()
    with pytest.raises(ValueError, match="already knocked out"):
        dataclasses.replace(tb, barrier=101.0, kind="down-and-out").validate()
    with pytest.raises(ValueError, match="kind"):
        dataclasses.replace(tb, kind="up-and-in").validate()
    with pytest.raises(ValueError, match="n_obs"):
        dataclasses.replace(ta, n_obs=0).validate()
    with pytest.raises(ValueError, match="n_obs"):
        mctpu_torch.price_basket_barrier(dataclasses.replace(tb, n_obs=0),
                                         1 << 10, SEED, TCFG)


def test_partials_reject_unknown_product():
    tb = BasketOption.equicorrelated(3, 0.3)
    lt, par = tmw.walk_ops(tb, tmath.cholesky_lower(tb.corr), 3)
    plan = tmw.make_plan(1 << 10, 1, ROWS, False)
    with pytest.raises(ValueError, match="product"):
        tmw.partials(lt, par, tmw.scalars(tb), SEED, 0, plan, 1, "lookback",
                     3)
