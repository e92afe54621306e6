"""The rainbow Greeks of the port against mctpu (CPU): K38's plain version
against the JAX kernel in interpret mode, its operands against ``mctpu``'s,
``greeks_rainbow`` against ``mctpu.engine`` on interpret-mode Pallas and
against autograd of the port's Stulz form, the ``k = 0`` identities, the
Greeks price against ``price_rainbow``'s, and what the entry points refuse.

The ``(B, 6 + 4a)`` per-block ``(sum x, sum x^2)`` pairs are held by the
scaled bound of ``tests/torch_tolerance.py`` at ``rtol=2e-5``: theta's
``-r P`` cancels part of its integrand, so a plain relative bound would
test the cancellation, not the port.  Each interpret-mode call runs once:
2 blocks of ``rows=8``, two iterations.
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
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import rainbow as jrb
from mctpu_torch import engine as tengine
from mctpu_torch import math as tmath
from mctpu_torch.kernels import rainbow as trb
from mctpu_torch.types import GreeksResult, RainbowOption, from_reference
from torch_tolerance import assert_pairs_close

RTOL = 2e-5
KEY = jax.random.key(43)
SEED = int(jrng.key_to_seed(KEY))
NB, ROWS = 2, 8
STRIKE_MIN = {1: 100.0, 2: 95.0, 3: 90.0, 8: 85.0}


def _ref_opt(a: int, kind: str):
    rng = np.random.default_rng(200 + a)
    return jtypes.RainbowOption(
        s=rng.uniform(90.0, 110.0, a), v=rng.uniform(0.15, 0.35, a),
        corr=jtypes.BasketOption.equicorrelated(a, 0.4).corr,
        k=100.0 if kind == "max" else STRIKE_MIN[a], r=0.04, t=1.5, kind=kind)


def _chol64(corr):
    with jax.enable_x64(True):
        return np.asarray(jmath.cholesky_lower(jnp.asarray(corr,
                                                           jnp.float64)))


# Every (kind, antithetic, Kahan) variant at 1, 2 and 3 assets; at 8 assets,
# whose interpret-mode trace takes 25-45 s on a CPU, one variant per kind.
CASES = [(a, kind, anti, kahan) for a in (1, 2, 3) for kind in ("max", "min")
         for anti in (False, True) for kahan in (False, True)]
CASES += [(8, "max", False, False), (8, "min", True, True)]


@pytest.mark.parametrize("a,kind,antithetic,kahan", CASES)
def test_greek_partials_match_interpret_mode(a, kind, antithetic, kahan):
    opt = _ref_opt(a, kind)
    probe = jrb.make_plan(1, NB, ROWS, antithetic, n_assets=a)
    paths = NB * 2 * probe.paths_per_iter
    jplan = jrb.make_plan(paths, NB, ROWS, antithetic, kahan=kahan,
                          n_assets=a)
    tplan = trb.make_plan(paths, NB, ROWS, antithetic, kahan, n_assets=a)
    assert (tplan.iters, tplan.units_per_iter) == (jplan.iters,
                                                   jplan.units_per_iter)
    want = np.asarray(jrb.greek_pallas_partials(
        opt, _chol64(opt.corr), SEED, 1, jplan, NB, interpret=True))
    to = from_reference(opt)
    ops = trb.greek_operands(to, tmath.cholesky_lower(to.corr), "cpu")
    got = trb.greek_partials(ops, SEED, 1, tplan, NB)
    assert got.shape == want.shape == (NB, trb.n_greek_sums(a))
    assert (want[:, 0] > 0).all()
    assert_pairs_close(got.numpy(), want, tplan.iters * tplan.units_per_iter,
                       RTOL)


@pytest.mark.parametrize("a", [1, 3, 8])
def test_greek_operands_match_mctpu(a):
    """``scal = [k, t, sqrt(t), r]`` and ``1 / s0`` as
    ``greek_pallas_partials`` forms them, bit for bit."""
    opt = _ref_opt(a, "max")
    with jax.enable_x64(False):
        o = opt.astype(jnp.float32)
        t = jnp.asarray(o.t, jnp.float32)
        want_scal = np.asarray(jnp.stack([o.k, t, jnp.sqrt(t), o.r]))
        want_inv = np.asarray(1.0 / jnp.broadcast_to(
            jnp.asarray(o.s, jnp.float32), (a,)))
        jlt, jpar = (np.asarray(x) for x in jrb.rainbow_am_ops(
            o, _chol64(opt.corr), jnp.float32))
    to = from_reference(opt)
    ops = trb.greek_operands(to, tmath.cholesky_lower(to.corr), "cpu")
    np.testing.assert_array_equal(ops.scal.numpy(), want_scal)
    np.testing.assert_array_equal(ops.inv_s0.numpy(), want_inv)
    np.testing.assert_array_equal(ops.lt.numpy(), jlt)
    np.testing.assert_array_equal(ops.par.numpy(), jpar)


def test_block_offset_relabels_streams():
    to = from_reference(_ref_opt(3, "min"))
    ops = trb.greek_operands(to, tmath.cholesky_lower(to.corr), "cpu")
    plan = trb.make_plan(1, 4, ROWS, False, n_assets=3)
    full = trb.greek_partials(ops, 9, 0, plan, 4)
    tail = trb.greek_partials(ops, 9, 2, plan, 2)
    assert torch.equal(full[2:], tail)


JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=8,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=8, rows=8, device="cpu")


@pytest.mark.parametrize("a,kind", [(3, "max"), (2, "min")])
def test_engine_greeks_match_mctpu(a, kind):
    opt = _ref_opt(a, kind)
    n = 1 << 13
    want = jengine.greeks_rainbow(opt, n, KEY, JCFG)
    got = mctpu_torch.greeks(from_reference(opt), n, SEED, TCFG)
    assert isinstance(got, GreeksResult) and got.gamma is None
    for f in ("price", "rho", "theta", "delta", "vega"):
        r, w = getattr(got, f), getattr(want, f)
        assert (r.n, r.n_paths) == (w.n, w.n_paths)
        pairs = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                          for x in (r.sum_p, r.sum_p2)], 1)
        wpairs = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                           for x in (w.sum_p, w.sum_p2)], 1)
        assert pairs.shape == wpairs.shape == ((a, 2) if f in ("delta",
                                                               "vega")
                                               else (1, 2))
        assert_pairs_close(pairs.reshape(1, -1), wpairs.reshape(1, -1),
                           w.n, 1e-5)


@pytest.mark.parametrize("a,kind,antithetic", [(1, "max", False),
                                               (3, "min", True),
                                               (8, "max", False)])
def test_greeks_price_equals_pricer(a, kind, antithetic):
    """K38 draws K36's paths and shares its per-path core: the prices are
    equal."""
    opt = from_reference(_ref_opt(a, kind))
    cfg = dataclasses.replace(TCFG, antithetic=antithetic)
    g = mctpu_torch.greeks_rainbow(opt, 1 << 13, SEED, cfg)
    p = mctpu_torch.price_rainbow(opt, 1 << 13, SEED, cfg)
    assert float(g.price.price) == float(p.price)
    assert float(g.price.std_error) == float(p.std_error)
    assert g.delta.price.shape == g.vega.price.shape == (a,)


def _two_asset(kind, k=100.0):
    return RainbowOption(s=np.array([100.0, 95.0]), v=np.array([0.2, 0.3]),
                         corr=np.array([[1.0, 0.5], [0.5, 1.0]]), k=k,
                         r=0.05, t=1.0, kind=kind)


@pytest.mark.parametrize("kind", ["max", "min"])
def test_two_asset_greeks_match_stulz_autograd(kind):
    """``tests/test_greeks.py``'s gate: every output within 4 standard
    errors of autograd of the Stulz closed form."""
    xs = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
          for x in (100.0, 95.0, 0.2, 0.3, 0.05, 1.0)]
    s1, s2, v1, v2, r, t = xs
    f = getattr(tmath, f"rainbow_{kind}_call")
    price = f(s1, s2, 100.0, r, v1, v2, 0.5, t)
    price.backward()
    want = {"price": price.item(), "delta": [float(s1.grad), float(s2.grad)],
            "vega": [float(v1.grad), float(v2.grad)], "rho": float(r.grad),
            "theta": float(t.grad)}
    cfg = tengine.EngineConfig(num_blocks=16, rows=8, device="cpu")
    res = mctpu_torch.greeks(_two_asset(kind), 1 << 16, SEED, cfg)
    for name, w in want.items():
        got = getattr(res, name)
        z = (got.price.numpy() - np.asarray(w)) / np.maximum(
            got.std_error.numpy(), 1e-12)
        assert (np.abs(z) < 4.0).all(), (kind, name, got.price, w)


def test_k_zero_identities():
    """At k = 0 the rho integrand t k I is identically 0, and each asset's
    max and min deltas sum to 1 (every path's spot is the extreme of
    exactly one kind)."""
    cfg = tengine.EngineConfig(num_blocks=16, rows=8, device="cpu")
    gmax = mctpu_torch.greeks(_two_asset("max", 0.0), 1 << 16, SEED, cfg)
    gmin = mctpu_torch.greeks(_two_asset("min", 0.0), 1 << 16, SEED, cfg)
    assert float(gmax.rho.price) == 0.0 and float(gmin.rho.price) == 0.0
    d = gmax.delta.price.numpy() + gmin.delta.price.numpy()
    se = np.hypot(gmax.delta.std_error.numpy(), gmin.delta.std_error.numpy())
    assert (np.abs(d - 1.0) < 4 * se).all(), d


def test_wide_rainbow_greeks_raise():
    """Beyond 8 assets the Greeks are refused, as in ``mctpu``; the pricer
    still runs."""
    ref = dataclasses.replace(_ref_opt(8, "max"), s=np.full(9, 100.0),
                              v=np.full(9, 0.2), corr=np.eye(9))
    with pytest.raises(ValueError, match="asset-major"):
        jengine.greeks_rainbow(ref, 1 << 10, KEY, JCFG)
    opt = from_reference(ref)
    with pytest.raises(ValueError, match="asset-major"):
        mctpu_torch.greeks_rainbow(opt, 1 << 10, SEED, TCFG)
    with pytest.raises(ValueError, match="asset-major"):
        mctpu_torch.greeks(opt, 1 << 10, SEED, TCFG)
    assert np.isfinite(float(mctpu_torch.price_rainbow(opt, 1 << 10, SEED,
                                                       TCFG).price))


def test_entry_points_validate():
    opt = from_reference(_ref_opt(2, "max"))
    with pytest.raises(ValueError, match="kind"):
        mctpu_torch.price_rainbow(dataclasses.replace(opt, kind="median"),
                                  1 << 10, SEED, TCFG)
    with pytest.raises(ValueError, match="strike"):
        mctpu_torch.greeks_rainbow(dataclasses.replace(opt, k=-1.0), 1 << 10,
                                   SEED, TCFG)
