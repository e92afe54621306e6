"""K4's plain version against the JAX CVA kernel in interpret mode (CPU).

Both the ``(B, 2)`` partials and the ``(B, n_grid)`` exposure-profile sums
are compared at ``rtol=2e-5``: same draws, other summation orders, libm
``exp``/``log`` within an ulp.  Under wrong-way risk ``rtol=1e-4``: the
hazard's ``y < 0.01`` series switch can flip on a one-ulp difference.
Each case runs 2 blocks of ``rows=8`` for one or two iterations.
"""
import jax
import numpy as np
import pytest

from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import cva as jcva
from mctpu_torch.kernels import cva as tcva
from mctpu_torch.types import from_reference

SEED = int(jrng.key_to_seed(jax.random.key(11)))
NB, ROWS = 2, 8


def _single(n_grid, wwr_b=0.0):
    spec = jtypes.CvaSpec(intensity=0.03, lgd=0.6,
                          option=jtypes.VanillaOption(100.0, 100.0, 0.05,
                                                      0.2, 1.0),
                          n_grid=n_grid)
    return jtypes.CvaPortfolioSpec.from_single(spec, wwr_b=wwr_b)


CASES = {
    # name: (portfolio, precision, antithetic, iters, rtol)
    "single_grid10": (_single(10), "f32_kahan", False, 1, 2e-5),
    "odd_grid7": (_single(7), "f32_kahan", False, 2, 2e-5),
    "netted_long_short": (jtypes.CvaPortfolioSpec(
        0.03, 0.6, 100.0, 0.05, 0.2, 1.0, np.array([95.0, 110.0]),
        np.array([1.0, -0.5]), 0.0, 6), "f32_kahan", False, 1, 2e-5),
    "wrong_way_risk": (_single(6, wwr_b=0.8), "f32_kahan", False, 1, 1e-4),
    "f32_ds": (_single(6), "f32_ds", False, 1, 2e-5),
    "antithetic_f32": (_single(5), "f32", True, 1, 2e-5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_and_profile_match_interpret_mode(case):
    port, prec, antithetic, iters, rtol = CASES[case]
    p = jtypes.Precision(prec)
    paths = NB * iters * ROWS * 128
    jplan = jcva.make_plan(paths, NB, ROWS, antithetic, kahan=p.kahan,
                           ds=p.ds)
    tplan = tcva.make_plan(paths, NB, ROWS, antithetic, p.kahan, p.ds)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan", "ds"):
        assert getattr(tplan, f) == getattr(jplan, f)
    wwr = float(port.wwr_b) != 0.0
    want, want_ee = (np.asarray(x) for x in jcva.pallas_partials(
        port, SEED, 1, jplan, NB, interpret=True, wwr=wwr))
    got, got_ee = tcva.partials(tcva.operands(from_reference(port), "cpu"),
                                SEED, 1, tplan, NB, wwr)
    assert got.shape == (NB, 2) and got_ee.shape == (NB, port.n_grid)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    np.testing.assert_allclose(got_ee.numpy(), want_ee, rtol=rtol, atol=0)


def test_node_constants_match():
    port = _single(50, wwr_b=0.5)
    sp = port.astype(np.float32)
    tport = from_reference(port)
    ops = tcva.operands(tport, "cpu")
    with jax.enable_x64(False):
        dp, _, drift, vol = jcva.node_constants(sp, np.float32)
        bs = jcva.bs_node_constants(sp, np.float32)
        mu, isig = jcva.wwr_node_constants(sp, np.float32)
    want = np.stack([np.asarray(x) for x in (dp, *bs, mu, isig)])
    np.testing.assert_allclose(ops.nodes.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ops.scal[4:6].numpy(),
                               [float(drift), float(vol)], rtol=1e-6)


def test_block_offset_relabels_streams():
    port = from_reference(_single(5))
    tplan = tcva.make_plan(4 * ROWS * 128, 4, ROWS, False)
    ops = tcva.operands(port, "cpu")
    full, full_ee = tcva.partials(ops, 9, 0, tplan, 4, False)
    tail, tail_ee = tcva.partials(ops, 9, 2, tplan, 2, False)
    assert np.array_equal(full[2:].numpy(), tail.numpy())
    assert np.array_equal(full_ee[2:].numpy(), tail_ee.numpy())
