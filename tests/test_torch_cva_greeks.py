"""K5's plain version against the JAX CVA Greeks kernel in interpret mode
(CPU).

Both draw the same Philox stream, so the ``(B, 14)`` partials agree to f32
rounding.  Each ``(sum x, sum x^2)`` pair is held by the scaled bound of
``tests/torch_tolerance.py`` (``rtol * (|want sum x| + sqrt(n * want sum
x^2))``, ``n`` the units per block) at ``rtol=2e-5``; under wrong-way risk
at ``rtol=1e-4``, because the hazard's ``y < 0.01`` series switch can flip
on a one-ulp difference.  The node tables are held at ``rtol=1e-6`` (the
two difference tables also at two ulp of their terms).  Each
case runs 2 blocks of ``rows=8``; interpret-mode K5 is the slow kernel, so
the grids are short.
"""
import jax
import numpy as np
import pytest

from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import cva as jcva
from mctpu_torch.kernels import cva as tcva
from mctpu_torch.types import from_reference
from torch_tolerance import assert_pairs_close

SEED = int(jrng.key_to_seed(jax.random.key(17)))
NB, ROWS = 2, 8


def _single(n_grid, wwr_b=0.0):
    spec = jtypes.CvaSpec(intensity=0.03, lgd=0.6,
                          option=jtypes.VanillaOption(100.0, 100.0, 0.05,
                                                      0.2, 1.0),
                          n_grid=n_grid)
    return jtypes.CvaPortfolioSpec.from_single(spec, wwr_b=wwr_b)


CASES = {
    # name: (portfolio, antithetic, iters, rtol)
    "single_grid8": (_single(8), False, 1, 2e-5),
    "odd_grid7": (_single(7), False, 2, 2e-5),
    "netted_long_short": (jtypes.CvaPortfolioSpec(
        0.03, 0.6, 100.0, 0.05, 0.2, 1.0, np.array([95.0, 110.0]),
        np.array([1.0, -0.5]), 0.0, 6), False, 1, 2e-5),
    "wrong_way_risk": (_single(6, wwr_b=0.5), False, 1, 1e-4),
    "antithetic": (_single(5), True, 1, 2e-5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greek_partials_match_interpret_mode(case):
    port, antithetic, iters, rtol = CASES[case]
    paths = NB * iters * ROWS * 128
    jplan = jcva.make_plan(paths, NB, ROWS, antithetic)
    tplan = tcva.make_plan(paths, NB, ROWS, antithetic)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan", "ds"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    wwr = float(port.wwr_b) != 0.0
    want = np.asarray(jcva.greek_pallas_partials(
        port, SEED, 1, jplan, NB, interpret=True, wwr=wwr))
    got = tcva.greek_partials(tcva.greek_operands(from_reference(port), "cpu"),
                              SEED, 1, tplan, NB, wwr)
    assert got.shape == (NB, tcva.N_GREEK_SUMS)
    assert_pairs_close(got.numpy(), want,
                       tplan.iters * tplan.units_per_iter, rtol)


def test_greek_tables_match():
    port = jtypes.CvaPortfolioSpec(0.03, 0.6, 100.0, 0.05, 0.2, 1.0,
                                   np.array([95.0, 110.0]),
                                   np.array([1.0, -0.5]), 0.5, 50)
    with jax.enable_x64(False):
        tb, sc = jcva._greek_tables(port.astype(np.float32), np.float32)
        want_nodes = np.stack([np.asarray(tb[k]) for k in tcva.GREEK_NODES])
        want_scal = np.array([np.asarray(sc[k]) for k in tcva.GREEK_SCAL
                              if k != "lgd"], np.float32)
    ops = tcva.greek_operands(from_reference(port), "cpu")
    # ddp and ddp2 are differences of neighbouring terms t_j^p e^{-lam t_j}
    # (p = 1, 2; each at most max(t, t^2) = 1): one ulp of libm exp in a
    # term is ~3e-6 of the difference, so they also get 2 ulp of the term.
    atol = np.zeros((len(tcva.GREEK_NODES), 1))
    atol[[tcva.GREEK_NODES.index("ddp"), tcva.GREEK_NODES.index("ddp2")]] = (
        2 * np.finfo(np.float32).eps)
    err = np.abs(ops.nodes.numpy() - want_nodes)
    assert (err <= 1e-6 * np.abs(want_nodes) + atol).all(), err.max(1)
    scal = ops.scal.numpy()
    lgd = tcva.GREEK_SCAL.index("lgd")
    np.testing.assert_allclose(np.delete(scal, lgd), want_scal, rtol=1e-6)
    assert scal[lgd] == np.float32(0.6)
    np.testing.assert_allclose(ops.opts.numpy(), np.stack([
        [95.0, 110.0], [1.0, -0.5], np.log(np.float32([95.0, 110.0]))]),
        rtol=1e-7)


def test_block_offset_relabels_streams():
    port = from_reference(_single(5, wwr_b=0.5))
    plan = tcva.make_plan(4 * ROWS * 128, 4, ROWS, False)
    ops = tcva.greek_operands(port, "cpu")
    full = tcva.greek_partials(ops, 9, 0, plan, 4, True)
    tail = tcva.greek_partials(ops, 9, 2, plan, 2, True)
    assert np.array_equal(full[2:].numpy(), tail.numpy())
