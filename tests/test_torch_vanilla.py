"""K1's plain version against the JAX vanilla kernel in interpret mode (CPU).

Both draw the same Philox stream, so the per-block partials agree to f32
rounding: ``rtol=2e-5``, because the two sum each tile in another order and
libm ``exp``/``log`` may differ by an ulp (about 1e-7 is observed).  The
block-offset contract and seed determinism are held bitwise.
"""
import jax
import numpy as np
import pytest

from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu.kernels import vanilla as jvanilla
from mctpu_torch.kernels import vanilla as tvanilla
from mctpu_torch.types import from_reference

RTOL = 2e-5
SEED = int(jrng.key_to_seed(jax.random.key(31)))
NB, ROWS = 4, 8


def _plans(iters, antithetic, kahan):
    paths = NB * iters * 2 * ROWS * 128
    jplan = jvanilla.make_plan(paths, NB, ROWS, antithetic, kahan=kahan)
    tplan = tvanilla.make_plan(paths, NB, ROWS, antithetic, kahan)
    for f in ("num_blocks", "iters", "rows", "paths_per_iter",
              "units_per_iter", "antithetic", "kahan"):
        assert getattr(tplan, f) == getattr(jplan, f)
    assert (tplan.total_paths, tplan.total_units) == (jplan.total_paths,
                                                      jplan.total_units)
    return jplan, tplan


@pytest.mark.parametrize("kind,antithetic,kahan,iters", [
    ("call", False, True, 3),
    ("put", False, True, 2),
    ("call", True, True, 2),
    ("put", True, False, 2),
    ("call", False, False, 3),
])
def test_partials_match_interpret_mode(kind, antithetic, kahan, iters):
    opt = jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
    jplan, tplan = _plans(iters, antithetic, kahan)
    want = np.asarray(jvanilla.pallas_partials(opt, SEED, 0, jplan, NB,
                                               interpret=True))
    par = tvanilla.params(from_reference(opt), "cpu")
    got = tvanilla.partials(par, SEED, 0, tplan, NB, kind == "put")
    assert got.shape == (NB, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_params_match_kernel_prep():
    opt = jtypes.VanillaOption(100.0, 95.0, 0.048790, 0.25, 1.5)
    par = tvanilla.params(from_reference(opt), "cpu").numpy()
    o = opt.astype(np.float32)
    mu = (o.r - 0.5 * o.v * o.v) * o.t
    sig = o.v * np.sqrt(o.t)
    np.testing.assert_array_equal(par, np.array([o.s, o.k, mu, sig],
                                                np.float32))


def test_block_offset_relabels_streams():
    _, tplan = _plans(2, False, True)
    par = tvanilla.params(from_reference(
        jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)), "cpu")
    full = tvanilla.partials(par, 9, 0, tplan, 4, False)
    tail = tvanilla.partials(par, 9, 2, tplan, 2, False)
    assert np.array_equal(full[2:].numpy(), tail.numpy())


def test_deterministic_in_seed():
    _, tplan = _plans(2, False, True)
    par = tvanilla.params(from_reference(
        jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)), "cpu")
    a = tvanilla.partials(par, 77, 0, tplan, NB, False).numpy()
    b = tvanilla.partials(par, 77, 0, tplan, NB, False).numpy()
    c = tvanilla.partials(par, 78, 0, tplan, NB, False).numpy()
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
