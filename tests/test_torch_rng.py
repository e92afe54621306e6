"""The port's random stream against mctpu's (CPU).

Philox words, the key fold, tile indices and uniform bits must be
bit-equal: every kernel of the port draws this stream, and the block-by-block
parity with the JAX kernels rests on it.  The normals go through libm
``log``/``sqrt``, which may differ by an ulp between XLA and PyTorch, so
Box-Muller and the sin/cos polynomials are held at ``atol=1e-6``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mctpu import rng as jrng
from mctpu.kernels import common as jcommon
from mctpu.parallel.reduce import pairwise_tree_sum as j_tree_sum
from mctpu_torch import rng as trng
from mctpu_torch.kernels import common as tcommon
from mctpu_torch.parallel.reduce import pairwise_tree_sum as t_tree_sum

# Random123 philox4x32-10 known-answer vectors (as tests/test_rng.py).
KAT = [
    ((0, 0), (0, 0, 0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF,) * 4,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0xA4093822, 0x299F31D0),
     (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _i64(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.uint64).astype(np.int64))


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32).astype(np.int64)


@pytest.mark.parametrize("key,ctr,want", KAT)
def test_philox_known_answers(key, ctr, want):
    assert tuple(int(w) for w in trng.philox4x32(key, ctr)) == want
    words = trng.philox4x32(tuple(_i64(k) for k in key),
                            tuple(_i64(c) for c in ctr))
    assert tuple(int(w) for w in words) == want


def test_philox_bit_equal_on_random_counters():
    rng = np.random.default_rng(0)
    key = rng.integers(0, 1 << 32, (2, 4096), dtype=np.uint64)
    ctr = rng.integers(0, 1 << 32, (4, 4096), dtype=np.uint64)
    want = jrng.philox4x32(tuple(jnp.asarray(k, jnp.uint32) for k in key),
                           tuple(jnp.asarray(c, jnp.uint32) for c in ctr))
    got = trng.philox4x32(tuple(_i64(k) for k in key),
                          tuple(_i64(c) for c in ctr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _u32(w))


def test_mix32_bit_equal():
    x = np.random.default_rng(1).integers(0, 1 << 32, 4096, dtype=np.uint64)
    want = jcommon._mix32(jnp.asarray(x, jnp.uint32))
    np.testing.assert_array_equal(tcommon._mix32(_i64(x)).numpy(), _u32(want))


@pytest.mark.parametrize("words", [(0, 0), (77, 3), (-5, 2**31 - 1),
                                   (-(2**31), -1), (123456789, -987654)])
def test_seed_fold_bit_equal(words):
    with jcommon.prng_emulation():
        jcommon.seed_prng(*(jnp.int32(w) for w in words))
        want = tuple(int(k) for k in jcommon._EMU_SEED)
    assert tcommon.seed_key(*words) == want
    k0, k1 = tcommon.block_keys(words[0], [words[1]], "cpu")
    assert (int(k0), int(k1)) == want


@pytest.mark.parametrize("shape", [(8, 128), (16, 256)])
def test_tile_index_bit_equal(shape):
    want = np.asarray(jcommon._tile_index(shape)).reshape(-1)
    got = tcommon.tile_index(shape[0] * shape[1], "cpu")
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _bits(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, n,
                                                dtype=np.uint64)


def test_uniform_from_bits_bit_equal():
    b = np.concatenate([_bits(1 << 14, 2), [0, 1, 511, 512, 2**32 - 1]])
    want = np.asarray(jrng.uniform_from_bits(jnp.asarray(b, jnp.uint32)))
    got = trng.uniform_from_bits(_i64(b)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_sincos_and_box_muller_match():
    b1, b2 = _bits(1 << 14, 3), _bits(1 << 14, 4)
    jc, js = jrng.sincos_2pi_bits(jnp.asarray(b2, jnp.uint32))
    tc, ts = trng.sincos_2pi_bits(_i64(b2))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    jz = jrng.box_muller(jnp.asarray(b1, jnp.uint32),
                         jnp.asarray(b2, jnp.uint32))
    tz = trng.box_muller(_i64(b1), _i64(b2))
    for g, w in zip(tz, jz):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("n_steps", [6, 7])
def test_walk_pairwise_draw_order(n_steps):
    shape = (8, 128)
    seed, word = -42, 9

    def jax_walk():
        def step(j, z, carry):
            return carry.at[j].set(z)
        jcommon.seed_prng(jnp.int32(seed), jnp.int32(word))
        return jcommon.walk_pairwise(shape, n_steps, step,
                                     jnp.zeros((n_steps,) + shape,
                                               jnp.float32))

    with jax.enable_x64(False), jcommon.prng_emulation():
        want = np.asarray(jax_walk()).reshape(n_steps, -1)

    def step(j, z, carry):
        carry[j] = z
        return carry

    key = tcommon.seed_key(seed, word)
    got = tcommon.walk_pairwise(key, tcommon.tile_index(1024, "cpu"), n_steps,
                                step, torch.zeros((n_steps, 1024)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 5, 7, 64, 100])
def test_pairwise_tree_sum_bit_equal(n):
    x = np.random.default_rng(n).normal(size=(n, 3)) * 1e6
    want = np.asarray(j_tree_sum(jnp.asarray(x, jnp.float64), axis=0))
    got = t_tree_sum(torch.tensor(x, dtype=torch.float64), 0).numpy()
    np.testing.assert_array_equal(got, want)


def test_int32_seed_words():
    assert trng.wrap_int32(2**31) == -(2**31)
    assert trng.wrap_int32(-1) == -1
    assert trng.wrap_int32(2**32 + 5) == 5
    seed = int(jrng.key_to_seed(jax.random.key(31)))
    assert trng.wrap_int32(seed) == seed
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    s = trng.seed_from_generator(g1)
    assert s == trng.seed_from_generator(g2)
    assert -(2**31) <= s < 2**31
    assert trng.mul32(0xFFFFFFFF, 0xFFFFFFFF) == 1
