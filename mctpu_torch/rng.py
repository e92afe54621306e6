"""Counter-based random stream: Philox-4x32-10 and Box-Muller on tensors.

Counterpart of :mod:`mctpu.rng`.  The JAX package's kernels draw this exact
stream when they run in interpret mode (``mctpu.kernels.common``), and the
CUDA kernels draw it from ``csrc/philox.cuh``, so the port matches the JAX
kernels block by block.

torch has no full uint32 arithmetic: every u32 word is carried in an int64
tensor (or a Python int) and masked with ``& 0xFFFFFFFF``.  The 32x32-bit
products are split into 16-bit halves so that no intermediate exceeds 2**49
and int64 never overflows.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "M32",
    "philox4x32",
    "mul32",
    "uniform_from_bits",
    "sincos_2pi_bits",
    "box_muller",
    "wrap_int32",
    "seed_from_generator",
]

M32 = 0xFFFFFFFF

_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9  # golden ratio
_PHILOX_W1 = 0xBB67AE85  # sqrt(3) - 1


def _f32(x: float) -> float:
    """``x`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(x))


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit halves of the 64-bit product ``a * b``."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (t >> 32), t & M32


def mul32(x, c: int):
    """``x * c mod 2**32`` for u32 ``x`` (int64 tensor or int)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def philox4x32(key, ctr, rounds: int = 10):
    """Philox-4x32 block: key ``(k0, k1)`` and counter ``(c0, c1, c2, c3)``
    of u32 values (int64 tensors or ints, broadcastable) -> 4 u32 words."""
    k0, k1 = key
    c0, c1, c2, c3 = ctr
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & M32
        k1 = (k1 + _PHILOX_W1) & M32
    return c0, c1, c2, c3


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> float32 uniforms in [0, 1) via the mantissa trick."""
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


# Folded sin/cos polynomials of mctpu.rng (same coefficients, rounded to f32
# as the JAX kernels round them).
_SIN_C = tuple(_f32(c) for c in (
    1.5707963220833954, -0.6459638379804595, 0.07969037160884318,
    -0.004674962479799562, 0.00015212572840063213))
_COS_C = tuple(_f32(c) for c in (
    0.9999999672205848, -1.2336987443427399, 0.25365381634350864,
    -0.020816187054871052, 0.0008612789203638717))


def sincos_2pi_bits(bits: torch.Tensor):
    """(cos, sin) of ``2*pi*u`` for ``u = bits / 2**32``: the top two bits
    pick the quadrant, the other 30 the fraction of a quarter turn."""
    q = bits >> 30
    x = uniform_from_bits((bits << 2) & M32)
    x2 = x * x
    s0, s1, s2, s3, s4 = _SIN_C
    c0, c1, c2, c3, c4 = _COS_C
    s = x * (s0 + x2 * (s1 + x2 * (s2 + x2 * (s3 + x2 * s4))))
    c = c0 + x2 * (c1 + x2 * (c2 + x2 * (c3 + x2 * c4)))
    swap = (q & 1) == 1
    cq = torch.where(swap, s, c)
    sq = torch.where(swap, c, s)
    cos = torch.where((q == 1) | (q == 2), -cq, cq)
    sin = torch.where(q >= 2, -sq, sq)
    return cos, sin


def box_muller(bits1: torch.Tensor, bits2: torch.Tensor):
    """Two standard-normal float32 tensors (cosine and sine branches)."""
    u1 = 1.0 - uniform_from_bits(bits1)  # (0, 1]
    r = torch.sqrt(-2.0 * torch.log(u1))
    c, s = sincos_2pi_bits(bits2)
    return r * c, r * s


def wrap_int32(x: int) -> int:
    """``x`` reduced into the int32 range with two's-complement wrap."""
    return ((int(x) + (1 << 31)) & M32) - (1 << 31)


def seed_from_generator(gen: torch.Generator) -> int:
    """Draw one int32 kernel seed word from an explicit generator."""
    return int(torch.randint(-(1 << 31), 1 << 31, (1,), generator=gen,
                             dtype=torch.int64))
