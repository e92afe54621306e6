"""Compensated accumulation on tensors (counterpart of ``mctpu.utils.accum``).

``kahan_add`` is the Neumaier variant the per-block sums use; ``two_sum`` and
``ds_add`` keep the CVA walk's carried log-spot as a normalized double-single
``(hi, lo)`` pair under ``Precision.F32_DS``.  Every operation is one IEEE
add or subtract, so the CUDA kernels (``csrc/common.cuh``) compute the same
values.
"""
from __future__ import annotations

import torch

__all__ = ["kahan_add", "two_sum", "ds_add"]


def kahan_add(carry, x):
    """Neumaier compensated add of ``x`` into ``carry = (sum, comp)``."""
    s, c = carry
    t = s + x
    lost = torch.where(s.abs() >= x.abs(), (s - t) + x, (x - t) + s)
    return t, c + lost


def two_sum(a, b):
    """Knuth's branch-free error-free transformation: ``a + b = s + e``."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def ds_add(hi, lo, x):
    """Add ``x`` into the normalized double-single ``(hi, lo)``."""
    s, e = two_sum(hi, x)
    lo = lo + e
    hi2 = s + lo
    lo2 = lo - (hi2 - s)
    return hi2, lo2
