"""The Monte Carlo estimator (counterpart of :mod:`mctpu.estimator`).

    price   = discount * sum_p / n
    var     = max(n * sum_p2 - sum_p^2, 0) / (n * (n - 1))
    se      = discount * sqrt(var) / sqrt(n),   ci = 1.96 * se

in float64.  ``std_error`` and ``ci`` carry the discount like the price; the
CVA passes ``discount=1``, keeping the reference's undiscounted mean.
"""
from __future__ import annotations

import torch

from mctpu_torch.math import wide_dtype
from mctpu_torch.parallel.reduce import pairwise_tree_sum
from mctpu_torch.types import McResult

__all__ = ["combine_block_partials", "estimate"]


def combine_block_partials(partials: torch.Tensor):
    """``(num_blocks, 2)`` per-block ``[sum_p, sum_p2]`` -> float64 totals
    on the CPU, through the fixed-order pairwise tree."""
    total = pairwise_tree_sum(partials.to(wide_dtype()), dim=0).cpu()
    return total[0], total[1]


def estimate(sum_p, sum_p2, n: int, *, discount=1.0,
             n_paths: int | None = None) -> McResult:
    """Apply the reference estimator to global sums, in float64."""
    wide = wide_dtype()
    nf = torch.tensor(float(n), dtype=wide)
    sum_p = torch.as_tensor(sum_p, dtype=wide)
    sum_p2 = torch.as_tensor(sum_p2, dtype=wide)
    disc = torch.as_tensor(discount, dtype=wide)
    price = disc * sum_p / nf
    var = torch.clamp(nf * sum_p2 - sum_p * sum_p, min=0.0) / (nf * (nf - 1.0))
    se = disc * torch.sqrt(var) / torch.sqrt(nf)
    return McResult(price=price, ci=1.96 * se, std_error=se, sum_p=sum_p,
                    sum_p2=sum_p2, n=int(n),
                    n_paths=int(n_paths if n_paths is not None else n))
