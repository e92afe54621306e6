"""Fixed-order pairwise combine of per-block partial sums.

Same association as ``mctpu.parallel.reduce.pairwise_tree_sum``: an odd
trailing row folds into the first, then the two halves add elementwise,
until one row is left.  Run in float64, it makes the combine independent of
how the blocks were computed; no block partial is ever added atomically.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_tree_sum"]


def pairwise_tree_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum along ``dim`` with the fixed pairwise-tree association."""
    x = torch.movedim(x, dim, 0)
    n = x.shape[0]
    while n > 1:
        if n % 2:
            x = torch.cat([x[:1] + x[n - 1:n], x[1:n - 1]], dim=0)
            n -= 1
        half = n // 2
        x = x[:half] + x[half:n]
        n = half
    return x[0]
