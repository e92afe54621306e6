"""Weighted basket call on Cholesky-correlated GBM underlyings.

Counterpart of :mod:`mctpu.models.basket`: differentiable tensor functions
of pre-drawn normals, used by the autodiff Greeks
(:mod:`mctpu_torch.autodiff`).
"""
from __future__ import annotations

import torch

__all__ = ["correlate", "terminal_payoff", "payoff_from_brownian"]


def correlate(chol: torch.Tensor, d: torch.Tensor, z: torch.Tensor):
    """Correlated Brownian vector ``bt = L @ z + d`` for ``z (..., A)``."""
    return torch.einsum("ij,...j->...i", chol, z) + d


def payoff_from_brownian(s, v, w, k, r, t, bt):
    """Weighted-basket call payoff from a correlated vector ``bt``:
    ``s_j = s0_j exp((r - v_j^2/2) T + v_j sqrt(T) bt_j)``, payoff
    ``max(sum_j w_j s_j - K, 0)``."""
    drift = (r - 0.5 * v * v) * t
    s_t = s * torch.exp(drift + v * torch.sqrt(t) * bt)
    return torch.clamp(torch.einsum("...j,j->...", s_t, w) - k, min=0.0)


def terminal_payoff(s, v, w, d, k, r, t, chol, z):
    """Payoff of terminal samples ``z (..., A)``: correlate, then price the
    basket."""
    return payoff_from_brownian(s, v, w, k, r, t, correlate(chol, d, z))
