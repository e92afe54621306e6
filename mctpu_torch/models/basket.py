"""Weighted basket call on Cholesky-correlated GBM underlyings.

Counterpart of :mod:`mctpu.models.basket`: differentiable tensor functions
of pre-drawn normals, used by the autodiff Greeks
(:mod:`mctpu_torch.autodiff`), and a float64 oracle of the correlated
basket walk (the counterpart of ``mctpu.reference``'s ``_basket_walk``,
``price_basket_asian`` and ``price_basket_barrier``), which holds the
multi-asset walk kernels to account.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mctpu_torch import math as mcmath

__all__ = ["correlate", "terminal_payoff", "payoff_from_brownian",
           "basket_walk", "basket_asian_oracle", "basket_barrier_oracle"]


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


def basket_walk(opt, n_paths: int, n_obs: int, gen: torch.Generator,
                device="cpu"):
    """Yield the ``(n_paths,)`` float64 basket value ``w @ S`` at each of
    ``n_obs`` equally spaced dates of a correlated GBM basket, with the
    normals drawn from ``gen`` (on ``device``): ``S <- S exp((r - v^2/2)
    dt + v sqrt(dt) (L z + d / sqrt(n)))``, ``L`` the PSD-tolerant
    Cholesky factor of ``opt.corr``."""
    f64 = dict(dtype=torch.float64, device=device)
    s0, v, w, d = (torch.as_tensor(np.asarray(x, np.float64), **f64)
                   for x in (opt.s, opt.v, opt.w, opt.d))
    chol = mcmath.cholesky_lower(np.asarray(opt.corr, np.float64)).to(device)
    r, t = float(opt.r), float(opt.t)
    dt = t / n_obs
    drift = (r - 0.5 * v * v) * dt
    vol = v * math.sqrt(dt)
    d_step = d / math.sqrt(n_obs)
    s = s0.expand(n_paths, -1)
    for _ in range(n_obs):
        z = torch.randn((n_paths, opt.n_assets), generator=gen, **f64)
        s = s * torch.exp(drift + vol * (z @ chol.T + d_step))
        yield s @ w


def _estimate(pay: torch.Tensor, r: float, t: float):
    disc = math.exp(-r * t)
    return (disc * float(pay.mean()),
            disc * float(pay.std()) / math.sqrt(pay.numel()))


def basket_asian_oracle(opt, n_paths: int, seed: int, device="cpu"):
    """``(price, std_error)`` of a basket-Asian call by the float64 walk of
    :func:`basket_walk` with its own generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bk = opt.basket
    acc = sum(basket_walk(bk, n_paths, opt.n_obs, gen, device))
    pay = torch.clamp(acc / opt.n_obs - float(bk.k), min=0.0)
    return _estimate(pay, float(bk.r), float(bk.t))


def basket_barrier_oracle(opt, n_paths: int, seed: int, device="cpu"):
    """``(price, std_error)`` of a knock-out basket call by the float64 walk
    of :func:`basket_walk` with its own generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bk = opt.basket
    h = float(opt.barrier)
    alive = torch.ones(n_paths, dtype=torch.bool, device=device)
    for basket in basket_walk(bk, n_paths, opt.n_obs, gen, device):
        alive &= (basket < h) if opt.kind == "up-and-out" else (basket > h)
    pay = torch.where(alive, torch.clamp(basket - float(bk.k), min=0.0), 0.0)
    return _estimate(pay, float(bk.r), float(bk.t))
