"""Randomized quasi-Monte Carlo on rank-1 shifted lattice rules
(counterpart of :mod:`mctpu.qmc`).

``u_i = frac(i * g / n + shift)`` with the Korobov generating vector
``g_j = a^j mod n``, ``n`` prime; R uniform shifts give R unbiased
replicate estimates whose spread is the CI.  Normals by the inverse CDF.
The unshifted lattice is exact (host int64); the shifts come from a CPU
``torch.Generator`` seeded by ``seed``, so the pricers match ``mctpu``'s
(``jax.random`` shifts) in distribution only.  Plain PyTorch in float64
on the device.
"""
from __future__ import annotations

import math as _math

import numpy as np
import torch

from mctpu_torch import math as mcmath
from mctpu_torch.models import basket as mbasket
from mctpu_torch.sobol import replicate_estimate
from mctpu_torch.types import BasketOption, McResult, VanillaOption

__all__ = ["lattice_points", "price_vanilla_qmc", "price_basket_qmc",
           "next_prime", "korobov_vector"]


def next_prime(n: int) -> int:
    """Smallest prime >= n (trial division; n is a host-side launch size)."""
    def is_prime(m: int) -> bool:
        if m < 2:
            return False
        if m % 2 == 0:
            return m == 2
        f = 3
        while f * f <= m:
            if m % f == 0:
                return False
            f += 2
        return True

    while not is_prime(n):
        n += 1
    return n


def korobov_vector(n: int, dim: int, a: int = 1571) -> np.ndarray:
    """Korobov generating vector ``(1, a, a^2, ...) mod n`` (host-side),
    ``a`` bumped past any common factor with ``n``."""
    while _math.gcd(a, n) != 1:
        a += 1
    g = np.empty(dim, dtype=np.int64)
    g[0] = 1
    for j in range(1, dim):
        g[j] = (g[j - 1] * a) % n
    return g


def lattice_points(n: int, dim: int, shift, dtype=torch.float32,
                   device="cuda") -> torch.Tensor:
    """The shifted rank-1 lattice point set, shape ``(n, dim)`` in [0, 1).

    The unshifted lattice ``(i * g mod n) / n`` is exact in host int64 (a
    float product's ulp at ``i * g / n ~ n`` exceeds the 1/n spacing);
    only the shift and the fractional part run in ``dtype``."""
    g = korobov_vector(n, dim)
    i = np.arange(n, dtype=np.int64)[:, None]
    base = ((i * g[None, :]) % n).astype(np.float64) / n
    u = (torch.as_tensor(base, device=device).to(dtype)
         + torch.as_tensor(shift, device=device).to(dtype).reshape(1, dim))
    return u - torch.floor(u)


def _shifts(seed: int, replicates: int, dim: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(int(seed))
    return torch.rand((replicates, dim), generator=gen, dtype=torch.float64)


def _result(vals: torch.Tensor, n: int, replicates: int) -> McResult:
    """McResult from R replicate estimates (price and CI from their
    spread); like ``mctpu``, ``sum_p`` is the price times the points and
    ``sum_p2`` is 0."""
    price, se = replicate_estimate(vals)
    return McResult(price=price, ci=1.96 * se, std_error=se,
                    sum_p=price * n * replicates, sum_p2=torch.zeros_like(price),
                    n=replicates, n_paths=n * replicates)


def _normals(n: int, dim: int, shifts: torch.Tensor, device):
    """``(R, n, dim)`` float64 normals of every shifted lattice."""
    return torch.stack([
        torch.special.ndtri(torch.clamp(
            lattice_points(n, dim, sh, torch.float64, device),
            1e-7, 1.0 - 1e-7))
        for sh in shifts])


def price_vanilla_qmc(opt: VanillaOption, n_points: int, seed: int,
                      replicates: int = 16, device="cuda") -> McResult:
    """RQMC price of a European call: ``n_points`` lattice points per
    replicate (rounded up to a prime) x ``replicates`` random shifts."""
    n = next_prime(n_points)
    s, k, r, v, t = (float(x) for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
    mu = (r - 0.5 * v * v) * t
    sig = v * np.sqrt(t)
    z = _normals(n, 1, _shifts(seed, replicates, 1), device)[..., 0]
    pay = torch.clamp(s * torch.exp(mu + sig * z) - k, min=0.0)
    return _result(np.exp(-r * t) * pay.mean(1), n, replicates)


def price_basket_qmc(opt: BasketOption, n_points: int, seed: int,
                     replicates: int = 16, device="cuda") -> McResult:
    """RQMC price of the basket call (lattice dimension = n_assets)."""
    n = next_prime(n_points)
    a = opt.n_assets
    f64 = dict(dtype=torch.float64, device=device)
    s0, v, w, d = (torch.as_tensor(np.asarray(x, np.float64), **f64)
                   for x in (opt.s, opt.v, opt.w, opt.d))
    k, r, t = (torch.tensor(float(x), **f64) for x in (opt.k, opt.r, opt.t))
    chol = mcmath.cholesky_lower(np.asarray(opt.corr, np.float64)).to(device)
    z = _normals(n, a, _shifts(seed, replicates, a), device)
    pay = mbasket.terminal_payoff(s0, v, w, d, k, r, t, chol, z)
    return _result(np.exp(-float(opt.r) * float(opt.t)) * pay.mean(1), n,
                   replicates)
