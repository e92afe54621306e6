"""Float64 oracle of the netting-set CVA over correlated underlyings.

Counterpart of ``mctpu.reference.price_cva_multi``: correlated GBM spots
stepped over the exposure grid, ``S <- S exp((r - v^2/2) dt + v sqrt(dt)
(L z))`` with ``L`` the PSD-tolerant Cholesky factor of ``spec.corr`` and
``z`` drawn from an explicit ``torch.Generator``; at node ``j`` each leg is
priced by the Hastings-CDF Black-Scholes formula over the remaining
maturity (its intrinsic value at the last node), the legs net, and the
positive part feeds the default leg ``lgd sum_j dp_j ee_j`` and the
expected-exposure profile.  It holds the netting-set kernels to account
where no closed form exists (mixed-sign sets).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mctpu_torch import math as mcmath

__all__ = ["cva_multi_oracle"]

CHUNK = 1 << 16  # paths walked at a time: (CHUNK, m) float64 spots


def _bs_hastings(s, k, r: float, v, tau: float) -> torch.Tensor:
    """Black-Scholes call with the Hastings CDF in float64; the intrinsic
    value at zero remaining maturity."""
    if tau <= 0.0:
        return torch.clamp(s - k, min=0.0)
    sq = v * math.sqrt(tau)
    d1 = (torch.log(s / k) + (r + 0.5 * v * v) * tau) / sq
    d2 = d1 - sq
    cdf = mcmath.norm_cdf_hastings
    return s * cdf(d1) - k * math.exp(-r * tau) * cdf(d2)


def cva_multi_oracle(spec, n_paths: int, seed: int, device="cpu"):
    """``(cva, std_error, ee, ee_sd)`` of ``spec`` (a :class:`CvaMultiSpec`)
    by ``n_paths`` float64 walks from a generator seeded ``seed`` on
    ``device``: the undiscounted mean of the per-path default legs, its
    standard error, the ``(n_grid,)`` expected-exposure profile and the
    exposure's sample standard deviation per node."""
    f64 = dict(dtype=torch.float64, device=device)
    s0, v, k, w = (torch.as_tensor(np.asarray(x, np.float64), **f64)
                   for x in (spec.s, spec.v, spec.strikes, spec.weights))
    chol = mcmath.cholesky_lower(np.asarray(spec.corr, np.float64)).to(device)
    r, t, g = float(spec.r), float(spec.t), int(spec.n_grid)
    m = spec.n_underlyings
    dt = t / g
    drift = (r - 0.5 * v * v) * dt
    vol = v * math.sqrt(dt)
    dp = mcmath.default_leg_weights(spec.intensity, t, g).tolist()
    gen = torch.Generator(device=device).manual_seed(seed)
    legs = []
    ee_sum = torch.zeros(g, **f64)
    ee_sum2 = torch.zeros(g, **f64)
    for start in range(0, n_paths, CHUNK):
        n = min(CHUNK, n_paths - start)
        s = s0.expand(n, m)
        acc = torch.zeros(n, **f64)
        for j in range(1, g + 1):
            z = torch.randn((n, m), generator=gen, **f64)
            s = s * torch.exp(drift + vol * (z @ chol.T))
            tau = t * (g - j) / g
            value = (w * _bs_hastings(s, k, r, v, tau)).sum(1)
            ee = torch.clamp(value, min=0.0)
            acc = acc + dp[j - 1] * ee
            ee_sum[j - 1] += ee.sum()
            ee_sum2[j - 1] += (ee * ee).sum()
        legs.append(float(spec.lgd) * acc)
    legs = torch.cat(legs)
    ee = ee_sum / n_paths
    var = torch.clamp(ee_sum2 / n_paths - ee * ee, min=0.0)
    return (float(legs.mean()), float(legs.std()) / math.sqrt(n_paths),
            ee.cpu(), torch.sqrt(var * n_paths / (n_paths - 1)).cpu())
