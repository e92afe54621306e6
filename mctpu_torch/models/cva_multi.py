"""Float64 oracles of the netting-set CVA and bilateral xVA over correlated
underlyings.

Counterparts of ``mctpu.reference.price_cva_multi`` and
``price_xva_multi``: correlated GBM spots stepped over the exposure grid,
``S <- S exp((r - v^2/2) dt + v sqrt(dt) (L z))`` with ``L`` the
PSD-tolerant Cholesky factor of ``spec.corr`` and ``z`` drawn from an
explicit ``torch.Generator``; at node ``j`` each leg is priced by the
Hastings-CDF Black-Scholes formula over the remaining maturity (its
intrinsic value at the last node), the legs net, and the positive part
feeds the default leg ``lgd sum_j dp_j ee_j`` and the expected-exposure
profile; the xVA oracle adds the negative part's DVA and both funding
legs.  They hold the netting-set kernels to account where no closed form
exists (mixed-sign sets) and where ``mctpu`` has no stream to match (xVA
beyond 8 underlyings).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mctpu_torch import math as mcmath
from mctpu_torch.types import XvaSpec

__all__ = ["cva_multi_oracle", "xva_oracle"]

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


def xva_oracle(xspec, n_paths: int, seed: int, device="cpu") -> dict:
    """The bilateral xVA legs of ``xspec`` (an :class:`XvaSpec`) by
    ``n_paths`` float64 walks from a generator seeded ``seed`` on
    ``device`` (``mctpu.reference.price_xva_multi``): ``{"cva" | "dva" |
    "fca" | "fba": (mean, std_error), "epe" | "ene": (n_grid,) profile,
    "epe_sd" | "ene_sd": the exposure's sample standard deviation per
    node}``.  One path sweep feeds every leg: ``lgd sum_j w_cva_j EPE_j``,
    ``own_lgd sum_j w_dva_j ENE_j`` and ``sum_j w_fnd_j EPE_j`` (``ENE_j``)
    over the first-to-default tables of :mod:`mctpu_torch.math`."""
    spec = xspec.netting
    f64 = dict(dtype=torch.float64, device=device)
    s0, v, k, w = (torch.as_tensor(np.asarray(x, np.float64), **f64)
                   for x in (spec.s, spec.v, spec.strikes, spec.weights))
    chol = mcmath.cholesky_lower(np.asarray(spec.corr, np.float64)).to(device)
    r, t, g = float(spec.r), float(spec.t), int(spec.n_grid)
    m = spec.n_underlyings
    dt = t / g
    drift = (r - 0.5 * v * v) * dt
    vol = v * math.sqrt(dt)
    w_cva, w_dva = (x.tolist() for x in mcmath.xva_leg_weights(
        spec.intensity, xspec.own_intensity, t, g))
    w_fnd = mcmath.funding_leg_weights(spec.intensity, xspec.own_intensity,
                                       xspec.funding_spread, t, g).tolist()
    gen = torch.Generator(device=device).manual_seed(seed)
    legs = {name: [] for name in ("cva", "dva", "fca", "fba")}
    sums = torch.zeros((4, g), **f64)  # epe, epe^2, ene, ene^2 per node
    for start in range(0, n_paths, CHUNK):
        n = min(CHUNK, n_paths - start)
        s = s0.expand(n, m)
        ac, ad, af, ab = (torch.zeros(n, **f64) for _ in range(4))
        for j in range(1, g + 1):
            z = torch.randn((n, m), generator=gen, **f64)
            s = s * torch.exp(drift + vol * (z @ chol.T))
            tau = t * (g - j) / g
            value = (w * _bs_hastings(s, k, r, v, tau)).sum(1)
            epe = torch.clamp(value, min=0.0)
            ene = torch.clamp(-value, min=0.0)
            ac = ac + w_cva[j - 1] * epe
            ad = ad + w_dva[j - 1] * ene
            af = af + w_fnd[j - 1] * epe
            ab = ab + w_fnd[j - 1] * ene
            for row, x in enumerate((epe, epe * epe, ene, ene * ene)):
                sums[row, j - 1] += x.sum()
        for name, x in zip(legs, (float(spec.lgd) * ac,
                                  float(xspec.own_lgd) * ad, af, ab)):
            legs[name].append(x)
    out = {}
    for name, parts in legs.items():
        x = torch.cat(parts)
        out[name] = (float(x.mean()), float(x.std()) / math.sqrt(n_paths))
    for row, name in ((0, "epe"), (2, "ene")):
        mean = sums[row] / n_paths
        var = torch.clamp(sums[row + 1] / n_paths - mean * mean, min=0.0)
        out[name] = mean.cpu()
        out[name + "_sd"] = torch.sqrt(var * n_paths / (n_paths - 1)).cpu()
    return out


def cva_multi_oracle(spec, n_paths: int, seed: int, device="cpu"):
    """``(cva, std_error, ee, ee_sd)`` of ``spec`` (a :class:`CvaMultiSpec`)
    by ``n_paths`` float64 walks from a generator seeded ``seed`` on
    ``device``: the undiscounted mean of the per-path default legs, its
    standard error, the ``(n_grid,)`` expected-exposure profile and the
    exposure's sample standard deviation per node (:func:`xva_oracle`'s
    CVA leg with no own default and no funding: its table is
    ``default_leg_weights``)."""
    out = xva_oracle(XvaSpec(spec, 0.0, 0.6, 0.0), n_paths, seed, device)
    cva, se = out["cva"]
    return cva, se, out["epe"], out["epe_sd"]
