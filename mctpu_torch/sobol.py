"""Sobol low-discrepancy nets (counterpart of :mod:`mctpu.sobol`).

``x_i = XOR_{b set in gray(i)} v_b`` over the 30-bit Joe-Kuo direction
numbers (``data/sobol_directions_2048x30.npy``, the JAX package's table
byte for byte), randomized by a per-replicate digital shift (XOR with
uniform bits).  The integers are exact; a point is ``x * 2^-30``.

The ``price_*_sobol`` pricers are plain PyTorch on the device, as the JAX
package's are plain XLA: they materialize each replicate's ``(n, dim)``
net.  Their shifts come from a CPU ``torch.Generator`` seeded by ``seed``,
so they match ``mctpu``'s (Threefry-drawn shifts) in distribution only.
The engine tier, with the fused kernels, is :mod:`mctpu_torch.qmc_engine`.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from mctpu_torch import math as mcmath
from mctpu_torch.models import basket as mbasket
from mctpu_torch.types import BasketOption, McResult, VanillaOption

__all__ = ["sobol_points", "sobol_bits", "price_vanilla_sobol",
           "price_basket_sobol", "price_asian_sobol", "bridge_paths",
           "brownian_bridge_plan", "replicate_estimate", "MAX_DIM"]

_DATA = Path(__file__).resolve().parent / "data" / "sobol_directions_2048x30.npy"
_BITS = 30
MAX_DIM = 2048


@functools.lru_cache(maxsize=1)
def _directions() -> np.ndarray:
    return np.load(_DATA)  # (MAX_DIM, 30) uint32


def sobol_bits(idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unshifted 30-bit Sobol integers of the point indices ``idx`` (int64
    tensor of u32 values, any shape) in the dims of ``v`` (``(dim, 30)``
    int64 direction numbers): shape ``idx.shape + (dim,)``."""
    gray = (idx ^ (idx >> 1)).unsqueeze(-1)
    acc = torch.zeros(idx.shape + (v.shape[0],), dtype=torch.int64,
                      device=idx.device)
    for b in range(_BITS):
        acc = acc ^ torch.where(((gray >> b) & 1) > 0, v[:, b], 0)
    return acc


def sobol_points(n: int, dim: int, shift_bits=None, dtype=torch.float32,
                 device="cuda") -> torch.Tensor:
    """First ``n`` Sobol points in ``dim`` dimensions, shape ``(n, dim)``.

    ``shift_bits`` (optional, ``(dim,)`` u32 values) applies a digital
    shift (its top 30 bits).  Matches ``torch.quasirandom.SobolEngine``
    exactly when unshifted."""
    if dim > MAX_DIM:
        raise ValueError(f"sobol supports up to {MAX_DIM} dims, got {dim}")
    v = torch.as_tensor(_directions()[:dim].astype(np.int64), device=device)
    acc = sobol_bits(torch.arange(n, dtype=torch.int64, device=device), v)
    if shift_bits is not None:
        sh = torch.as_tensor(np.asarray(shift_bits, np.int64), device=device)
        acc = acc ^ (sh.reshape(1, dim) >> (32 - _BITS))
    return acc.to(dtype) * (1.0 / (1 << _BITS))


def _shift_words(seed: int, replicates: int, dim: int) -> torch.Tensor:
    """``(replicates, dim)`` uniform u32 shift words (int64) from a CPU
    generator seeded by ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 1 << 32, (replicates, dim), generator=gen,
                         dtype=torch.int64)


def _clip_ndtri(u: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtri(torch.clamp(u, 1e-7, 1.0 - 1e-7))


def replicate_estimate(vals: torch.Tensor):
    """``(mean, standard error)`` of R replicate estimates, on the CPU."""
    vals = vals.cpu()
    return vals.mean(), vals.std(correction=1) / np.sqrt(vals.shape[0])


def _replicate_result(sums_p, sums_p2, n: int, replicates: int,
                      discount) -> McResult:
    """McResult from per-replicate undiscounted (sum, sum2): price and CI
    from the replicate spread, ``n`` the replicates (the i.i.d. unit),
    ``n_paths`` the total point count."""
    mean, se = replicate_estimate(discount * sums_p / n)
    return McResult(price=mean, ci=1.96 * se, std_error=se,
                    sum_p=sums_p.sum().cpu(), sum_p2=sums_p2.sum().cpu(),
                    n=replicates, n_paths=n * replicates)


def _net(n: int, dim: int, shifts: torch.Tensor, device):
    """Normals of every replicate's shifted net: ``(R, n, dim)`` float64."""
    return torch.stack([_clip_ndtri(sobol_points(n, dim, sh, torch.float64,
                                                 device))
                        for sh in shifts.numpy()])


def price_vanilla_sobol(opt: VanillaOption, n_points: int, seed: int,
                        replicates: int = 16,
                        device="cuda") -> McResult:
    """Sobol-RQMC European call price (digital-shift replicates for the
    CI), in float64 on ``device``."""
    s, k, r, v, t = (float(x) for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
    mu = (r - 0.5 * v * v) * t
    sig = v * np.sqrt(t)
    z = _net(n_points, 1, _shift_words(seed, replicates, 1), device)[..., 0]
    pay = torch.clamp(s * torch.exp(mu + sig * z) - k, min=0.0)
    return _replicate_result(pay.sum(1), (pay * pay).sum(1), n_points,
                             replicates, np.exp(-r * t))


def price_basket_sobol(opt: BasketOption, n_points: int, seed: int,
                       replicates: int = 16, device="cuda") -> McResult:
    """Sobol-RQMC basket call price (net dimension = n_assets, <= 2048),
    in float64 on ``device``."""
    a = opt.n_assets
    f64 = dict(dtype=torch.float64, device=device)
    s0, v, w, d = (torch.as_tensor(np.asarray(x, np.float64), **f64)
                   for x in (opt.s, opt.v, opt.w, opt.d))
    k, r, t = (torch.tensor(float(x), **f64) for x in (opt.k, opt.r, opt.t))
    chol = mcmath.cholesky_lower(np.asarray(opt.corr, np.float64)).to(device)
    z = _net(n_points, a, _shift_words(seed, replicates, a), device)
    pay = mbasket.terminal_payoff(s0, v, w, d, k, r, t, chol, z)
    return _replicate_result(pay.sum(1), (pay * pay).sum(1), n_points,
                             replicates, np.exp(-float(opt.r) * float(opt.t)))


# ---------------------------------------------------------------------------
# Brownian-bridge path construction (QMC for path-dependent payoffs)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def brownian_bridge_plan(m: int):
    """Bisection order and coefficients for a Brownian bridge over m uniform
    steps (Glasserman §3.1): draw k fills time index ``out[k]`` as

        W_out = ca * W_left + cb * W_right + sd * z_k

    with ``left = -1`` meaning the t=0 anchor (W=0).  Draw 0 is the terminal
    point.  Times are in units of the step (t_j = j+1 for index j); ``sd``
    is in sqrt(step) units."""
    left = np.zeros(m, np.int32)
    right = np.zeros(m, np.int32)
    out = np.zeros(m, np.int32)
    ca = np.zeros(m)
    cb = np.zeros(m)
    sd = np.zeros(m)
    out[0] = m - 1
    left[0] = -1
    right[0] = -1
    sd[0] = np.sqrt(m)
    queue = [(-1, m - 1)]
    k = 1
    while queue:
        a, b = queue.pop(0)
        if b - a < 2:
            continue
        c = (a + b + 1) // 2
        ta, tc, tb = a + 1.0, c + 1.0, b + 1.0
        out[k] = c
        left[k] = a
        right[k] = b
        ca[k] = (tb - tc) / (tb - ta)
        cb[k] = (tc - ta) / (tb - ta)
        sd[k] = np.sqrt((tc - ta) * (tb - tc) / (tb - ta))
        k += 1
        queue.append((a, c))
        queue.append((c, b))
    assert k == m, (k, m)
    return left, right, out, ca, cb, sd


def bridge_paths(z: torch.Tensor, t_total) -> torch.Tensor:
    """Brownian motion W at m uniform times from normals ``z (..., m)``:
    ``w (m, ...)`` with ``t_j = (j+1) t_total / m``, in ``z``'s dtype;
    ``z[..., 0]`` (the best Sobol dim) drives the terminal point."""
    m = z.shape[-1]
    left, right, out, ca, cb, sd = brownian_bridge_plan(m)
    step_scale = torch.sqrt(torch.tensor(float(t_total), dtype=z.dtype) / m)

    def c(x):
        return torch.tensor(float(x), dtype=z.dtype)

    w = [None] * m
    w[int(out[0])] = c(sd[0]) * step_scale * z[..., 0]
    for q in range(1, m):
        wa = 0.0 if left[q] < 0 else w[int(left[q])]
        w[int(out[q])] = (c(ca[q]) * wa + c(cb[q]) * w[int(right[q])]
                          + c(sd[q]) * step_scale * z[..., q])
    return torch.stack(w)


def price_asian_sobol(opt, n_points: int, seed: int, replicates: int = 16,
                      device="cuda") -> McResult:
    """Sobol-RQMC Asian call via Brownian-bridge path construction (net
    dimension = ``n_obs``, up to 2048), in float64 on ``device``."""
    opt.validate()
    m = opt.n_obs
    if m > MAX_DIM:
        raise ValueError(f"sobol asian supports n_obs <= {MAX_DIM}")
    s, k, r, v, t = (float(x) for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
    t_j = t * torch.arange(1, m + 1, dtype=torch.float64, device=device) / m
    z = _net(n_points, m, _shift_words(seed, replicates, m), device)
    w = bridge_paths(z, t).to(device)  # (m, R, n)
    log_s = np.log(s) + (r - 0.5 * v * v) * t_j[:, None, None] + v * w
    if opt.average == "geometric":
        avg = torch.exp(log_s.mean(0))
    else:
        avg = torch.exp(log_s).mean(0)
    pay = torch.clamp(avg - k, min=0.0)
    return _replicate_result(pay.sum(1), (pay * pay).sum(1), n_points,
                             replicates, np.exp(-r * t))
