"""Float64 terminal oracle of the rainbow (max/min) call.

Counterpart of ``mctpu.reference.price_rainbow``: correlated terminal
spots ``S_i = s0_i exp((r - v_i^2/2) T + v_i sqrt(T) (L z)_i)`` with ``L``
the PSD-tolerant Cholesky factor of ``opt.corr`` and ``z`` drawn from an
explicit ``torch.Generator``, the payoff ``max(ext_i S_i - k, 0)``.  It
holds the rainbow kernels to account at basket sizes with no closed form.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mctpu_torch import math as mcmath
from mctpu_torch.models.basket import _estimate

__all__ = ["rainbow_oracle"]

CHUNK = 1 << 16  # paths drawn at a time: (CHUNK, a) float64 normals


def rainbow_oracle(opt, n_paths: int, seed: int, device="cpu"):
    """``(price, std_error)`` of ``opt`` (a :class:`RainbowOption`) by
    ``n_paths`` float64 terminal draws from a generator seeded ``seed``
    on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    s0, v = (torch.as_tensor(np.asarray(x, np.float64), **f64)
             for x in (opt.s, opt.v))
    chol = mcmath.cholesky_lower(np.asarray(opt.corr, np.float64)).to(device)
    t = float(opt.t)
    drift = (float(opt.r) - 0.5 * v * v) * t
    vol = v * math.sqrt(t)
    gen = torch.Generator(device=device).manual_seed(seed)
    pays = []
    for start in range(0, n_paths, CHUNK):
        z = torch.randn((min(CHUNK, n_paths - start), opt.n_assets),
                        generator=gen, **f64)
        st = s0 * torch.exp(drift + vol * (z @ chol.T))
        ext = st.amin(1) if opt.kind == "min" else st.amax(1)
        pays.append(torch.clamp(ext - float(opt.k), min=0.0))
    return _estimate(torch.cat(pays), float(opt.r), t)
