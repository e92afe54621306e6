"""Discretely monitored Asian (average-price) call: model math.

Counterpart of :mod:`mctpu.models.asian`.  The walk kernels (K9, K10 in
``kernels/asian.py``; K12, K13 in ``kernels/barrier.py``) step a log-spot
over ``n_obs`` equal dates with the constants of :func:`step_constants`
(as do the lookback's K15 and K16, and the cliquet's K17 and K18 over its
``n_periods``).
"""
from __future__ import annotations

import torch

from mctpu_torch import math as mcmath
from mctpu_torch.types import AsianOption

__all__ = ["path_payoff", "closed_form_geometric", "step_constants"]


def _scalars(opt, dtype):
    return (torch.tensor(float(x), dtype=dtype)
            for x in (opt.s, opt.k, opt.r, opt.v, opt.t))


def step_constants(opt, n_steps: int | None = None, dtype=torch.float32):
    """``(drift, vol)`` of one step ``dt = T / n_steps`` in ``dtype``, in
    ``mctpu``'s expression order ``dt = t / n; (r - 0.5 v v) dt; v
    sqrt(dt)`` (``opt`` is any record with ``r``, ``v`` and ``t``;
    ``n_steps`` defaults to its ``n_obs``)."""
    r, v, t = (torch.tensor(float(x), dtype=dtype)
               for x in (opt.r, opt.v, opt.t))
    dt = t / (opt.n_obs if n_steps is None else n_steps)
    drift = (r - 0.5 * v * v) * dt
    vol = v * torch.sqrt(dt)
    return drift, vol


def path_payoff(opt: AsianOption, z_seq: torch.Tensor) -> torch.Tensor:
    """Payoff from pre-drawn normals ``z_seq`` of shape ``(n_obs, ...)``,
    in ``z_seq``'s dtype: ``max(mean_i S_{t_i} - K, 0)``, the mean taken
    of the log-spots and exponentiated for the geometric average."""
    dtype = z_seq.dtype
    s0, k, _, _, _ = _scalars(opt, dtype)
    drift, vol = step_constants(opt, dtype=dtype)
    s = s0.expand(z_seq.shape[1:])
    acc = torch.zeros(z_seq.shape[1:], dtype=dtype)
    for j in range(opt.n_obs):
        s = s * torch.exp(drift + vol * z_seq[j])
        acc = acc + (torch.log(s) if opt.average == "geometric" else s)
    avg = acc / opt.n_obs
    if opt.average == "geometric":
        avg = torch.exp(avg)
    return torch.clamp(avg - k, min=0.0)


def closed_form_geometric(opt: AsianOption) -> torch.Tensor:
    """Exact discrete-geometric price (float64 oracle; it prices the
    geometric payoff whatever ``opt.average`` says)."""
    return mcmath.geometric_asian_call(opt.s, opt.k, opt.r, opt.v, opt.t,
                                       opt.n_obs)
