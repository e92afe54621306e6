"""K21 and K22: the strike ladder, K vanilla payoffs and their Greek
integrands from one terminal draw per path (``csrc/ladder.cu``).

Counterpart of :mod:`mctpu.kernels.ladder`.  Every strike reuses K1's draws
(the same plan and stream), so a ladder's estimates are comonotone across
strikes: the call prices fall and are convex in the strike, and the call
delta ladder falls, path by path.  The strikes are a runtime float32
operand here (the JAX package compiles them into the kernel); that changes
no number.  :func:`partials` and :func:`greek_partials` launch the CUDA
kernel for CUDA operands and run the plain version, the same function in
plain PyTorch over the same stream, for CPU operands.
"""
from __future__ import annotations

import numpy as np
import torch

from mctpu_torch.kernels.common import (Plan, check_operand, f32,
                                        launch_items, terminal_partials)
from mctpu_torch.kernels.vanilla import make_plan  # K21/K22 run K1's plan
from mctpu_torch.types import VanillaOption

__all__ = ["MAX_STRIKES", "N_LADDER_GREEK_SUMS", "make_plan", "params",
           "strike_vector", "plain_partials", "partials", "greek_params",
           "greek_plain_partials", "greek_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"ladder": 0, "ladder_greeks": 0}

MAX_STRIKES = 64
N_LADDER_GREEK_SUMS = 12  # (sum, sum^2) of: p, delta, vega, rho, theta,
#                           gamma, per strike


def params(opt: VanillaOption, device) -> torch.Tensor:
    """``[s0, mu, sig]`` in float32, formed on the CPU in the JAX kernel's
    order (``mu = (r - 0.5 v v) t``, ``sig = v sqrt(t)``); ``opt.k`` is not
    read."""
    s, r, v, t = f32(opt.s, opt.r, opt.v, opt.t)
    mu = (r - 0.5 * v * v) * t
    sig = v * torch.sqrt(t)
    return torch.stack([s, mu, sig]).to(device)


def strike_vector(strikes, device) -> torch.Tensor:
    """The ``(K,)`` float32 strikes operand."""
    ks = torch.tensor(np.asarray(strikes, np.float64).reshape(-1),
                      dtype=torch.float32)
    return ks.to(device)


def _pays(tiles, k_m, put: bool):
    """The strike-``k_m`` payoff of the iteration's spot tiles, pair-meaned
    under antithetic (``mctpu``'s ``_ladder_sums``)."""
    pays = [torch.clamp((k_m - st) if put else (st - k_m), min=0.0)
            for st in tiles]
    if len(pays) > 1:
        return (pays[0] + pays[1]) * 0.5  # (p(z) + p(-z)) / 2, exactly
    return pays[0]


def plain_partials(par: torch.Tensor, ks: torch.Tensor, seed: int,
                   block_offset: int, plan: Plan, n_blocks: int,
                   put: bool) -> torch.Tensor:
    """Per-block ``(n_blocks, K, 2)`` partials ``[sum_p, sum_p2]`` per
    strike in plain PyTorch on ``par``'s device, over K1's stream."""
    s0, mu, sig = par.unbind()
    n_k = ks.shape[0]

    def draw_sums(z):
        tiles = [s0 * torch.exp(mu + sig * z)]
        if plan.antithetic:
            tiles.append(s0 * torch.exp(mu - sig * z))
        sums = []
        for m in range(n_k):
            p = _pays(tiles, ks[m], put)
            sums += [p.sum(1), (p * p).sum(1)]
        return sums

    return terminal_partials(draw_sums, 2 * n_k, seed, block_offset, plan,
                             n_blocks, par.device).reshape(n_blocks, n_k, 2)


def _launch(entry: str, par, n_par: int, ks, n_sums: int, seed: int,
            block_offset: int, plan: Plan, n_blocks: int, put: bool):
    check_operand("par", par, (n_par,), par.device)
    n_k = ks.shape[0] if ks.ndim == 1 else -1
    if not 1 <= n_k <= MAX_STRIKES:
        raise ValueError(f"strikes must have 1..{MAX_STRIKES} entries")
    check_operand("strikes", ks, (n_k,), par.device)
    return launch_items(entry, (par.data_ptr(), ks.data_ptr()), n_k,
                        n_sums, seed, block_offset, plan, n_blocks,
                        par.device, flags=(put,))


def partials(par: torch.Tensor, ks: torch.Tensor, seed: int,
             block_offset: int, plan: Plan, n_blocks: int,
             put: bool) -> torch.Tensor:
    """Per-block ``(n_blocks, K, 2)`` partials: K21 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        out = _launch("mctpu_ladder", par, 3, ks, 2, seed, block_offset,
                      plan, n_blocks, put)
        LAUNCHES["ladder"] += 1
        return out
    if par.device.type == "cpu":
        return plain_partials(par, ks, seed, block_offset, plan, n_blocks,
                              put)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K22: per strike the six integrands of K6's price, delta, vega, rho, theta
# and gamma, over the shared tiles st, wv = sqt z - v t and q = (r - v^2/2)
# + (0.5 v / sqt) z.  The gamma scale is formed as cg_over_k * k_m with
# cg_over_k = 1 / (s0 s0 v sqt), as the JAX kernel does (the book divides
# k by the product instead, which rounds differently).
# ---------------------------------------------------------------------------

def greek_params(opt: VanillaOption, device) -> torch.Tensor:
    """``[s0, mu, sig, v, t, sqt, r, 1/s0, 1/(s0 s0 v sqt)]`` in float32,
    formed on the CPU in the JAX kernel's order (the divisions tensor by
    tensor, so they round as IEEE float32 divisions)."""
    s, r, v, t = f32(opt.s, opt.r, opt.v, opt.t)
    one = torch.tensor(1.0, dtype=torch.float32)
    sqt = torch.sqrt(t)
    return torch.stack([s, (r - 0.5 * v * v) * t, v * sqt, v, t, sqt, r,
                        one / s, one / (s * s * v * sqt)]).to(device)


def _greek_quants(st, zz, wv, q, k_m, inv_s0, cg_m, tk_m, r, put: bool):
    """The six integrand tiles of strike ``k_m`` (``mctpu``'s
    ``_greek_ladder_quants``)."""
    if put:
        ind = torch.where(st < k_m, -1.0, 0.0).to(st.dtype)
        p = torch.clamp(k_m - st, min=0.0)
    else:
        ind = torch.where(st > k_m, 1.0, 0.0).to(st.dtype)
        p = torch.clamp(st - k_m, min=0.0)
    w = ind * st
    return (p, w * inv_s0, w * wv, tk_m * ind, w * q - r * p,
            cg_m * (ind * zz))


def greek_plain_partials(gp: torch.Tensor, ks: torch.Tensor, seed: int,
                         block_offset: int, plan: Plan, n_blocks: int,
                         put: bool) -> torch.Tensor:
    """Per-block ``(n_blocks, K, 12)`` Greek partials in plain PyTorch on
    ``gp``'s device, over K1's stream."""
    s0, mu, sig, v, t, sqt, r, inv_s0, cg_over_k = gp.unbind()
    a = r - 0.5 * v * v
    b = (0.5 * v) / sqt
    vt = v * t
    n_k = ks.shape[0]

    def draw_sums(z):
        sides = [z, -z] if plan.antithetic else [z]
        shared = [(s0 * torch.exp(mu + sig * zz), sqt * zz - vt, a + b * zz,
                   zz) for zz in sides]
        sums = []
        for m in range(n_k):
            k_m = ks[m]
            cg_m, tk_m = cg_over_k * k_m, t * k_m
            quants = None
            for st, wv, q, zz in shared:
                one = _greek_quants(st, zz, wv, q, k_m, inv_s0, cg_m, tk_m,
                                    r, put)
                quants = one if quants is None else tuple(
                    x + y for x, y in zip(quants, one))
            if plan.antithetic:
                quants = tuple(0.5 * x for x in quants)
            for x in quants:
                sums += [x.sum(1), (x * x).sum(1)]
        return sums

    return terminal_partials(
        draw_sums, N_LADDER_GREEK_SUMS * n_k, seed, block_offset, plan,
        n_blocks, gp.device).reshape(n_blocks, n_k, N_LADDER_GREEK_SUMS)


def greek_partials(gp: torch.Tensor, ks: torch.Tensor, seed: int,
                   block_offset: int, plan: Plan, n_blocks: int,
                   put: bool) -> torch.Tensor:
    """Per-block ``(n_blocks, K, 12)`` Greek partials: K22 for a CUDA
    ``gp``, the plain version for a CPU ``gp``; other devices raise."""
    if gp.device.type == "cuda":
        out = _launch("mctpu_ladder_greeks", gp, 9, ks, N_LADDER_GREEK_SUMS,
                      seed, block_offset, plan, n_blocks, put)
        LAUNCHES["ladder_greeks"] += 1
        return out
    if gp.device.type == "cpu":
        return greek_plain_partials(gp, ks, seed, block_offset, plan,
                                    n_blocks, put)
    raise ValueError(f"unsupported device {gp.device}")
