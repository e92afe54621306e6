"""K25 and K26: the barrier book, M knock-out calls and puts priced (K25)
or risked (K26) on one shared walk (``csrc/barrier_book.cu``).

Counterpart of :mod:`mctpu.kernels.barrier_book`: the path-dependent
serving entry point.  Every instrument steps its own log-spot ``ls_i +=
drift_i + vol_i z`` on the same standard normals (K12's stream: reseeded
per (block, iteration), both Box-Muller branches per draw, the antithetic
mirror replaying the draws with ``-z``), dies the first date where
``bsgn_i (ls_i - log b_i) >= 0`` (``bsgn = +1`` up-and-out, ``-1``
down-and-out) and pays ``alive_i max(ksgn_i (exp(ls_i) - k_i), 0)``
(``ksgn = +1`` call, ``-1`` put).  The signs are data, so a one-instrument
book computes what K12 computes, step for step, and a tick that flips a
direction reprices through the same library.  K26 carries the shared
``z_1``, ``sum z`` and ``sum z^2`` and forms K13's likelihood-ratio delta,
vega and rho per instrument from its own constants.  The ``(7, M)`` and
``(13, M)`` float32 tables are formed on the CPU row for row as ``mctpu``'s
``book_params`` and ``greek_rows``.
"""
from __future__ import annotations

import numpy as np
import torch

from mctpu_torch.kernels.common import (Plan, check_operand, launch_items,
                                        walk_pairwise, walk_partials)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.types import BarrierBook

__all__ = ["MAX_BARRIER_BOOK", "N_BB_GREEK_SUMS", "make_plan", "book_params",
           "greek_rows", "plain_partials", "partials", "greek_plain_partials",
           "greek_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"barrier_book": 0, "barrier_book_greeks": 0}

MAX_BARRIER_BOOK = 32
N_BB_GREEK_SUMS = 8  # (sum, sum^2) of: payoff, delta, vega, rho


def _rows(book: BarrierBook):
    """``s, k, r, v, t, barrier`` as float32 ``(M,)`` CPU tensors (cast
    first, as ``mctpu``'s ``astype(float32)``), ``dt = t / n_obs`` with
    ``n_obs`` a float32 tensor, and the ``+-1`` direction and payoff
    signs."""
    s, k, r, v, t, b = (torch.tensor(np.asarray(x, np.float64).reshape(-1),
                                     dtype=torch.float32)
                        for x in (book.s, book.k, book.r, book.v, book.t,
                                  book.barrier))
    g = torch.tensor(float(book.n_obs), dtype=torch.float32)
    bsgn = torch.tensor([1.0 if d == "up-and-out" else -1.0
                         for d in book.directions], dtype=torch.float32)
    ksgn = torch.tensor([1.0 if kd == "call" else -1.0 for kd in book.kinds],
                        dtype=torch.float32)
    return s, k, r, v, t, b, g, t / g, bsgn, ksgn


def book_params(book: BarrierBook, device) -> torch.Tensor:
    """K25's ``(7, M)`` float32 table, rows ``log s0, k, log b, drift, vol,
    bsgn, ksgn``."""
    s, k, r, v, _, b, _, dt, bsgn, ksgn = _rows(book)
    return torch.stack([torch.log(s), k, torch.log(b),
                        (r - 0.5 * v * v) * dt, v * torch.sqrt(dt), bsgn,
                        ksgn]).to(device)


def greek_rows(book: BarrierBook, device) -> torch.Tensor:
    """K26's ``(13, M)`` float32 table: K25's seven rows, then ``1/(s0
    vol), 1/v, sqrt(dt), n/v, sqrt(dt)/v, t`` (the divisions tensor by
    tensor, so they round as IEEE float32 divisions)."""
    s, _, _, v, t, _, g, dt, _, _ = _rows(book)
    vol = v * torch.sqrt(dt)
    one = torch.ones_like(s)
    extra = torch.stack([one / (s * vol), one / v, torch.sqrt(dt), g / v,
                         torch.sqrt(dt) / v, t])
    return torch.cat([book_params(book, "cpu"), extra]).to(device)


def _columns(table):
    """Each row of ``table`` as an ``(M, 1, 1)`` column, to broadcast over
    the ``(M, n_blocks, rows * 128)`` walk state."""
    return [row.view(-1, 1, 1) for row in table.unbind()]


def _alive(alive, ls, log_b, bsgn):
    # bsgn (ls - log b) >= 0: ls >= log b up-and-out, ls <= log b down.
    return alive * (~(bsgn * (ls - log_b) >= 0.0)).to(alive.dtype)


def _walk(par, n_obs: int, key, idx, shape, sgn):
    """One pricing walk of every instrument over a ``(n_blocks, rows *
    128)`` tile -> the M payoff tiles."""
    log_s0, k, log_b, drift, vol, bsgn, ksgn = _columns(par[:7])
    m = par.shape[1]

    def step(j, z, carry):
        ls, alive = carry
        ls = ls + drift + vol * (sgn * z)
        return ls, _alive(alive, ls, log_b, bsgn)

    init = (log_s0.expand(m, *shape),
            torch.ones((m, *shape), dtype=torch.float32, device=par.device))
    ls, alive = walk_pairwise(key, idx, n_obs, step, init)
    return alive * torch.clamp(ksgn * (torch.exp(ls) - k), min=0.0)


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int) -> torch.Tensor:
    """Per-block ``(n_blocks, M, 2)`` partials ``[sum p, sum p^2]`` per
    instrument in plain PyTorch on ``par``'s device."""
    m = par.shape[1]
    return walk_partials(
        lambda key, idx, shape, sgn: list(
            _walk(par, n_obs, key, idx, shape, sgn).unbind()),
        seed, block_offset, plan, n_blocks, par.device).reshape(n_blocks, m,
                                                                2)


def _launch(entry: str, table, n_rows: int, n_sums: int, seed: int,
            block_offset: int, plan: Plan, n_blocks: int, n_obs: int):
    m = table.shape[1] if table.ndim == 2 else -1
    if not 1 <= m <= MAX_BARRIER_BOOK:
        raise ValueError(f"a barrier book holds 1..{MAX_BARRIER_BOOK} "
                         "instruments")
    if n_obs < 1:
        raise ValueError("n_obs must be >= 1")
    check_operand("table", table, (n_rows, m), table.device)
    return launch_items(entry, (table.data_ptr(),), m, n_sums, seed,
                        block_offset, plan, n_blocks, table.device,
                        flags=(n_obs,))


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, n_obs: int) -> torch.Tensor:
    """Per-block ``(n_blocks, M, 2)`` partials: K25 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        out = _launch("mctpu_barrier_book", par, 7, 2, seed, block_offset,
                      plan, n_blocks, n_obs)
        LAUNCHES["barrier_book"] += 1
        return out
    if par.device.type == "cpu":
        return plain_partials(par, seed, block_offset, plan, n_blocks, n_obs)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K26: the standardized increments zeta_j are shared, so the walk carries
# z_1, sum zeta and sum zeta^2 once for the book, and instrument i's
# likelihood-ratio scores (K13's) use its own constants at payoff time:
#   delta_i = p_i z_1 c_d,  vega_i = p_i (sum z^2 inv_v - sum z sqdt - n/v),
#   rho_i = p_i (sum z c_r - t)   (mctpu _bb_greek_tiles).
# ---------------------------------------------------------------------------

def _greek_walk(gp, n_obs: int, key, idx, shape, sgn):
    """One Greeks walk -> the four ``(M, n_blocks, rows * 128)`` integrand
    tiles ``p, delta, vega, rho``."""
    log_s0, k, log_b, drift, vol, bsgn, ksgn, c_d, inv_v, sqdt, n_over_v, \
        c_r, t = _columns(gp)
    m = gp.shape[1]

    def step(j, z, carry):
        ls, alive, z1, zs, z2s = carry
        zeta = sgn * z
        ls = ls + drift + vol * zeta
        if j == 0:
            z1 = zeta
        return (ls, _alive(alive, ls, log_b, bsgn), z1, zs + zeta,
                z2s + zeta * zeta)

    zero = torch.zeros(shape, dtype=torch.float32, device=gp.device)
    init = (log_s0.expand(m, *shape),
            torch.ones((m, *shape), dtype=torch.float32, device=gp.device),
            zero, zero, zero)
    ls, alive, z1, zs, z2s = walk_pairwise(key, idx, n_obs, step, init)
    p = alive * torch.clamp(ksgn * (torch.exp(ls) - k), min=0.0)
    return (p, p * z1 * c_d, p * (z2s * inv_v - zs * sqdt - n_over_v),
            p * (zs * c_r - t))


def greek_plain_partials(gp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int,
                         n_obs: int) -> torch.Tensor:
    """Per-block ``(n_blocks, M, 8)`` LR Greek partials in plain PyTorch on
    ``gp``'s device, over K25's stream; per instrument ``[sum p, sum p^2,
    sum delta, ...]``."""
    m = gp.shape[1]

    def walk(key, idx, shape, sgn):
        tiles = _greek_walk(gp, n_obs, key, idx, shape, sgn)
        return [q[i] for i in range(m) for q in tiles]

    return walk_partials(walk, seed, block_offset, plan, n_blocks,
                         gp.device).reshape(n_blocks, m, N_BB_GREEK_SUMS)


def greek_partials(gp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int) -> torch.Tensor:
    """Per-block ``(n_blocks, M, 8)`` LR Greek partials: K26 for a CUDA
    ``gp``, the plain version for a CPU ``gp``; other devices raise."""
    if gp.device.type == "cuda":
        out = _launch("mctpu_barrier_book_greeks", gp, 13, N_BB_GREEK_SUMS,
                      seed, block_offset, plan, n_blocks, n_obs)
        LAUNCHES["barrier_book_greeks"] += 1
        return out
    if gp.device.type == "cpu":
        return greek_plain_partials(gp, seed, block_offset, plan, n_blocks,
                                    n_obs)
    raise ValueError(f"unsupported device {gp.device}")
