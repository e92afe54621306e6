"""K23 and K24: the vanilla book, M heterogeneous calls and puts priced and
risked from one terminal draw per path (``csrc/book.cu``).

Counterpart of :mod:`mctpu.kernels.book`: the serving pattern, where a desk
reprices a whole book on every market tick.  Every instrument reuses K1's
draws (the same plan and stream) and maps the shared ``z`` to its own
terminal spot ``s0_i exp(mu_i + sig_i z)``; the call/put mix rides in as a
``+-1`` sign.  Every per-instrument value is a runtime operand, so a tick
reprices through the same compiled library.  ``sgn (st - k)`` with ``sgn =
+-1`` is exact, so a one-instrument book equals K1 on the same stream.
:func:`partials` and :func:`greek_partials` launch the CUDA kernel for
CUDA operands and run the plain version for CPU operands.
"""
from __future__ import annotations

import numpy as np
import torch

from mctpu_torch.kernels.common import (Plan, check_operand, launch_items,
                                        terminal_partials)
from mctpu_torch.kernels.vanilla import make_plan  # K23/K24 run K1's plan
from mctpu_torch.types import VanillaBook

__all__ = ["MAX_BOOK", "N_BOOK_GREEK_SUMS", "make_plan", "params",
           "greek_const_rows", "plain_partials", "partials",
           "greek_plain_partials", "greek_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"book": 0, "book_greeks": 0}

MAX_BOOK = 64
N_BOOK_GREEK_SUMS = 12  # (sum, sum^2) of: p, delta, vega, rho, theta,
#                         gamma, per instrument


def _vectors(book: VanillaBook):
    """``s, k, r, v, t`` and the ``+-1`` signs as float32 ``(M,)`` CPU
    tensors (cast first, as ``mctpu``'s ``astype(float32)``)."""
    s, k, r, v, t = (torch.tensor(np.asarray(x, np.float64).reshape(-1),
                                  dtype=torch.float32)
                     for x in (book.s, book.k, book.r, book.v, book.t))
    sgn = torch.tensor([1.0 if kd == "call" else -1.0 for kd in book.kinds],
                       dtype=torch.float32)
    return s, k, r, v, t, sgn


def params(book: VanillaBook, device) -> torch.Tensor:
    """K23's ``(5, M)`` float32 table, rows ``s0, mu, sig, k, sgn``, formed
    on the CPU as ``mctpu.engine.price_book`` forms them (``mu = (r - 0.5 v
    v) t`` and ``sig = v sqrt(t)`` in float32)."""
    s, k, r, v, t, sgn = _vectors(book)
    mu = (r - 0.5 * v * v) * t
    sig = v * torch.sqrt(t)
    return torch.stack([s, mu, sig, k, sgn]).to(device)


def greek_const_rows(book: VanillaBook, device) -> torch.Tensor:
    """K24's ``(13, M)`` float32 table, row for row ``mctpu``'s
    ``greek_const_rows``: ``s0, mu, sig, sqt, v t, r - v^2/2, 0.5 v / sqt,
    r, 1/s0, k/(s0 s0 v sqt), t k, k, sgn`` (the divisions tensor by
    tensor, so they round as IEEE float32 divisions)."""
    s0, k, r, v, t, sgn = _vectors(book)
    sqt = torch.sqrt(t)
    return torch.stack([
        s0, (r - 0.5 * v * v) * t, v * sqt, sqt, v * t,
        r - 0.5 * v * v, (0.5 * v) / sqt, r, torch.ones_like(s0) / s0,
        k / (s0 * s0 * v * sqt), t * k, k, sgn]).to(device)


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int) -> torch.Tensor:
    """Per-block ``(n_blocks, M, 2)`` partials ``[sum_p, sum_p2]`` per
    instrument in plain PyTorch on ``par``'s device, over K1's stream
    (``mctpu``'s ``_inst_sums``)."""
    m = par.shape[1]

    def draw_sums(z):
        sides = [z, -z] if plan.antithetic else [z]
        sums = []
        for j in range(m):
            s0, mu, sig, k, sgn = par[:, j].unbind()
            pays = [torch.clamp(sgn * (s0 * torch.exp(mu + sig * zz) - k),
                                min=0.0) for zz in sides]
            p = 0.5 * (pays[0] + pays[1]) if plan.antithetic else pays[0]
            sums += [p.sum(1), (p * p).sum(1)]
        return sums

    return terminal_partials(draw_sums, 2 * m, seed, block_offset, plan,
                             n_blocks, par.device).reshape(n_blocks, m, 2)


def _launch(entry: str, table, n_rows: int, n_sums: int, seed: int,
            block_offset: int, plan: Plan, n_blocks: int):
    m = table.shape[1] if table.ndim == 2 else -1
    if not 1 <= m <= MAX_BOOK:
        raise ValueError(f"a book holds 1..{MAX_BOOK} instruments")
    check_operand("table", table, (n_rows, m), table.device)
    return launch_items(entry, (table.data_ptr(),), m, n_sums, seed,
                        block_offset, plan, n_blocks, table.device)


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int) -> torch.Tensor:
    """Per-block ``(n_blocks, M, 2)`` partials: K23 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        out = _launch("mctpu_book", par, 5, 2, seed, block_offset, plan,
                      n_blocks)
        LAUNCHES["book"] += 1
        return out
    if par.device.type == "cpu":
        return plain_partials(par, seed, block_offset, plan, n_blocks)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K24: per instrument the six integrands of K6's price, delta, vega, rho,
# theta and gamma, every constant read from the table; the indicator is
# where(sgn (st - k) > 0, sgn, 0), both of the ladder's static branches.
# ---------------------------------------------------------------------------

def _greek_quants(c, zz):
    """The six integrand tiles of one instrument's table column ``c`` on
    the signed normal ``zz`` (``mctpu``'s ``_book_greek_quants``)."""
    st = c[0] * torch.exp(c[1] + c[2] * zz)
    wv = c[3] * zz - c[4]
    q = c[5] + c[6] * zz
    sgn = c[12]
    edge = sgn * (st - c[11])
    ind = torch.where(edge > 0, sgn, torch.zeros_like(sgn))
    p = torch.clamp(edge, min=0.0)
    w = ind * st
    return (p, w * c[8], w * wv, c[10] * ind, w * q - c[7] * p,
            c[9] * (ind * zz))


def greek_plain_partials(cvec: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int) -> torch.Tensor:
    """Per-block ``(n_blocks, M, 12)`` Greek partials in plain PyTorch on
    ``cvec``'s device, over K1's stream."""
    m = cvec.shape[1]

    def draw_sums(z):
        sides = [z, -z] if plan.antithetic else [z]
        sums = []
        for j in range(m):
            c = cvec[:, j].unbind()
            quants = None
            for zz in sides:
                one = _greek_quants(c, zz)
                quants = one if quants is None else tuple(
                    x + y for x, y in zip(quants, one))
            if plan.antithetic:
                quants = tuple(0.5 * x for x in quants)
            for x in quants:
                sums += [x.sum(1), (x * x).sum(1)]
        return sums

    return terminal_partials(
        draw_sums, N_BOOK_GREEK_SUMS * m, seed, block_offset, plan, n_blocks,
        cvec.device).reshape(n_blocks, m, N_BOOK_GREEK_SUMS)


def greek_partials(cvec: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int) -> torch.Tensor:
    """Per-block ``(n_blocks, M, 12)`` Greek partials: K24 for a CUDA
    ``cvec``, the plain version for a CPU ``cvec``; other devices raise."""
    if cvec.device.type == "cuda":
        out = _launch("mctpu_book_greeks", cvec, 13, N_BOOK_GREEK_SUMS, seed,
                      block_offset, plan, n_blocks)
        LAUNCHES["book_greeks"] += 1
        return out
    if cvec.device.type == "cpu":
        return greek_plain_partials(cvec, seed, block_offset, plan, n_blocks)
    raise ValueError(f"unsupported device {cvec.device}")
