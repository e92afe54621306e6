"""K50 and K51: the Longstaff-Schwartz forward pass under a frozen exercise
rule, and its pathwise delta, vega and rho (``csrc/lsm.cu``).

Counterpart of :mod:`mctpu.kernels.lsm`.  Each unit walks a log-space GBM
over the ``n_steps`` exercise dates on the walk kernels' stream (reseeded
per (block, iteration), both Box-Muller branches per draw, the antithetic
mirror replaying the same draws), carrying the log-spot, the present-value
cashflow and an alive flag.  At date ``j`` a path still alive exercises
when its payoff is positive and above the continuation value

    y    = s * inv_k - 1
    cont = b0 + y (b1 + y (b2 + y b3))      (beta's row j)

and the last date pays every path still alive.  K50 writes per block
``(sum cf, sum cf^2)``; K51 also the ``(sum, sum^2)`` pairs of the
frozen-policy pathwise delta, vega and rho (:data:`N_GREEK_SUMS` = 8).

The operands are formed once, in float32 on the CPU in ``mctpu``'s
expression order (:func:`operands`), and moved to the device, so a kernel
and its plain version read the same bits: beta zero-padded to ``n_steps``
rows, ``df = exp(-r dt j)``, ``vc`` and ``rhoc``, and ``log s0``.  K51
reads K50's ``df`` table (``mctpu``'s K51 forms it as ``exp(-r (dt j))``,
an ulp away at most), so its price sums equal K50's bit for bit.
:func:`partials` and :func:`greek_partials` launch the CUDA kernels for
CUDA operands and run the plain versions for CPU operands; any other
device raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mctpu_torch import _build
from mctpu_torch.kernels.common import (Plan, check_operand, f32, sqrt32,
                                        walk_pairwise, walk_partials)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import AmericanOption

__all__ = ["make_plan", "BASIS", "SCAL", "N_GREEK_SUMS", "Operands",
           "padded_beta", "operands", "plain_partials",
           "partials", "greek_plain_partials", "greek_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"lsm": 0, "lsm_greeks": 0}

BASIS = 4  # 1, y, y^2, y^3 in centered moneyness y = s / k - 1
N_GREEK_SUMS = 8  # (sum, sum^2) of: PV cashflow, delta, vega, rho
# Entries of Operands.scal: mctpu's K51 scalars, then log s0.
SCAL = ("s0", "k", "drift", "vol", "inv_k", "inv_v", "psign", "inv_s0",
        "log_s0")


@dataclasses.dataclass(frozen=True)
class Operands:
    """K50's and K51's operands, float32: ``scal`` ``(9,)`` (:data:`SCAL`),
    ``beta`` ``(n_steps, 4)`` the rule's rows zero-padded, ``tables``
    ``(3, n_steps)`` = ``df``, ``vc``, ``rhoc``."""

    scal: torch.Tensor
    beta: torch.Tensor
    tables: torch.Tensor

    @property
    def n_steps(self) -> int:
        return self.beta.shape[0]

    @property
    def device(self) -> torch.device:
        return self.scal.device


def padded_beta(beta, n_steps: int) -> torch.Tensor:
    """The rule's ``(n_steps - 1, 4)`` rows rounded to float32 and
    zero-padded to ``n_steps`` rows (a one-row zero beta when ``n_steps ==
    1``): the maturity row is never read as a rule."""
    if not isinstance(beta, torch.Tensor):
        beta = torch.as_tensor(np.array(beta, np.float64))
    b = beta.detach().cpu().reshape(-1, BASIS)
    out = torch.zeros((max(n_steps, 1), BASIS), dtype=torch.float32)
    out[:b.shape[0]] = b.float()
    return out


def operands(opt: AmericanOption, beta, device) -> Operands:
    """The operands of ``opt`` under the rule ``beta``, formed in float32 on
    the CPU in ``mctpu``'s expression order and moved to ``device``."""
    n = opt.n_steps
    s0, k, r, v, t = f32(opt.s, opt.k, opt.r, opt.v, opt.t)
    dt = t / n
    drift = (r - 0.5 * v * v) * dt
    vol = v * sqrt32(dt)
    j = torch.arange(1, n + 1, dtype=torch.float32)
    log_s0 = torch.log(s0)
    df = torch.exp(-r * dt * j)
    tj = dt * j
    inv_v = 1.0 / v
    psign = torch.tensor(-1.0 if opt.payoff == "put" else 1.0,
                         dtype=torch.float32)
    vc = -(r + 0.5 * v * v) * inv_v * tj - log_s0 * inv_v
    rhoc = psign * tj * df * k
    scal = torch.stack([s0, k, drift, vol, 1.0 / k, inv_v, psign, 1.0 / s0,
                        log_s0])
    return Operands(scal=scal.to(device),
                    beta=padded_beta(beta, n).to(device),
                    tables=torch.stack([df, vc, rhoc]).contiguous().to(device))


def _walk(ops: Operands, put: bool, greeks: bool, key, idx, shape, sgn):
    """One walk of a ``(n_blocks, rows * 128)`` tile -> ``[cf]``, or
    ``[cf, gd, gv, gr]`` with ``greeks``."""
    sc = dict(zip(SCAL, ops.scal.unbind()))
    k, drift, vol, inv_k = sc["k"], sc["drift"], sc["vol"], sc["inv_k"]
    df, vc, rhoc = ops.tables.unbind()
    n = ops.n_steps
    one = torch.ones(shape, dtype=torch.float32, device=ops.device)

    def step(j, z, carry):
        log_s, cf, alive, gd, gv, gr = carry
        log_s = log_s + drift + vol * (sgn * z)
        s = torch.exp(log_s)
        pay = torch.clamp(k - s if put else s - k, min=0.0)
        if j == n - 1:
            ex = alive  # maturity pays every path still alive
        else:
            b0, b1, b2, b3 = ops.beta[j].unbind()
            y = s * inv_k - 1.0
            cont = b0 + y * (b1 + y * (b2 + y * b3))
            ex = alive * ((pay > 0) & (pay > cont)).to(torch.float32)
        cf = cf + df[j] * ex * pay
        if greeks:
            exi = ex * (pay > 0).to(torch.float32)
            wp = (sc["psign"] * df[j]) * (exi * s)
            gd = gd + wp * sc["inv_s0"]
            gv = gv + wp * (log_s * sc["inv_v"] + vc[j])
            gr = gr + exi * rhoc[j]
        return log_s, cf, alive - ex, gd, gv, gr

    zero = torch.zeros(shape, dtype=torch.float32, device=ops.device)
    init = (sc["log_s0"].expand(shape), zero, one, zero, zero, zero)
    _, cf, _, gd, gv, gr = walk_pairwise(key, idx, n, step, init)
    return [cf, gd, gv, gr] if greeks else [cf]


def plain_partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
                   n_blocks: int, put: bool) -> torch.Tensor:
    """Per-block ``[sum cf, sum cf^2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on the operands' device."""
    return walk_partials(
        lambda key, idx, shape, sgn: _walk(ops, put, False, key, idx, shape,
                                           sgn),
        seed, block_offset, plan, n_blocks, ops.device)


def greek_plain_partials(ops: Operands, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int,
                         put: bool) -> torch.Tensor:
    """Per-block ``(n_blocks, 8)`` sums of the cashflow, delta, vega and
    rho in plain PyTorch on the operands' device, over K50's stream."""
    return walk_partials(
        lambda key, idx, shape, sgn: _walk(ops, put, True, key, idx, shape,
                                           sgn),
        seed, block_offset, plan, n_blocks, ops.device)


def _launch(entry: str, ops: Operands, n_out: int, seed: int,
            block_offset: int, plan: Plan, n_blocks: int,
            put: bool) -> torch.Tensor:
    n = ops.n_steps
    for name, x, shape in (("scal", ops.scal, (len(SCAL),)),
                           ("beta", ops.beta, (n, BASIS)),
                           ("tables", ops.tables, (3, n))):
        check_operand(name, x, shape, ops.device)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    lib = _build.library()
    with torch.cuda.device(ops.device):
        out = torch.empty((n_blocks, n_out), dtype=torch.float32,
                          device=ops.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        status = getattr(lib, entry)(
            ops.scal.data_ptr(), ops.beta.data_ptr(), ops.tables.data_ptr(),
            n, wrap_int32(seed), wrap_int32(block_offset), n_blocks,
            plan.rows, plan.iters, int(plan.antithetic), int(put),
            int(plan.kahan), out.data_ptr(), stream)
    _build.check(status, entry)
    return out


def partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, put: bool) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K50 for CUDA operands, the
    plain version for CPU operands; any other device raises."""
    if ops.device.type == "cuda":
        out = _launch("mctpu_lsm", ops, 2, seed, block_offset, plan,
                      n_blocks, put)
        LAUNCHES["lsm"] += 1
        return out
    if ops.device.type == "cpu":
        return plain_partials(ops, seed, block_offset, plan, n_blocks, put)
    raise ValueError(f"unsupported device {ops.device}")


def greek_partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
                   n_blocks: int, put: bool) -> torch.Tensor:
    """``(n_blocks, 8)`` Greek partials: K51 for CUDA operands, the plain
    version for CPU operands; any other device raises."""
    if ops.device.type == "cuda":
        out = _launch("mctpu_lsm_greeks", ops, N_GREEK_SUMS, seed,
                      block_offset, plan, n_blocks, put)
        LAUNCHES["lsm_greeks"] += 1
        return out
    if ops.device.type == "cpu":
        return greek_plain_partials(ops, seed, block_offset, plan, n_blocks,
                                    put)
    raise ValueError(f"unsupported device {ops.device}")
