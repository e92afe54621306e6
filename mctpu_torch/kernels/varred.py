"""K45-K48: the control-variate kernels, and K49: the importance-sampled
call (``csrc/varred.cu``).

Counterpart of :mod:`mctpu.kernels.varred`.
Each kernel is a pricing kernel of the port with a control variable ``c``
beside the payoff ``p``, and writes per block the five centered moment sums

    (sum d, sum d^2, sum cc, sum cc^2, sum d cc),
    cc = c - m,  d = (p - p0) - cc,

with ``p`` and ``c`` pair-meaned under antithetic first.  ``m`` is the
control's exact mean and ``p0`` a proxy for the payoff's
(:mod:`mctpu_torch.variance` forms both and runs the pilot/main estimator).

* K45 ``vanilla_cv``: K1's stream and terminal draw; ``c = S_T``.
* K46 ``asian_cv``: K9's walk, carrying the log-spot's sum; ``p`` the
  arithmetic payoff, ``c`` the geometric one.
* K47 ``basket_cv_am`` (up to 8 assets) and K48 ``basket_cv_packed``
  (beyond): K2's and K3's stream maps; ``c`` the terminal basket value.

The centers are the last two float32 entries of each kernel's scalars
(``par``, ``scal``).

* K49 ``vanilla_is``: K1's stream, each normal tilted to ``zt = z +
  theta`` and its call payoff weighted by ``exp(-theta zt + theta^2 /
  2)``; per block ``(sum p, sum p^2)``.

Each wrapper launches its CUDA kernel for a CUDA operand and runs its plain
PyTorch version, over the same stream, for a CPU operand; any other device
raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mctpu_torch import _build
from mctpu_torch.kernels import asian as kasian
from mctpu_torch.kernels import basket as kbasket
from mctpu_torch.kernels import vanilla as kvanilla
from mctpu_torch.kernels.common import (Plan, check_operand, launch_walk,
                                        terminal_partials, walk_pairwise,
                                        walk_partials)
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import AsianOption, BasketOption, VanillaOption

__all__ = ["N_MOMENT_SUMS", "LAUNCHES", "moment_sums", "center32",
           "vanilla_cv_params", "vanilla_cv_plain_partials",
           "vanilla_cv_partials", "asian_cv_params",
           "asian_cv_plain_partials", "asian_cv_partials", "CvOperands",
           "basket_cv_operands", "basket_cv_plain_partials",
           "basket_cv_partials", "is_params", "is_plain_partials",
           "is_partials"]

# Per block: (sum d, sum d^2, sum cc, sum cc^2, sum d cc).
N_MOMENT_SUMS = 5

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"vanilla_cv": 0, "asian_cv": 0, "basket_cv_am": 0,
            "basket_cv_packed": 0, "vanilla_is": 0}


def moment_sums(p, c, p0, m, dims):
    """The five centered moment sums of the unit tiles ``(p, c)`` over
    ``dims``, in ``mctpu``'s order (``_moment_sums``)."""
    cc = c - m
    d = (p - p0) - cc
    return [d.sum(dims), (d * d).sum(dims), cc.sum(dims), (cc * cc).sum(dims),
            (d * cc).sum(dims)]


def center32(center) -> torch.Tensor:
    """``(p0, m)`` rounded to float32 on the CPU (the kernels' centers)."""
    return torch.tensor(np.asarray(center, np.float64), dtype=torch.float32)


# ---------------------------------------------------------------------------
# K45: vanilla call, control S_T
# ---------------------------------------------------------------------------

def vanilla_cv_params(opt: VanillaOption, center, device) -> torch.Tensor:
    """``[s0, k, mu, sig, p0, m]`` in float32 (K1's ``par`` and the
    centers)."""
    return torch.cat([kvanilla.params(opt, "cpu"), center32(center)]).to(
        device)


def _vanilla_pc(s0, k, mu, sig, z, antithetic: bool):
    def pc(zz):
        st = s0 * torch.exp(mu + sig * zz)
        return torch.clamp(st - k, min=0.0), st

    p, c = pc(z)
    if antithetic:
        pm, cm = pc(-z)
        return 0.5 * (p + pm), 0.5 * (c + cm)
    return p, c


def vanilla_cv_plain_partials(par: torch.Tensor, seed: int,
                              block_offset: int, plan: Plan,
                              n_blocks: int) -> torch.Tensor:
    """Per-block ``(n_blocks, 5)`` moment sums in plain PyTorch on
    ``par``'s device, over K1's stream."""
    s0, k, mu, sig, p0, m = par.unbind()

    def draw_sums(z):
        p, c = _vanilla_pc(s0, k, mu, sig, z, plan.antithetic)
        return moment_sums(p, c, p0, m, 1)

    return terminal_partials(draw_sums, N_MOMENT_SUMS, seed, block_offset,
                             plan, n_blocks, par.device)


def vanilla_cv_partials(par: torch.Tensor, seed: int, block_offset: int,
                        plan: Plan, n_blocks: int) -> torch.Tensor:
    """``(n_blocks, 5)`` moment sums: K45 for a CUDA ``par``, the plain
    version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        check_operand("par", par, (6,), par.device)
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        lib = _build.library()
        with torch.cuda.device(par.device):
            out = torch.empty((n_blocks, N_MOMENT_SUMS), dtype=torch.float32,
                              device=par.device)
            stream = torch.cuda.current_stream().cuda_stream
            status = lib.mctpu_vanilla_cv(
                par.data_ptr(), wrap_int32(seed), wrap_int32(block_offset),
                n_blocks, plan.rows, plan.iters, int(plan.antithetic),
                int(plan.kahan), out.data_ptr(), ctypes.c_void_p(stream))
        _build.check(status, "vanilla_cv")
        LAUNCHES["vanilla_cv"] += 1
        return out
    if par.device.type == "cpu":
        return vanilla_cv_plain_partials(par, seed, block_offset, plan,
                                         n_blocks)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K46: arithmetic Asian call, control the geometric Asian call
# ---------------------------------------------------------------------------

def asian_cv_params(opt: AsianOption, center, device) -> torch.Tensor:
    """``[log s0, k, drift, vol, p0, m]`` in float32 (K9's ``scal`` and
    the centers)."""
    return torch.cat([kasian.params(opt, "cpu"), center32(center)]).to(device)


def asian_cv_plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                            plan: Plan, n_blocks: int,
                            n_obs: int) -> torch.Tensor:
    """Per-block ``(n_blocks, 5)`` moment sums in plain PyTorch on
    ``par``'s device, over K9's stream."""
    log_s0, k, drift, vol, p0, m = par.unbind()
    # mctpu's 1.0 / n_obs: a double rounded to float32.
    inv_n = torch.tensor(1.0 / n_obs, dtype=torch.float32, device=par.device)

    def walk(key, idx, shape, sgn):
        def step(j, z, carry):
            log_s, sa, sl = carry
            log_s = log_s + drift + vol * (sgn * z)
            return log_s, sa + torch.exp(log_s), sl + log_s

        zero = torch.zeros(shape, dtype=torch.float32, device=par.device)
        _, sa, sl = walk_pairwise(key, idx, n_obs, step,
                                  (log_s0.expand(shape), zero, zero))
        return [torch.clamp(sa * inv_n - k, min=0.0),
                torch.clamp(torch.exp(sl * inv_n) - k, min=0.0)]

    return walk_partials(walk, seed, block_offset, plan, n_blocks,
                         par.device,
                         sums=lambda t: moment_sums(t[0], t[1], p0, m, 1))


def asian_cv_partials(par: torch.Tensor, seed: int, block_offset: int,
                      plan: Plan, n_blocks: int, n_obs: int) -> torch.Tensor:
    """``(n_blocks, 5)`` moment sums: K46 for a CUDA ``par``, the plain
    version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        out = launch_walk("mctpu_asian_cv", par, 6, N_MOMENT_SUMS, seed,
                          block_offset, plan, n_blocks, n_obs, 0)
        LAUNCHES["asian_cv"] += 1
        return out
    if par.device.type == "cpu":
        return asian_cv_plain_partials(par, seed, block_offset, plan,
                                       n_blocks, n_obs)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K47, K48: basket call, control the terminal basket value
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CvOperands:
    """K47's / K48's operands: ``scal = [k, p0, m]`` ``(3,)`` and K2's or
    K3's lower Cholesky factor ``lt`` ``(a, a)`` and per-asset rows
    ``par`` (:class:`mctpu_torch.kernels.basket.Operands`).  float32."""

    scal: torch.Tensor
    lt: torch.Tensor
    par: torch.Tensor

    @property
    def n_assets(self) -> int:
        return self.lt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.lt.device


def basket_cv_operands(opt: BasketOption, chol, center,
                       device) -> CvOperands:
    """The CV kernels' operands of ``opt`` with lower Cholesky factor
    ``chol`` and centers ``(p0, m)``, formed on the CPU and moved to
    ``device``."""
    ops = kbasket.operands(opt, chol, "cpu")
    return CvOperands(scal=torch.cat([ops.k, center32(center)]).to(device),
                      lt=ops.lt.to(device), par=ops.par.to(device))


def basket_cv_plain_partials(ops: CvOperands, seed: int, block_offset: int,
                             plan: Plan, n_blocks: int) -> torch.Tensor:
    """Per-block ``(n_blocks, 5)`` moment sums in plain PyTorch on the
    operands' device, over K2's (asset-major) or K3's (packed) stream."""
    a = ops.n_assets
    k, p0, m = ops.scal.unbind()
    am = kbasket.use_asset_major(a)

    def tile_sums(z):
        def value(sgn):
            if am:
                return kbasket.am_basket(z, ops.lt, ops.par, a, sgn)
            return kbasket.packed_basket(sgn * z, ops.lt, ops.par)

        c = value(1.0)
        p = torch.clamp(c - k, min=0.0)
        if plan.antithetic:
            cm = value(-1.0)
            p, c = 0.5 * (p + torch.clamp(cm - k, min=0.0)), 0.5 * (c + cm)
        return moment_sums(p, c, p0, m, 1 if am else (1, 2))

    return kbasket.stream_partials(tile_sums, N_MOMENT_SUMS, a, seed,
                                   block_offset, plan, n_blocks, ops.device)


def _check(ops: CvOperands):
    a = ops.n_assets
    rows = 4 if kbasket.use_asset_major(a) else 5
    for name, x, shape in (("scal", ops.scal, (3,)), ("lt", ops.lt, (a, a)),
                           ("par", ops.par, (rows, a))):
        check_operand(name, x, shape, ops.device)


def basket_cv_partials(ops: CvOperands, seed: int, block_offset: int,
                       plan: Plan, n_blocks: int) -> torch.Tensor:
    """``(n_blocks, 5)`` moment sums: K47 (up to 8 assets) or K48 (beyond)
    for CUDA operands, the plain version for CPU operands; any other
    device raises."""
    if ops.device.type == "cuda":
        _check(ops)
        name, out = kbasket.launch("basket_cv", ops.scal, ops.lt, ops.par,
                                   N_MOMENT_SUMS, seed, block_offset, plan,
                                   n_blocks)
        LAUNCHES[name] += 1
        return out
    if ops.device.type == "cpu":
        return basket_cv_plain_partials(ops, seed, block_offset, plan,
                                        n_blocks)
    raise ValueError(f"unsupported device {ops.device}")


# ---------------------------------------------------------------------------
# K49: importance-sampled call (exponential tilting of K1's draw)
# ---------------------------------------------------------------------------

def is_params(opt: VanillaOption, theta, device) -> torch.Tensor:
    """``[s0, k, mu, sig, theta]`` in float32 (K1's ``par`` and the tilt
    rounded to float32)."""
    th = torch.tensor(float(theta), dtype=torch.float32)
    return torch.cat([kvanilla.params(opt, "cpu"), th.view(1)]).to(device)


def _is_tile(s0, k, mu, sig, th, z, antithetic: bool):
    """Likelihood-ratio-weighted payoffs of a draw tile: sample ``zt = z +
    theta``, weight by ``dP/dQ = exp(-theta zt + theta^2 / 2)``
    (``mctpu``'s ``_is_tile``)."""
    def y(zz):
        zt = zz + th
        lr = torch.exp(-th * zt + 0.5 * th * th)
        st = s0 * torch.exp(mu + sig * zt)
        return torch.clamp(st - k, min=0.0) * lr

    if antithetic:
        return 0.5 * (y(z) + y(-z))
    return y(z)


def is_plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                      plan: Plan, n_blocks: int) -> torch.Tensor:
    """Per-block ``(n_blocks, 2)`` ``[sum p, sum p^2]`` in plain PyTorch on
    ``par``'s device, over K1's stream."""
    s0, k, mu, sig, th = par.unbind()

    def draw_sums(z):
        p = _is_tile(s0, k, mu, sig, th, z, plan.antithetic)
        return [p.sum(1), (p * p).sum(1)]

    return terminal_partials(draw_sums, 2, seed, block_offset, plan,
                             n_blocks, par.device)


def is_partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
                n_blocks: int) -> torch.Tensor:
    """``(n_blocks, 2)`` partials: K49 for a CUDA ``par``, the plain version
    for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        check_operand("par", par, (5,), par.device)
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        lib = _build.library()
        with torch.cuda.device(par.device):
            out = torch.empty((n_blocks, 2), dtype=torch.float32,
                              device=par.device)
            stream = torch.cuda.current_stream().cuda_stream
            status = lib.mctpu_vanilla_is(
                par.data_ptr(), wrap_int32(seed), wrap_int32(block_offset),
                n_blocks, plan.rows, plan.iters, int(plan.antithetic),
                int(plan.kahan), out.data_ptr(), ctypes.c_void_p(stream))
        _build.check(status, "vanilla_is")
        LAUNCHES["vanilla_is"] += 1
        return out
    if par.device.type == "cpu":
        return is_plain_partials(par, seed, block_offset, plan, n_blocks)
    raise ValueError(f"unsupported device {par.device}")
