"""K2 and K3: fused weighted-basket call Monte Carlo (``csrc/basket.cu``).

Counterpart of :mod:`mctpu.kernels.basket`, with both of its stream maps:

* up to ``ASSET_MAJOR_MAX`` assets, asset-major (K2): iteration ``i`` draws
  pair ``i*a + p`` for asset ``p`` at every tile element; the cosine
  branches form path tile A, the sine branches path tile B;
* wider baskets, lane-packed (K3): a ``(rows, width)`` tile whose row packs
  ``c`` paths of ``a_tile`` lanes each (:func:`pack_factor`); iteration
  ``i`` draws pair ``i`` at every element.

The TPU's block-diagonal Cholesky and weight-selector matrices exist to put
the packed product on the MXU; the port keeps the packing (it is the stream
map) and hands the kernel the compact ``(a, a)`` factor and per-asset rows.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mctpu_torch import _build
from mctpu_torch.kernels.common import (LANES, Plan, acc_add_n,
                                        acc_final_n, acc_init_n, block_keys,
                                        check_operand, draw_normal_pair,
                                        tile_index)
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import BasketOption

__all__ = ["ASSET_MAJOR_MAX", "use_asset_major", "pack_factor", "make_plan",
           "Operands", "asset_major_ops", "pack_assets", "operands",
           "am_basket", "packed_basket", "stream_partials", "launch",
           "plain_partials", "partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"basket_am": 0, "basket_packed": 0}

# Baskets up to this size take the asset-major stream map (K2).
ASSET_MAJOR_MAX = 8


def use_asset_major(n_assets: int) -> bool:
    return n_assets <= ASSET_MAJOR_MAX


def pack_factor(n_assets: int, lanes: int = LANES):
    """``(a_tile, c, width)``: lanes one path spans, paths per tile row,
    and the tile's lane width (wide baskets: one path per row, assets
    padded to a lane multiple)."""
    a_tile = 1
    while a_tile < n_assets:
        a_tile *= 2
    if a_tile >= lanes:
        width = -(-n_assets // lanes) * lanes
        return width, 1, width
    return a_tile, lanes // a_tile, lanes


def make_plan(n_paths: int, num_blocks: int, rows: int, antithetic: bool,
              kahan: bool = True, n_assets: int = 3) -> Plan:
    if use_asset_major(n_assets):
        units = 2 * rows * LANES  # two (rows, 128) path tiles per iteration
    else:
        _, c, _ = pack_factor(n_assets)
        units = 2 * rows * c  # two (rows, width) tiles of c paths per row
    paths = units * (2 if antithetic else 1)
    return Plan.plan(n_paths, num_blocks, rows, paths, units, antithetic,
                     kahan)


@dataclasses.dataclass(frozen=True)
class Operands:
    """Kernel operands: strike ``k`` ``(1,)``, lower Cholesky factor ``lt``
    ``(a, a)`` and per-asset rows ``par`` — ``(4, a)`` drift, vol, d, w*s0
    for K2; ``(5, a)`` drift, vol, d, s0, w for K3.  All float32."""

    k: torch.Tensor
    lt: torch.Tensor
    par: torch.Tensor

    @property
    def n_assets(self) -> int:
        return self.lt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.lt.device


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32)


def asset_major_ops(opt: BasketOption, chol) -> tuple:
    """K2's ``(lt, par)`` in float32, in ``asset_major_ops``' expression
    order (``drift = (r - 0.5 * v**2) * t``, ``w * s0``)."""
    a = opt.n_assets
    r, t, v = _f32(opt.r), _f32(opt.t), _f32(opt.v)
    drift = (r - 0.5 * (v * v)) * t
    vol = v * torch.sqrt(t)
    rows = [drift, vol, _f32(opt.d), _f32(opt.w) * _f32(opt.s)]
    par = torch.stack([torch.broadcast_to(x, (a,)) for x in rows])
    return _f32(chol), par


def pack_assets(opt: BasketOption, chol) -> tuple:
    """K3's ``(lt, par)`` in float32, in ``pack_assets``' expression order
    (``drift = (r - 0.5 * v * v) * t``; ``s0`` and ``w`` kept apart)."""
    r, t, v = _f32(opt.r), _f32(opt.t), _f32(opt.v)
    drift = (r - 0.5 * v * v) * t
    vol = v * torch.sqrt(t)
    par = torch.stack([drift, vol, _f32(opt.d), _f32(opt.s), _f32(opt.w)])
    return _f32(chol), par


def operands(opt: BasketOption, chol, device) -> Operands:
    """The kernel operands of ``opt`` with lower Cholesky factor ``chol``,
    formed on the CPU and moved to ``device``."""
    build = asset_major_ops if use_asset_major(opt.n_assets) else pack_assets
    lt, par = build(opt, chol)
    return Operands(k=_f32([opt.k]).to(device), lt=lt.contiguous().to(device),
                    par=par.contiguous().to(device))


def am_basket(zs, lt, par, a: int, sgn: float):
    """Basket value of one path tile from its ``a`` asset normal tiles,
    the ``L z`` term signed by ``sgn`` (K2's and K47's core)."""
    basket = None
    for i in range(a):
        bt = None
        for j in range(i + 1):
            term = lt[i, j] * zs[j]
            bt = term if bt is None else bt + term
        arg = par[0, i] + par[1, i] * (sgn * bt + par[2, i])
        term = par[3, i] * torch.exp(arg)
        basket = term if basket is None else basket + term
    return basket


def _am_payoff(zs, lt, par, k, a: int, antithetic: bool):
    """Basket payoff of one path tile from its ``a`` asset normal tiles."""
    def pay(sgn):
        return torch.clamp(am_basket(zs, lt, par, a, sgn) - k, min=0.0)

    if antithetic:
        return 0.5 * (pay(1.0) + pay(-1.0))
    return pay(1.0)


def packed_basket(z, lt, par):
    """Basket values of packed paths ``z (..., a)`` -> ``(...)`` (K3's and
    K48's core)."""
    drift, vol, d, s0, w = par
    bt = torch.matmul(z, lt.T) + d
    s_t = s0 * torch.exp(drift + vol * bt)
    return (s_t * w).sum(-1)


def _packed_payoff(z, lt, par, k, antithetic: bool):
    """Basket payoffs of packed paths ``z (..., a)`` -> ``(...)``."""
    def pay(zz):
        return torch.clamp(packed_basket(zz, lt, par) - k, min=0.0)

    if antithetic:
        return 0.5 * (pay(z) + pay(-z))
    return pay(z)


def stream_partials(tile_sums, n_sums: int, a: int, seed: int,
                    block_offset: int, plan: Plan, n_blocks: int,
                    device) -> torch.Tensor:
    """Per-block ``(n_blocks, n_sums)`` partials over the basket kernels'
    stream map (asset-major or packed by ``a``): ``tile_sums(z)`` returns
    the ``n_sums`` per-block sums of one branch's path tile, ``z`` a list
    of ``a`` ``(n_blocks, rows * 128)`` asset tiles (asset-major) or the
    ``(n_blocks, rows, c, a)`` packed paths; the two branches' sums are
    added, then Kahan-added over iterations if ``plan.kahan``."""
    key = block_keys(seed, [block_offset + b for b in range(n_blocks)],
                     device)
    carry = acc_init_n(n_sums, n_blocks, device)
    if use_asset_major(a):
        idx = tile_index(plan.rows * LANES, device)
    else:
        a_tile, c, width = pack_factor(a)
        idx = tile_index(plan.rows * width, device)
    for i in range(plan.iters):
        if use_asset_major(a):
            pairs = [draw_normal_pair(key, idx, i * a + p) for p in range(a)]
            tiles = ([z1 for z1, _ in pairs], [z2 for _, z2 in pairs])
        else:
            tiles = tuple(z.view(n_blocks, plan.rows, c, a_tile)[..., :a]
                          for z in draw_normal_pair(key, idx, i))
        sums = [x + y for x, y in zip(*(tile_sums(z) for z in tiles))]
        carry = acc_add_n(carry, sums, plan.kahan)
    return acc_final_n(carry)


def plain_partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
                   n_blocks: int) -> torch.Tensor:
    """Per-block ``[sum_p, sum_p2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on the operands' device, over the same stream map as the
    kernel (asset-major or packed by ``n_assets``)."""
    a = ops.n_assets
    k = ops.k[0]
    am = use_asset_major(a)

    def tile_sums(z):
        if am:
            p = _am_payoff(z, ops.lt, ops.par, k, a, plan.antithetic)
            return [p.sum(1), (p * p).sum(1)]
        p = _packed_payoff(z, ops.lt, ops.par, k, plan.antithetic)
        return [p.sum((1, 2)), (p * p).sum((1, 2))]

    return stream_partials(tile_sums, 2, a, seed, block_offset, plan,
                           n_blocks, ops.device)


def _check(ops: Operands):
    a = ops.n_assets
    rows = 4 if use_asset_major(a) else 5
    for name, x, shape in (("k", ops.k, (1,)), ("lt", ops.lt, (a, a)),
                           ("par", ops.par, (rows, a))):
        check_operand(name, x, shape, ops.device)


def launch(prefix: str, scal: torch.Tensor, lt: torch.Tensor,
           par: torch.Tensor, n_sums: int, seed: int, block_offset: int,
           plan: Plan, n_blocks: int, scratch_cap: int = 0):
    """Launch the asset-major or packed kernel ``mctpu_{prefix}_am`` /
    ``_packed`` (K2/K3 with ``scal = [k]``, K47/K48 with ``scal = [k, p0,
    m]``) on checked operands; returns ``(kernel name, (n_blocks, n_sums)
    partials)``.  K3 and K48 take a scratch, allocated here on the current
    stream: K48's (block, iteration) rows, K3's unit payoffs, in groups of
    at most ``scratch_cap`` floats (0: 256 MB; the outputs do not depend on
    it).  Raises on a failed launch."""
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    a = lt.shape[0]
    lib = _build.library()
    with torch.cuda.device(lt.device):
        out = torch.empty((n_blocks, n_sums), dtype=torch.float32,
                          device=lt.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        common = (wrap_int32(seed), wrap_int32(block_offset), n_blocks,
                  plan.rows, plan.iters, int(plan.antithetic),
                  int(plan.kahan), out.data_ptr(), stream)
        ptrs = (lt.data_ptr(), par.data_ptr(), scal.data_ptr())
        if use_asset_major(a):
            name = f"{prefix}_am"
            status = getattr(lib, f"mctpu_{name}")(*ptrs, a, *common)
        else:
            name = f"{prefix}_packed"
            a_tile, _, width = pack_factor(a)
            if prefix == "basket_cv":
                n_scratch = lib.mctpu_basket_cv_packed_scratch_floats(
                    n_blocks, plan.iters)
                extra = ()
            else:
                n_scratch = lib.mctpu_basket_packed_scratch_floats(
                    a_tile, width, n_blocks, plan.rows, plan.iters,
                    scratch_cap)
                extra = (scratch_cap,)
            scratch = torch.empty(n_scratch, dtype=torch.float32,
                                  device=lt.device)
            common = (common[:-2] + extra + (scratch.data_ptr(),)
                      + common[-2:])
            status = getattr(lib, f"mctpu_{name}")(*ptrs, a, a_tile, width,
                                                    *common)
    _build.check(status, name)
    return name, out


def _cuda_partials(ops: Operands, seed, block_offset, plan, n_blocks,
                   scratch_cap):
    _check(ops)
    name, out = launch("basket", ops.k, ops.lt, ops.par, 2, seed,
                       block_offset, plan, n_blocks, scratch_cap)
    LAUNCHES[name] += 1
    return out


def partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, scratch_cap: int = 0) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K2 or K3 for CUDA operands,
    the plain version for CPU operands; any other device raises.
    ``scratch_cap``: K3's scratch in floats at most (0: 256 MB), past which
    it splits and folds simulation blocks and iterations in groups; the
    outputs do not depend on it."""
    if ops.device.type == "cuda":
        return _cuda_partials(ops, seed, block_offset, plan, n_blocks,
                              scratch_cap)
    if ops.device.type == "cpu":
        return plain_partials(ops, seed, block_offset, plan, n_blocks)
    raise ValueError(f"unsupported device {ops.device}")
