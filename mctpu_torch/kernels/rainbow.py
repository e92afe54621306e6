"""K36, K37 and K38: the rainbow call on the maximum or minimum of
correlated assets, and its asset-major Greeks (``csrc/rainbow.cu``).

Counterpart of :mod:`mctpu.kernels.rainbow`, with both of its stream maps
(those of the basket kernels K2 and K3):

* up to ``ASSET_MAJOR_MAX`` assets, asset-major (K36, K38): iteration ``i``
  draws pair ``i*a + p`` for asset ``p`` at every element of a ``(rows,
  128)`` tile; the cosine branches form path tile A, the sine branches
  path tile B; ``bt_i = sum_{j <= i} L_ij z_j`` from the first product,
  ``S_i = s0_i exp(drift_i + vol_i (sgn bt_i))``, and the extreme is a
  running max or min over the assets;
* wider baskets, lane-packed (K37): a ``(rows, width)`` tile whose row packs
  ``c`` paths of ``a_tile`` lanes (:func:`pack_factor`), pair ``i`` at every
  element; the extreme is taken over the path's real assets.  The TPU's
  lane butterfly leaves it at each segment's head lane over extreme-neutral
  padding (spot 0 for max, +inf for min); the padding never changes it, so
  the port hands the kernel the compact ``(a, a)`` factor and per-asset
  rows and never touches a padded lane.

K38 draws K36's paths and tracks the arg-extreme asset with a strict-compare
select chain (the first extreme wins a tie): per asset the pathwise delta
``1{argext = i} I S_i / s0_i`` and vega ``1{argext = i} I S_i sqrt(t)
(bt_i - vol_i)``, and the scalar rho ``t k I`` and theta; ``6 + 4a`` sums a
block (:func:`n_greek_sums`).  K36 and K38 share one per-path core, so a
Greeks price equals the pricer's.

Every operand is formed on the CPU in float32 in ``mctpu``'s expression
order; the plain versions form ``L z`` as multiplies and adds in the
kernels' order (the packed one column by column from 0), never with
``torch.matmul``, and the kernels build with ``-fmad=false``, so the
arg-extreme and the in-the-money indicator fall alike path by path.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mctpu_torch import _build
from mctpu_torch.kernels import basket as kbasket
from mctpu_torch.kernels.basket import (ASSET_MAJOR_MAX, pack_factor,
                                        use_asset_major)
from mctpu_torch.kernels.common import (LANES, Plan, acc_add, acc_add_n,
                                        acc_final, acc_final_n, acc_init,
                                        acc_init_n, block_keys, check_operand,
                                        draw_normal_pair, f32, sqrt32,
                                        tile_index)
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import RainbowOption

__all__ = ["make_plan", "n_greek_sums", "Operands", "GreekOperands",
           "rainbow_am_ops", "pack_rainbow", "operands", "greek_operands",
           "plain_partials", "partials", "greek_plain_partials",
           "greek_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"rainbow_am": 0, "rainbow_packed": 0, "rainbow_greeks": 0}

# The rainbow runs the basket's plan: 2 * rows * 128 units per (block,
# iteration) asset-major, 2 * rows * c packed (mctpu's make_plan).
make_plan = kbasket.make_plan


def n_greek_sums(a: int) -> int:
    """Per-block sums of K38: ``(p, p2, rho, rho2, th, th2)``, then per
    asset ``(gd, gd2, gv, gv2)``."""
    return 6 + 4 * a


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Operands:
    """K36's and K37's float32 operands: strike ``k`` ``(1,)``, lower
    Cholesky factor ``lt`` ``(a, a)``, per-asset rows ``par`` ``(3, a)`` =
    drift, vol, s0; ``use_min`` for the call on the minimum."""

    k: torch.Tensor
    lt: torch.Tensor
    par: torch.Tensor
    use_min: bool

    @property
    def n_assets(self) -> int:
        return self.lt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.lt.device


def rainbow_am_ops(opt: RainbowOption, chol) -> tuple:
    """K36's ``(lt, par)`` in float32, in ``rainbow_am_ops``' expression
    order: ``drift = (r - 0.5 * v**2) * t``, ``vol = v * sqrt(t)``."""
    a = opt.n_assets
    r, t, v = _f32(opt.r), _f32(opt.t), _f32(opt.v)
    drift = (r - 0.5 * (v * v)) * t
    vol = v * sqrt32(t)
    rows = [drift, vol, _f32(opt.s)]
    par = torch.stack([torch.broadcast_to(x, (a,)) for x in rows])
    return _f32(chol), par


def pack_rainbow(opt: RainbowOption, chol) -> tuple:
    """K37's ``(lt, par)``: the real lanes of ``pack_rainbow``'s rows in
    float32, in its expression order (``drift = (r - 0.5 * v * v) * t``,
    ``vol = v * sqrt(t)``), and the compact factor whose transpose fills
    its block-diagonal ``chol_bd``."""
    r, t, v = _f32(opt.r), _f32(opt.t), _f32(opt.v)
    drift = (r - 0.5 * v * v) * t
    vol = v * sqrt32(t)
    return _f32(chol), torch.stack([drift, vol, _f32(opt.s)])


def operands(opt: RainbowOption, chol, device) -> Operands:
    """The pricing operands of ``opt`` with lower Cholesky factor ``chol``,
    formed on the CPU and moved to ``device``."""
    build = rainbow_am_ops if use_asset_major(opt.n_assets) else pack_rainbow
    lt, par = build(opt, chol)
    return Operands(k=_f32([opt.k]).to(device),
                    lt=lt.contiguous().to(device),
                    par=par.contiguous().to(device),
                    use_min=opt.kind == "min")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _am_spots(zs, lt, par, a: int, sgn: float):
    """One asset-major path tile's ``(spots, signed bt)`` per asset, in
    ``mctpu``'s ``_am_payoff`` order; K36 and K38 share it."""
    ss, bts = [], []
    for i in range(a):
        bt = None
        for j in range(i + 1):
            x = lt[i, j] * zs[j]
            bt = x if bt is None else bt + x
        btd = sgn * bt
        ss.append(par[2, i] * torch.exp(par[0, i] + par[1, i] * btd))
        bts.append(btd)
    return ss, bts


def _arg_extreme(ss, use_min: bool):
    """``(ext, idx)``: the strict-compare select chain over the assets'
    spots (the first extreme wins a tie)."""
    ext = ss[0]
    idx = torch.zeros(ext.shape, dtype=torch.int64, device=ext.device)
    for i in range(1, len(ss)):
        better = ss[i] < ext if use_min else ss[i] > ext
        ext = torch.where(better, ss[i], ext)
        idx = torch.where(better, i, idx)
    return ext, idx


def _am_payoff(zs, ops: Operands, a: int, antithetic: bool):
    k = ops.k[0]

    def pay(sgn):
        ext, _ = _arg_extreme(_am_spots(zs, ops.lt, ops.par, a, sgn)[0],
                              ops.use_min)
        return torch.clamp(ext - k, min=0.0)

    if antithetic:
        return 0.5 * (pay(1.0) + pay(-1.0))
    return pay(1.0)


def _packed_payoff(z, ops: Operands, antithetic: bool):
    """Payoffs of packed paths ``z (B, rows, c, a)``: ``L z`` column by
    column from 0 (the zero terms above the diagonal add exactly 0, as the
    TPU's block-diagonal product does), the extreme over the real assets."""
    drift, vol, s0 = ops.par
    k = ops.k[0]
    a = ops.n_assets

    def pay(zz):
        bt = torch.zeros_like(zz)
        for j in range(a):
            bt = bt + ops.lt[:, j] * zz[..., j:j + 1]
        s_t = s0 * torch.exp(drift + vol * bt)
        ext = s_t.amin(-1) if ops.use_min else s_t.amax(-1)
        return torch.clamp(ext - k, min=0.0)

    if antithetic:
        return 0.5 * (pay(z) + pay(-z))
    return pay(z)


def plain_partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
                   n_blocks: int) -> torch.Tensor:
    """Per-block ``[sum_p, sum_p2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on the operands' device, over K36's stream (``a <= 8``) or
    K37's."""
    dev = ops.device
    a = ops.n_assets
    key = block_keys(seed, [block_offset + b for b in range(n_blocks)], dev)
    carry = acc_init(n_blocks, dev)
    if use_asset_major(a):
        idx = tile_index(plan.rows * LANES, dev)
        for i in range(plan.iters):
            za, zb = [], []
            for p in range(a):
                z1, z2 = draw_normal_pair(key, idx, i * a + p)
                za.append(z1)
                zb.append(z2)
            p1 = _am_payoff(za, ops, a, plan.antithetic)
            p2 = _am_payoff(zb, ops, a, plan.antithetic)
            cs = p1.sum(1) + p2.sum(1)
            cs2 = (p1 * p1).sum(1) + (p2 * p2).sum(1)
            carry = acc_add(carry, cs, cs2, plan.kahan)
        return acc_final(carry)

    a_tile, c, width = pack_factor(a)
    idx = tile_index(plan.rows * width, dev)
    for i in range(plan.iters):
        z1, z2 = draw_normal_pair(key, idx, i)
        ps = [_packed_payoff(z.view(n_blocks, plan.rows, c, a_tile)[..., :a],
                             ops, plan.antithetic) for z in (z1, z2)]
        cs = ps[0].sum((1, 2)) + ps[1].sum((1, 2))
        cs2 = (ps[0] * ps[0]).sum((1, 2)) + (ps[1] * ps[1]).sum((1, 2))
        carry = acc_add(carry, cs, cs2, plan.kahan)
    return acc_final(carry)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _cuda_partials(ops: Operands, seed, block_offset, plan, n_blocks):
    a = ops.n_assets
    for name, x, shape in (("k", ops.k, (1,)), ("lt", ops.lt, (a, a)),
                           ("par", ops.par, (3, a))):
        check_operand(name, x, shape, ops.device)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    lib = _build.library()
    with torch.cuda.device(ops.device):
        out = torch.empty((n_blocks, 2), dtype=torch.float32,
                          device=ops.device)
        common = (int(ops.use_min), wrap_int32(seed), wrap_int32(block_offset),
                  n_blocks, plan.rows, plan.iters, int(plan.antithetic),
                  int(plan.kahan), out.data_ptr(), _stream())
        ptrs = (ops.lt.data_ptr(), ops.par.data_ptr(), ops.k.data_ptr(), a)
        if use_asset_major(a):
            name = "rainbow_am"
            status = lib.mctpu_rainbow_am(*ptrs, *common)
        else:
            name = "rainbow_packed"
            a_tile, _, width = pack_factor(a)
            status = lib.mctpu_rainbow_packed(*ptrs, a_tile, width, *common)
    _build.check(status, name)
    LAUNCHES[name] += 1
    return out


def partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
             n_blocks: int) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K36 or K37 for CUDA operands,
    the plain version for CPU operands; any other device raises."""
    if ops.device.type == "cuda":
        return _cuda_partials(ops, seed, block_offset, plan, n_blocks)
    if ops.device.type == "cpu":
        return plain_partials(ops, seed, block_offset, plan, n_blocks)
    raise ValueError(f"unsupported device {ops.device}")


# ---------------------------------------------------------------------------
# K38: pathwise Greeks, asset-major
# ---------------------------------------------------------------------------
# With ext = op_i S_i, I = 1{ext > k} and P = (ext - k)^+ (mctpu's
# derivation): delta_i = I 1{argext = i} S_i / s0_i, vega_i = I 1{argext =
# i} S_i sqrt(t) (bt_i - v_i sqrt(t)), rho = t k I, theta = I S_ext
# (drift_ext + vol_ext bt_ext / 2) / t - r P.  Gamma is absent: the
# arg-extreme indicator has no sign-definite Stein tilt.

@dataclasses.dataclass(frozen=True)
class GreekOperands:
    """K38's float32 operands: ``scal`` ``(4,)`` = k, t, sqrt(t), r; K36's
    ``lt`` and ``par`` ``(3, a)``; ``inv_s0`` ``(a,)``."""

    scal: torch.Tensor
    lt: torch.Tensor
    par: torch.Tensor
    inv_s0: torch.Tensor
    use_min: bool

    @property
    def n_assets(self) -> int:
        return self.lt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.lt.device


def greek_operands(opt: RainbowOption, chol, device) -> GreekOperands:
    """K38's operands, formed on the CPU in ``greek_pallas_partials``'
    order (``inv_s0 = 1 / s0``, ``scal = [k, t, sqrt(t), r]``) and moved to
    ``device``."""
    a = opt.n_assets
    lt, par = rainbow_am_ops(opt, chol)
    inv_s0 = 1.0 / torch.broadcast_to(_f32(opt.s), (a,))
    k, t, r = f32(opt.k, opt.t, opt.r)
    scal = torch.stack([k, t, sqrt32(t), r])
    return GreekOperands(scal=scal.to(device), lt=lt.contiguous().to(device),
                         par=par.contiguous().to(device),
                         inv_s0=inv_s0.contiguous().to(device),
                         use_min=opt.kind == "min")


def _greek_quants(zs, ops: GreekOperands, antithetic: bool):
    """One path tile -> ``(p, [gd_i], [gv_i], ind, th)`` (pair-means under
    antithetic), as ``mctpu``'s ``_greek_quants``: ``gd_i`` is the raw
    argext-masked spot (the sums take ``1 / s0_i``)."""
    a = ops.n_assets
    k, t, sqt, r = ops.scal.unbind()
    par = ops.par

    def one(sgn):
        ss, bts = _am_spots(zs, ops.lt, par, a, sgn)
        ext, idx = _arg_extreme(ss, ops.use_min)
        ind = (ext > k).to(ext.dtype)
        p = torch.clamp(ext - k, min=0.0)
        gds, gvs = [], []
        th = None
        for i in range(a):
            gd = torch.where(idx == i, ind * ss[i], 0.0)
            gds.append(gd)
            gvs.append(gd * sqt * (bts[i] - par[1, i]))
            x = gd * (par[0, i] + 0.5 * par[1, i] * bts[i])
            th = x if th is None else th + x
        th = th * (1.0 / t) - r * p
        return p, gds, gvs, ind, th

    if not antithetic:
        return one(1.0)
    pa, pb = one(1.0), one(-1.0)
    mean = lambda x, y: 0.5 * (x + y)  # noqa: E731
    return (mean(pa[0], pb[0]),
            [mean(x, y) for x, y in zip(pa[1], pb[1])],
            [mean(x, y) for x, y in zip(pa[2], pb[2])],
            mean(pa[3], pb[3]), mean(pa[4], pb[4]))


def _greek_sums(zs_a, zs_b, ops: GreekOperands, antithetic: bool):
    """Both path tiles of one iteration -> the ``6 + 4a`` per-block sums,
    ``1 / s0_i`` and its square applied to each tile's delta sums."""
    k, t = ops.scal[0], ops.scal[1]
    tk = t * k
    sums = None
    for zs in (zs_a, zs_b):
        p, gds, gvs, ind, th = _greek_quants(zs, ops, antithetic)
        ri = tk * ind
        row = [p.sum(1), (p * p).sum(1), ri.sum(1), (ri * ri).sum(1),
               th.sum(1), (th * th).sum(1)]
        for i in range(ops.n_assets):
            inv = ops.inv_s0[i]
            row += [inv * gds[i].sum(1), inv * inv * (gds[i] * gds[i]).sum(1),
                    gvs[i].sum(1), (gvs[i] * gvs[i]).sum(1)]
        sums = row if sums is None else [s + x for s, x in zip(sums, row)]
    return sums


def greek_plain_partials(ops: GreekOperands, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int) -> torch.Tensor:
    """Per-block ``(n_blocks, 6 + 4a)`` partials in plain PyTorch over
    K36's stream."""
    dev = ops.device
    a = ops.n_assets
    key = block_keys(seed, [block_offset + b for b in range(n_blocks)], dev)
    idx = tile_index(plan.rows * LANES, dev)
    carry = acc_init_n(n_greek_sums(a), n_blocks, dev)
    for i in range(plan.iters):
        za, zb = [], []
        for p in range(a):
            z1, z2 = draw_normal_pair(key, idx, i * a + p)
            za.append(z1)
            zb.append(z2)
        carry = acc_add_n(carry, _greek_sums(za, zb, ops, plan.antithetic),
                          plan.kahan)
    return acc_final_n(carry)


def _check_greeks(ops: GreekOperands) -> None:
    a = ops.n_assets
    if not 1 <= a <= ASSET_MAJOR_MAX:
        raise ValueError(f"K38 takes 1..{ASSET_MAJOR_MAX} assets, got {a}")
    for name, x, shape in (("scal", ops.scal, (4,)), ("lt", ops.lt, (a, a)),
                           ("par", ops.par, (3, a)),
                           ("inv_s0", ops.inv_s0, (a,))):
        check_operand(name, x, shape, ops.device)


def greek_partials(ops: GreekOperands, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int) -> torch.Tensor:
    """``(n_blocks, 6 + 4a)`` partials: K38 for CUDA operands, the plain
    version for CPU operands; any other device raises."""
    _check_greeks(ops)
    if ops.device.type == "cpu":
        return greek_plain_partials(ops, seed, block_offset, plan, n_blocks)
    if ops.device.type != "cuda":
        raise ValueError(f"unsupported device {ops.device}")
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    a = ops.n_assets
    lib = _build.library()
    with torch.cuda.device(ops.device):
        out = torch.empty((n_blocks, n_greek_sums(a)), dtype=torch.float32,
                          device=ops.device)
        status = lib.mctpu_rainbow_greeks(
            ops.scal.data_ptr(), ops.lt.data_ptr(), ops.par.data_ptr(),
            ops.inv_s0.data_ptr(), a, int(ops.use_min), wrap_int32(seed),
            wrap_int32(block_offset), n_blocks, plan.rows, plan.iters,
            int(plan.antithetic), int(plan.kahan), out.data_ptr(), _stream())
    _build.check(status, "rainbow_greeks")
    LAUNCHES["rainbow_greeks"] += 1
    return out
