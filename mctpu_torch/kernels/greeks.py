"""K6, K7 and K8: in-kernel pathwise Greeks (``csrc/greeks.cu``).

Counterpart of :mod:`mctpu.kernels.greeks`.  Each kernel draws exactly the
paths of its pricing kernel, so its ``price`` equals the pricer's at the same
seed (common random numbers):

* K6 (vanilla, stream of K1): per tile element and iteration both
  Box-Muller branches; payoff plus the delta, vega, rho, theta, gamma, vanna
  and volga integrands (pathwise first order, mixed pathwise-likelihood-
  ratio second order), ``(sum, sum^2)`` of each: ``(B, 16)``;
* K7 (basket up to 8 assets, stream of K2): payoff, rho, theta and per-asset
  delta, vega and diagonal Stein-tilt gamma: ``(B, 6 + 6a)``;
* K8 (wider baskets, stream of K3): the same Greeks on the lane-packed
  tile: scalars ``(B, 6)`` and per-slot vectors ``(B, 6, width)`` whose
  ``c`` packed path groups the engine folds onto the assets.

The derivations are in :mod:`mctpu.kernels.greeks`.  Every operand is formed
in float32 on the CPU in the JAX expression order, so a kernel and its plain
version read identical bits.  :func:`partials` (vanilla), :func:`am_partials`
and :func:`packed_partials` launch the CUDA kernel for CUDA operands and run
the plain version for CPU operands.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mctpu_torch import _build
from mctpu_torch.kernels import basket as kbasket
from mctpu_torch.kernels.common import (LANES, Plan, acc_add_n, acc_final_n,
                                        acc_init_n, block_keys, check_operand,
                                        det_col_sums, draw_normal_pair,
                                        tile_index)
from mctpu_torch.kernels.vanilla import make_plan  # K6 runs K1's plan
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import BasketOption, VanillaOption

__all__ = ["N_SUMS", "make_plan", "params", "plain_partials", "partials",
           "tilt_direction", "AmOperands", "am_operands", "am_plain_partials",
           "am_partials", "PackedOperands", "packed_operands",
           "packed_plain_partials", "packed_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"greeks_vanilla": 0, "greeks_basket_am": 0,
            "greeks_basket_packed": 0}

N_SUMS = 16  # (sum, sum^2) of: payoff, delta, vega, rho, theta, gamma,
#              vanna, volga


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------------------- K6 vanilla

def params(opt: VanillaOption, device) -> torch.Tensor:
    """``[s, k, r, v, t, mu, sig, sqt]`` in float32, formed on the CPU in
    the JAX kernel's order (``sqt = sqrt(t)``, ``mu = (r - 0.5 v v) t``,
    ``sig = v sqt``), then moved to ``device``."""
    s, k, r, v, t = (_f32(x) for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
    sqt = torch.sqrt(t)
    mu = (r - 0.5 * v * v) * t
    sig = v * sqt
    return torch.stack([s, k, r, v, t, mu, sig, sqt]).to(device)


def _greek_tile(par, z, antithetic: bool, put: bool):
    """Payoff and the 7 Greek integrands of one tile of normals
    (pair-means under antithetic), as ``mctpu``'s ``_greek_tile``."""
    s0, k, r, v, t, mu, sig, sqt = par.unbind()
    cg = k / (s0 * s0 * sig)
    cvn = k / (s0 * sig)
    cvg = k / sig
    inv_s0 = 1.0 / s0

    def quants(zz):
        st = s0 * torch.exp(mu + sig * zz)
        if put:
            ind = -(st < k).to(st.dtype)
            p = torch.clamp(k - st, min=0.0)
        else:
            ind = (st > k).to(st.dtype)
            p = torch.clamp(st - k, min=0.0)
        w = ind * st
        gd = w * inv_s0
        wv = sqt * zz - v * t
        gv = w * wv
        gr = (t * k) * ind
        gt = w * (r - 0.5 * v * v + 0.5 * v * zz / sqt) - r * p
        gg = cg * (ind * zz)
        gvn = gd * wv + cvn * (ind * (wv * zz - sqt))
        gvg = w * (wv * wv - t) + cvg * (ind * (wv * (wv * zz - 2.0 * sqt)))
        return (p, gd, gv, gr, gt, gg, gvn, gvg)

    if antithetic:
        return tuple(0.5 * (x + y) for x, y in zip(quants(z), quants(-z)))
    return quants(z)


def _tile_sums(tiles):
    out = []
    for q in tiles:
        out += [q.sum(1), (q * q).sum(1)]
    return out


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, put: bool) -> torch.Tensor:
    """Per-block ``(n_blocks, 16)`` partials in plain PyTorch on ``par``'s
    device, over K1's stream."""
    dev = par.device
    key = block_keys(seed, [block_offset + b for b in range(n_blocks)], dev)
    idx = tile_index(plan.rows * LANES, dev)
    carry = acc_init_n(N_SUMS, n_blocks, dev)
    for i in range(plan.iters):
        z1, z2 = draw_normal_pair(key, idx, i)
        s1 = _tile_sums(_greek_tile(par, z1, plan.antithetic, put))
        s2 = _tile_sums(_greek_tile(par, z2, plan.antithetic, put))
        carry = acc_add_n(carry, [a + b for a, b in zip(s1, s2)], plan.kahan)
    return acc_final_n(carry)


def _cuda_partials(par, seed, block_offset, plan, n_blocks, put):
    check_operand("par", par, (8,), par.device)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    lib = _build.library()
    with torch.cuda.device(par.device):
        out = torch.empty((n_blocks, N_SUMS), dtype=torch.float32,
                          device=par.device)
        status = lib.mctpu_greeks_vanilla(
            par.data_ptr(), wrap_int32(seed), wrap_int32(block_offset),
            n_blocks, plan.rows, plan.iters, int(plan.antithetic), int(put),
            int(plan.kahan), out.data_ptr(), _stream())
    _build.check(status, "greeks_vanilla")
    LAUNCHES["greeks_vanilla"] += 1
    return out


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, put: bool) -> torch.Tensor:
    """Per-block ``(n_blocks, 16)`` partials: K6 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises."""
    if par.device.type == "cuda":
        return _cuda_partials(par, seed, block_offset, plan, n_blocks, put)
    if par.device.type == "cpu":
        return plain_partials(par, seed, block_offset, plan, n_blocks, put)
    raise ValueError(f"unsupported device {par.device}")


# ------------------------------------------------------- basket: the tilt

def tilt_direction(chol):
    """``(evec, gvec, ok)``, float64 NumPy: the z-space Stein tilt ``e``
    and its per-asset effect ``g = L e`` for the diagonal basket gamma,
    from the float64 factor ``L`` that :func:`mctpu_torch.math.
    cholesky_lower` gives the correlation (``mctpu.kernels.greeks.
    tilt_direction``, which factorizes it itself).  A full-rank correlation
    gives ``e = L^-1 1`` and ``g == 1``; a rank-deficient one without a
    sign-definite ``g`` gives ``ok = False`` (no gamma)."""
    import scipy.linalg as sla

    ll = np.asarray(chol, np.float64)
    a = ll.shape[0]
    ones = np.ones((a,))
    if np.diag(ll).min() > 1e-6:
        e = sla.solve_triangular(ll, ones, lower=True)
        return e, ones, True
    e, *_ = np.linalg.lstsq(ll, ones, rcond=None)
    g = ll @ e
    if g.min() > 0.05:
        return e, g, True
    return np.zeros((a,)), ones, False


def _basket_scal(opt: BasketOption) -> torch.Tensor:
    """``[k, t, sqrt(t), r]`` in float32."""
    t = _f32(opt.t)
    return torch.stack([_f32(opt.k), t, torch.sqrt(t), _f32(opt.r)])


# ------------------------------------------------- K7 basket, asset-major

@dataclasses.dataclass(frozen=True)
class AmOperands:
    """K7's float32 operands: ``scal`` ``(4,)`` = k, t, sqrt(t), r; ``lt``
    ``(a, a)``; ``par`` ``(4, a)`` = drift, vol, d, w*s0 (K2's rows);
    ``vec`` ``(3, a)`` = 1/s0, tilt e, tilt g."""

    scal: torch.Tensor
    lt: torch.Tensor
    par: torch.Tensor
    vec: torch.Tensor

    @property
    def n_assets(self) -> int:
        return self.lt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.lt.device


def am_operands(opt: BasketOption, chol, tilt, device) -> AmOperands:
    """K7's operands, formed on the CPU in ``pallas_basket_am_partials``'
    order and moved to ``device``."""
    a = opt.n_assets
    lt, par = kbasket.asset_major_ops(opt, chol)
    inv_s0 = 1.0 / torch.broadcast_to(_f32(opt.s), (a,))
    vec = torch.stack([inv_s0, _f32(tilt[0]), _f32(tilt[1])])
    return AmOperands(scal=_basket_scal(opt).to(device),
                      lt=lt.contiguous().to(device),
                      par=par.contiguous().to(device),
                      vec=vec.contiguous().to(device))


def _am_greek_quants(zs, ops: AmOperands, antithetic: bool):
    """One path tile -> ``(p, [gd_i], [gv_i], [gg_i], ind, th)``
    (pair-means under antithetic), as ``mctpu``'s ``_am_greek_quants``."""
    a = ops.n_assets
    k, t, sqt, r = ops.scal.unbind()
    lt, par = ops.lt, ops.par
    evec, gvec = ops.vec[1], ops.vec[2]

    def one(sgn):
        terms, btds = [], []
        basket = zu = None
        for i in range(a):
            bt = None
            for j in range(i + 1):
                x = lt[i, j] * zs[j]
                bt = x if bt is None else bt + x
            btd = sgn * bt + par[2, i]
            term = par[3, i] * torch.exp(par[0, i] + par[1, i] * btd)
            terms.append(term)
            btds.append(btd)
            basket = term if basket is None else basket + term
            x = evec[i] * (sgn * zs[i])
            zu = x if zu is None else zu + x
        ind = (basket > k).to(basket.dtype)
        p = torch.clamp(basket - k, min=0.0)
        gds = [ind * terms[i] for i in range(a)]
        gvs = [gds[i] * (sqt * btds[i] - (par[1, i] / sqt) * t)
               for i in range(a)]
        th = bu = bu2 = None
        for i in range(a):
            x = gds[i] * (par[0, i] + 0.5 * par[1, i] * btds[i])
            th = x if th is None else th + x
            vg = par[1, i] * gvec[i]
            y = terms[i] * vg
            bu = y if bu is None else bu + y
            y2 = y * vg
            bu2 = y2 if bu2 is None else bu2 + y2
        th = th * (1.0 / t) - r * p
        inv_bu = 1.0 / bu
        path_term = (zu + bu2 * inv_bu) * inv_bu
        ggs = [gds[i] * terms[i]
               * (path_term - (2.0 * par[1, i] * gvec[i]) * inv_bu)
               for i in range(a)]
        return p, gds, gvs, ggs, ind, th

    if not antithetic:
        return one(1.0)
    pa, pb = one(1.0), one(-1.0)
    mean = lambda x, y: 0.5 * (x + y)  # noqa: E731
    return (mean(pa[0], pb[0]),
            [mean(x, y) for x, y in zip(pa[1], pb[1])],
            [mean(x, y) for x, y in zip(pa[2], pb[2])],
            [mean(x, y) for x, y in zip(pa[3], pb[3])],
            mean(pa[4], pb[4]), mean(pa[5], pb[5]))


def _am_greek_sums(zs_a, zs_b, ops: AmOperands, antithetic: bool):
    """Both path tiles of one iteration -> ``6 + 6a`` per-block sums."""
    k, t = ops.scal[0], ops.scal[1]
    inv_s0 = ops.vec[0]
    tk = t * k
    sums = None
    for zs in (zs_a, zs_b):
        p, gds, gvs, ggs, ind, th = _am_greek_quants(zs, ops, antithetic)
        ri = tk * ind
        row = [p.sum(1), (p * p).sum(1), ri.sum(1), (ri * ri).sum(1),
               th.sum(1), (th * th).sum(1)]
        for i in range(ops.n_assets):
            inv = inv_s0[i]
            inv2 = inv * inv
            row += [inv * gds[i].sum(1), inv * inv * (gds[i] * gds[i]).sum(1),
                    gvs[i].sum(1), (gvs[i] * gvs[i]).sum(1),
                    inv2 * ggs[i].sum(1),
                    inv2 * inv2 * (ggs[i] * ggs[i]).sum(1)]
        sums = row if sums is None else [s + x for s, x in zip(sums, row)]
    return sums


def am_plain_partials(ops: AmOperands, seed: int, block_offset: int,
                      plan: Plan, n_blocks: int) -> torch.Tensor:
    """Per-block ``(n_blocks, 6 + 6a)`` partials (price, rho, theta pairs,
    then per asset delta, vega, gamma pairs) in plain PyTorch, over K2's
    stream."""
    dev = ops.device
    a = ops.n_assets
    key = block_keys(seed, [block_offset + b for b in range(n_blocks)], dev)
    idx = tile_index(plan.rows * LANES, dev)
    carry = acc_init_n(6 + 6 * a, n_blocks, dev)
    for i in range(plan.iters):
        za, zb = [], []
        for p in range(a):
            z1, z2 = draw_normal_pair(key, idx, i * a + p)
            za.append(z1)
            zb.append(z2)
        carry = acc_add_n(carry, _am_greek_sums(za, zb, ops, plan.antithetic),
                          plan.kahan)
    return acc_final_n(carry)


def _am_cuda_partials(ops: AmOperands, seed, block_offset, plan, n_blocks):
    a = ops.n_assets
    if not 1 <= a <= kbasket.ASSET_MAJOR_MAX:
        raise ValueError(f"K7 takes 1..{kbasket.ASSET_MAJOR_MAX} assets")
    for name, x, shape in (("scal", ops.scal, (4,)), ("lt", ops.lt, (a, a)),
                           ("par", ops.par, (4, a)),
                           ("vec", ops.vec, (3, a))):
        check_operand(name, x, shape, ops.device)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    lib = _build.library()
    with torch.cuda.device(ops.device):
        out = torch.empty((n_blocks, 6 + 6 * a), dtype=torch.float32,
                          device=ops.device)
        status = lib.mctpu_greeks_basket_am(
            ops.scal.data_ptr(), ops.lt.data_ptr(), ops.par.data_ptr(),
            ops.vec.data_ptr(), a, wrap_int32(seed), wrap_int32(block_offset),
            n_blocks, plan.rows, plan.iters, int(plan.antithetic),
            int(plan.kahan), out.data_ptr(), _stream())
    _build.check(status, "greeks_basket_am")
    LAUNCHES["greeks_basket_am"] += 1
    return out


def am_partials(ops: AmOperands, seed: int, block_offset: int, plan: Plan,
                n_blocks: int) -> torch.Tensor:
    """``(n_blocks, 6 + 6a)`` partials: K7 for CUDA operands, the plain
    version for CPU operands; any other device raises."""
    if ops.device.type == "cuda":
        return _am_cuda_partials(ops, seed, block_offset, plan, n_blocks)
    if ops.device.type == "cpu":
        return am_plain_partials(ops, seed, block_offset, plan, n_blocks)
    raise ValueError(f"unsupported device {ops.device}")


# ------------------------------------------------------ K8 basket, packed

# Rows of PackedOperands.rows, one value per lane slot of the packed tile.
ROWS = ("s0", "drift", "vol", "d", "w", "inv_s0", "vg", "wv", "wv2", "e",
        "v_row")


@dataclasses.dataclass(frozen=True)
class PackedOperands:
    """K8's float32 operands: ``scal`` ``(4,)`` = k, t, sqrt(t), r; the
    compact Cholesky factor ``lt`` ``(a, a)``; ``rows`` ``(11, width)``,
    per lane slot (:data:`ROWS`): s0, drift, vol, d, w, 1/s0, vg = vol g,
    w vg, w vg^2, tilt e, vol/sqrt(t).  Padded slots hold s0 = w = 1/s0 =
    vol = 0."""

    scal: torch.Tensor
    lt: torch.Tensor
    rows: torch.Tensor

    @property
    def n_assets(self) -> int:
        return self.lt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.lt.device


def packed_operands(opt: BasketOption, chol, tilt, device) -> PackedOperands:
    """K8's operands, formed on the CPU in ``_basket_greek_ops``' order
    (``pack_assets`` rows, ``vg = vol g``, ``wv = w vg``, ``wv2 = wv vg``,
    ``v_row = vol / sqrt(t)``) and moved to ``device``."""
    a = opt.n_assets
    a_tile, c, width = kbasket.pack_factor(a)

    def tile_row(x):
        row = torch.zeros(a_tile, dtype=torch.float32)
        row[:a] = torch.broadcast_to(_f32(x), (a,))
        return row.repeat(c)

    scal = _basket_scal(opt)
    r, t, sqt = scal[3], scal[1], scal[2]
    s0 = tile_row(opt.s)
    v = tile_row(opt.v)
    drift = (r - 0.5 * v * v) * t
    vol = v * torch.sqrt(t)
    w = tile_row(opt.w)
    inv_s0 = torch.where(s0 > 0, 1.0 / torch.where(s0 > 0, s0, 1.0), 0.0)
    vg = vol * tile_row(tilt[1])
    wv = w * vg
    rows = torch.stack([s0, drift, vol, tile_row(opt.d), w, inv_s0, vg, wv,
                        wv * vg, tile_row(tilt[0]), vol / sqt])
    return PackedOperands(scal=scal.to(device),
                          lt=_f32(chol).contiguous().to(device),
                          rows=rows.contiguous().to(device))


def _packed_greek_tile(ops: PackedOperands, z, antithetic: bool):
    """One packed tile ``z (B, rows, c, a_tile)`` -> ``(p, gd, gv, gg, ind,
    th)``: per path ``(B, rows, c)`` and per slot ``(B, rows, c, a_tile)``
    (pair-means under antithetic).  The TPU's fold and expand matrices are
    sums over a path's slots and broadcasts back onto them."""
    a = ops.n_assets
    a_tile = z.shape[-1]
    k, t, sqt, r = ops.scal.unbind()
    s0, drift, vol, d, w, inv_s0, vg, wv, wv2, e, v_row = (
        x.view(-1, a_tile) for x in ops.rows)
    lpad = torch.zeros((a_tile, a_tile), dtype=z.dtype, device=z.device)
    lpad[:a, :a] = ops.lt
    inv_t = 1.0 / t

    def quants(zz):
        bt = torch.matmul(zz, lpad.T) + d
        s_t = s0 * torch.exp(drift + vol * bt)
        basket = (s_t * w).sum(-1)
        ind = (basket > k).to(s_t.dtype)
        p = torch.clamp(basket - k, min=0.0)
        ind_wide = ind.unsqueeze(-1)
        ws = ind_wide * w * s_t
        gd = ws * inv_s0
        gv = ws * (sqt * bt - v_row * t)
        ths = ws * ((drift + 0.5 * vol * bt) * inv_t)
        th = ths.sum(-1) - r * p
        zu = (zz * e).sum(-1)
        bu = (s_t * wv).sum(-1)
        bu2 = (s_t * wv2).sum(-1)
        inv_bu = 1.0 / bu
        path_term = ((zu + bu2 * inv_bu) * inv_bu).unsqueeze(-1)
        wss = ws * (w * s_t)
        gg = (wss * (inv_s0 * inv_s0)
              * (path_term - (2.0 * vg) * inv_bu.unsqueeze(-1)))
        return p, gd, gv, gg, ind, th

    if antithetic:
        return tuple(0.5 * (x + y) for x, y in zip(quants(z), quants(-z)))
    return quants(z)


def packed_plain_partials(ops: PackedOperands, seed: int, block_offset: int,
                          plan: Plan, n_blocks: int):
    """``((n_blocks, 6), (n_blocks, 6, width))`` in plain PyTorch over K3's
    stream: Kahan-carried price, rho and theta pairs, and per lane slot the
    plain-summed delta, vega and gamma pairs, each tile's column sums taken
    by the fixed halving tree of ``det_col_sums``."""
    dev = ops.device
    a_tile, c, width = kbasket.pack_factor(ops.n_assets)
    k, t = ops.scal[0], ops.scal[1]
    tk = t * k
    key = block_keys(seed, [block_offset + b for b in range(n_blocks)], dev)
    idx = tile_index(plan.rows * width, dev)
    carry = acc_init_n(6, n_blocks, dev)
    vecs = torch.zeros((n_blocks, 6, width), dtype=torch.float32, device=dev)

    def col(x):  # (B, rows, c, a_tile) -> (B, width)
        return det_col_sums(x.reshape(n_blocks, plan.rows, width), 1)

    for i in range(plan.iters):
        z1, z2 = draw_normal_pair(key, idx, i)
        tiles = [_packed_greek_tile(
            ops, z.view(n_blocks, plan.rows, c, a_tile), plan.antithetic)
            for z in (z1, z2)]
        scal, vec = [], []
        for p, gd, gv, gg, ind, th in tiles:
            ri = tk * ind
            scal.append([q.sum((1, 2)) for q in (p, p * p, ri, ri * ri, th,
                                                 th * th)])
            vec.append(torch.stack([col(q) for q in (gd, gd * gd, gv, gv * gv,
                                                     gg, gg * gg)], dim=1))
        carry = acc_add_n(carry, [x + y for x, y in zip(*scal)], plan.kahan)
        vecs = vecs + (vec[0] + vec[1])
    return acc_final_n(carry), vecs


def _packed_cuda_partials(ops: PackedOperands, seed, block_offset, plan,
                          n_blocks, scratch_cap):
    a = ops.n_assets
    a_tile, _, width = kbasket.pack_factor(a)
    for name, x, shape in (("scal", ops.scal, (4,)), ("lt", ops.lt, (a, a)),
                           ("rows", ops.rows, (len(ROWS), width))):
        check_operand(name, x, shape, ops.device)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    lib = _build.library()
    shape = (n_blocks, plan.rows, plan.iters, int(plan.antithetic))
    n_scratch = lib.mctpu_greeks_basket_packed_scratch_floats(
        a, a_tile, width, *shape, scratch_cap)
    if n_scratch < 1:
        raise ValueError(f"K8 takes no basket of width {width}: its fixed "
                         "tables and one row exceed shared memory")
    with torch.cuda.device(ops.device):
        out = torch.empty((n_blocks, 6), dtype=torch.float32,
                          device=ops.device)
        vecs = torch.empty((n_blocks, 6, width), dtype=torch.float32,
                           device=ops.device)
        scratch = torch.empty(n_scratch, dtype=torch.float32,
                              device=ops.device)
        status = lib.mctpu_greeks_basket_packed(
            ops.scal.data_ptr(), ops.lt.data_ptr(), ops.rows.data_ptr(), a,
            a_tile, width, wrap_int32(seed), wrap_int32(block_offset),
            *shape, int(plan.kahan), scratch_cap,
            scratch.data_ptr(), out.data_ptr(), vecs.data_ptr(), _stream())
    _build.check(status, "greeks_basket_packed")
    LAUNCHES["greeks_basket_packed"] += 1
    return out, vecs


def packed_partials(ops: PackedOperands, seed: int, block_offset: int,
                    plan: Plan, n_blocks: int, scratch_cap: int = 0):
    """``((n_blocks, 6), (n_blocks, 6, width))`` partials: K8 for CUDA
    operands, the plain version for CPU operands; other devices raise.
    ``scratch_cap``: K8's scratch in floats at most (0: 256 MB), past which
    it splits and folds simulation blocks and iterations in groups; the
    outputs do not depend on it."""
    if ops.device.type == "cuda":
        return _packed_cuda_partials(ops, seed, block_offset, plan, n_blocks,
                                     scratch_cap)
    if ops.device.type == "cpu":
        return packed_plain_partials(ops, seed, block_offset, plan, n_blocks)
    raise ValueError(f"unsupported device {ops.device}")
