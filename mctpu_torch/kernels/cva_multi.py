"""K39-K44: the netting-set CVA over correlated underlyings, its Greeks and
the bilateral xVA with its Greeks (``csrc/cva_multi.cu``).

Counterpart of :mod:`mctpu.kernels.cva_multi`.  Option ``m`` is a call on
underlying ``m``; the underlyings walk correlated GBMs in log space over
``n_grid`` exposure nodes, and at node ``j`` every path reprices each leg
with the Hastings-CDF Black-Scholes formula over the remaining maturity
``tau_j`` (its intrinsic value at the last node), nets the signed position
values ``sum_m w_m BS_m`` and feeds the positive part ``ee_j`` to the
default leg ``lgd sum_j dp_j ee_j`` and to the expected-exposure profile.
The two stream maps are ``mctpu``'s:

* up to ``ASSET_MAJOR_MAX`` underlyings, asset-major (K40, K42): every
  element of a ``(rows, 128)`` tile is a path, its ``m`` normals of a node
  from :func:`walk_pairwise_multi` (pair ``jj`` draws counter ``jj * m +
  i``); ``bt_i = sum_{j <= i} L_ij z_j`` from the first product, and each
  leg prices in ``_am_quants``' form, ``d1 = (x - log k + (r + v^2/2)
  tau) / (v sqrt(tau))`` with the division as a multiply by ``1 / sq``;
* wider sets, lane-packed (K39, K41): a ``(rows, width)`` tile whose row
  packs ``c`` paths of ``a_tile`` lanes (``pack_factor``), one pair per
  lane per two nodes (:func:`walk_pairwise`); ``bt = z L^T`` formed from
  0.  K39 prices each leg through ``bs_call_hastings``' ``log(s / k)``
  form, K41 (as ``mctpu``'s ``_greek_node``) in ``_am_quants``'.  The
  forms round differently and each kernel keeps its own.

K42 adds to K40's node the per-underlying vol tangent ``dxv_i += sqrt(dt)
bt_i - v_i dt``, the shared exercise indicator ``net > 0`` and the
pathwise delta and vega integrands (``mctpu``'s ``_am_greek_step``), and
the credit delta through ``d(dp_j)/dlambda``; K41 carries the same on each
packed lane.  K40 and K42 share the node function and the block
reduction, so a Greeks CVA equals the pricer's bit for bit on the same
plan.  The bilateral xVA (K43, K44) runs K40's asset-major walk at every
set size: the negative part of the net feeds the DVA and funding-benefit
legs (see the xVA section below).

Every table is formed on the CPU in float32 in ``mctpu``'s expression order
and moved to the device; the kernels build with ``-fmad=false`` so the
exercise indicator and the netting's sign fall alike in a kernel and its
plain version, which forms ``L z`` as separate multiplies and adds.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mctpu_torch import _build
from mctpu_torch import math as mcmath
from mctpu_torch.kernels.basket import pack_factor, use_asset_major
from mctpu_torch.kernels.common import (LANES, N_GREEK_SCALARS, Plan,
                                        acc_add_n, acc_final_n, acc_init_n,
                                        check_operand, f32, iter_keys,
                                        packed_vec_partials, split_vec,
                                        sqrt32, tile_index,
                                        vec_greek_partials, walk_pairwise,
                                        walk_pairwise_multi)
from mctpu_torch.kernels.cva import credit_delta_weights
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import CvaMultiSpec, XvaSpec

__all__ = ["make_plan", "pack_spec", "am_ops", "packed_ops", "greek_tables",
           "Operands", "operands", "plain_partials", "partials",
           "greek_plain_partials", "greek_partials", "N_GREEK_SCALARS",
           "xva_tables", "xva_greek_tables", "xva_operands",
           "xva_plain_partials", "xva_partials", "xva_greek_plain_partials",
           "xva_greek_partials", "N_XVA_SUMS", "N_XVA_GREEK_SCALARS",
           "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name: K40, K39,
# K42, K41, K43 (up to 8 underlyings and the runtime-m kernel), K44 (the
# same).
LAUNCHES = {"cva_multi_am": 0, "cva_multi_packed": 0,
            "cva_multi_greeks_am": 0, "cva_multi_greeks_packed": 0,
            "xva_am": 0, "xva_wide": 0, "xva_greeks_am": 0,
            "xva_greeks_wide": 0}


def make_plan(n_paths: int, num_blocks: int, rows: int, antithetic: bool,
              kahan: bool = True, n_underlyings: int = 2) -> Plan:
    """``rows * 128`` units per (block, iteration) asset-major, ``rows *
    c`` packed (``mctpu``'s ``make_plan``; K42 runs K40's)."""
    if use_asset_major(n_underlyings):
        units = rows * LANES
    else:
        units = rows * pack_factor(n_underlyings)[1]
    paths = units * (2 if antithetic else 1)
    return Plan.plan(n_paths, num_blocks, rows, paths, units, antithetic,
                     kahan)


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32)


def _per_leg(spec: CvaMultiSpec, x) -> torch.Tensor:
    return torch.broadcast_to(_f32(x), (spec.n_underlyings,))


def pack_spec(spec: CvaMultiSpec) -> dict:
    """``mctpu``'s ``pack_spec`` rows ``(1, width)`` in float32: ``s0``,
    ``k``, ``w``, ``v``, ``drift = (r - 0.5 v v) dt``, ``vol = v
    sqrt(dt)``; each path's ``a_tile`` lanes hold its ``m`` legs, padded
    with ``v = 1``, ``s0 = 1``, ``k = 1`` (the Black-Scholes terms stay
    finite) and ``w = 0`` (they net to 0)."""
    m = spec.n_underlyings
    a_tile, c, width = pack_factor(m)

    def tile_row(x, fill):
        row = torch.full((a_tile,), fill, dtype=torch.float32)
        row[:m] = _per_leg(spec, x)
        return row.repeat(c).reshape(1, width)

    (dt,) = f32(spec.t)
    dt = dt / spec.n_grid
    (r,) = f32(spec.r)
    v = tile_row(spec.v, 1.0)
    return {"s0": tile_row(spec.s, 1.0), "k": tile_row(spec.strikes, 1.0),
            "w": tile_row(spec.weights, 0.0), "v": v,
            "drift": (r - 0.5 * v * v) * dt, "vol": v * sqrt32(dt)}


def packed_ops(spec: CvaMultiSpec, chol):
    """K39's ``(lt, par)``: the float32 lower Cholesky factor ``(m, m)``
    and the real lanes of :func:`pack_spec`'s rows with the two the TPU
    kernel forms per element, ``par (7, m)`` = ``log s0``, drift, vol, k,
    w, v and ``r + 0.5 v v``."""
    m = spec.n_underlyings
    ops = pack_spec(spec)
    s0, drift, vol, k, w, v = (ops[n][0, :m] for n in
                               ("s0", "drift", "vol", "k", "w", "v"))
    (r,) = f32(spec.r)
    return _f32(chol), torch.stack([torch.log(s0), drift, vol, k, w, v,
                                    r + 0.5 * v * v])


def am_ops(spec: CvaMultiSpec, chol):
    """K40's and K42's ``(lt, par)``: ``par (9, m)`` = ``mctpu``'s
    ``_am_ops`` rows, ``log s0``, ``drift dt``, ``v sqrt(dt)``, ``v dt``,
    ``w``, ``k``, ``log k``, ``v^2 / 2``, ``v``."""
    (t, r) = f32(spec.t, spec.r)
    dt = t / spec.n_grid
    v, s0, k, w = (_per_leg(spec, x) for x in
                   (spec.v, spec.s, spec.strikes, spec.weights))
    par = torch.stack([torch.log(s0), (r - 0.5 * v * v) * dt,
                       v * sqrt32(dt), v * dt, w, k, torch.log(k),
                       0.5 * v * v, v])
    return _f32(chol), par


def greek_tables(spec: CvaMultiSpec) -> torch.Tensor:
    """``(5, n_grid)`` float32 node tables, ``mctpu``'s ``greek_tables``:
    ``dp``, ``d(dp)/dlambda`` (:func:`credit_delta_weights`, which reads
    only ``intensity``, ``t`` and ``n_grid``), ``tau = t (g - j) / g``,
    ``sqrt(tau)`` and ``disc = exp(-r tau)``."""
    g = spec.n_grid
    (t, r) = f32(spec.t, spec.r)
    dp = mcmath.default_leg_weights(spec.intensity, spec.t, g,
                                    dtype=torch.float32)
    j = torch.arange(1, g + 1, dtype=torch.float32)
    tau = t * (g - j) / g
    return torch.stack([dp, credit_delta_weights(spec), tau,
                        torch.sqrt(tau.double()).float(),
                        torch.exp(-r * tau)])


@dataclasses.dataclass(frozen=True)
class Operands:
    """A netting set's float32 operands: ``scal (3,)`` = r, lgd,
    ``sqrt(dt)``; the lower Cholesky factor ``lt (m, m)``; the per-leg rows
    ``par``, :func:`am_ops`' ``(9, m)`` up to 8 underlyings and
    :func:`packed_ops`' ``(7, m)`` beyond; the node tables ``nodes (5,
    n_grid)`` (:func:`greek_tables`)."""

    scal: torch.Tensor
    lt: torch.Tensor
    par: torch.Tensor
    nodes: torch.Tensor

    @property
    def n_underlyings(self) -> int:
        return self.lt.shape[0]

    @property
    def n_grid(self) -> int:
        return self.nodes.shape[1]

    @property
    def device(self) -> torch.device:
        return self.lt.device


def operands(spec: CvaMultiSpec, chol, device,
             greeks: bool = False) -> Operands:
    """The operands of ``spec`` with lower Cholesky factor ``chol``, formed
    on the CPU and moved to ``device``: the pricers' (K40's :func:`am_ops`
    rows up to 8 underlyings, K39's :func:`packed_ops` beyond), or with
    ``greeks`` the Greek kernels' (K42 and K41), :func:`am_ops`' rows at
    every size.  The real lanes of ``mctpu``'s ``greek_ops`` (``pack_spec``'s
    rows with ``logk``, ``v2half`` and ``vdt``) are those rows bit for bit,
    so the packed K41 reads them as K42 does."""
    m = spec.n_underlyings
    build = am_ops if greeks or use_asset_major(m) else packed_ops
    lt, par = build(spec, chol)
    (t, r, lgd) = f32(spec.t, spec.r, spec.lgd)
    scal = torch.stack([r, lgd, sqrt32(t / spec.n_grid)])
    return Operands(*(x.contiguous().to(device) for x in
                      (scal, lt, par, greek_tables(spec))))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _am_node(zs, xs, lt, par, r, tau, sqtau, disc, greeks: bool):
    """One asset-major node (``mctpu``'s ``_am_quants`` and ``_am_net``):
    ``(xs, bts, ss, nd1s, phis, net)``, the Greek factors only when
    ``greeks``.  At the last node (``tau <= 0``) each leg is its intrinsic
    value, its delta factor the in-the-money indicator, its density 0."""
    m = lt.shape[0]
    last = bool(tau <= 0.0)
    tau_safe = torch.clamp(tau, min=1e-12)
    sq_floor = torch.clamp(sqtau, min=1e-6)
    new_xs, bts, ss, nd1s, phis = [], [], [], [], []
    net = None
    for i in range(m):
        bt = None
        for j in range(i + 1):
            zc = lt[i, j] * zs[j]
            bt = zc if bt is None else bt + zc
        x = xs[i] + par[1, i] + par[2, i] * bt
        s = torch.exp(x)
        k = par[5, i]
        if last:
            val = par[4, i] * torch.clamp(s - k, min=0.0)
            nd1 = (s > k).to(s.dtype)
            phi = torch.zeros_like(s)
        else:
            sq = par[8, i] * sq_floor
            d1 = (x - par[6, i] + (r + par[7, i]) * tau_safe) * (1.0 / sq)
            nd1 = mcmath.norm_cdf_hastings(d1)
            bs = s * nd1 - k * disc * mcmath.norm_cdf_hastings(d1 - sq)
            val = par[4, i] * bs
            if greeks:
                phi = 0.3989422804014327 * torch.exp(-0.5 * d1 * d1)
        net = val if net is None else net + val
        new_xs.append(x)
        bts.append(bt)
        ss.append(s)
        if greeks:
            nd1s.append(nd1)
            phis.append(phi)
    return new_xs, bts, ss, nd1s, phis, net


def _add_profile(prof, comp, j: int, total):
    """``mctpu``'s compensated profile add of one node's ``total``."""
    y = total - comp[:, j]
    t = prof[:, j] + y
    comp[:, j] = (t - prof[:, j]) - y
    prof[:, j] = t


def _am_walk(ops: Operands, key, idx, shape, sgn, hook):
    """One asset-major pricing walk -> its ``lgd sum_j dp_j ee_j`` tile;
    ``hook(j, ee)`` takes each node's exposure tile."""
    m = ops.n_underlyings
    r, lgd, _ = ops.scal.unbind()
    dp, _, tau, sqtau, disc = ops.nodes

    def step(j, zs, carry):
        xs, acc = carry
        xs, _, _, _, _, net = _am_node([sgn * z for z in zs], xs, ops.lt,
                                       ops.par, r, tau[j], sqtau[j], disc[j],
                                       False)
        ee = torch.clamp(net, min=0.0)
        hook(j, ee)
        return xs, acc + dp[j] * ee

    init = ([ops.par[0, i].expand(shape) for i in range(m)],
            torch.zeros(shape, dtype=torch.float32, device=ops.device))
    _, acc = walk_pairwise_multi(key, idx, m, ops.n_grid, step, init)
    return lgd * acc


def _packed_walk(ops: Operands, key, idx, shape, sgn, hook):
    """One packed pricing walk over the ``(B, rows * width)`` draw tile ->
    its default legs ``(B, rows * c)``.  ``L z`` is formed column by
    column from 0; each leg prices as ``bs_call_hastings`` (``log(s / k)``,
    a true division by ``v sqrt(tau)``); the net sums the path's real
    lanes from 0 (padding has ``w = 0``)."""
    m = ops.n_underlyings
    a_tile, c, width = pack_factor(m)
    r, lgd, _ = ops.scal.unbind()
    dp, _, tau, sqtau, disc = ops.nodes
    log_s0, drift, vol, k, w, v, cr = ops.par
    n_blocks, rows = shape[0], shape[1] // width

    def step(j, z, carry):
        x, acc = carry
        zp = (sgn * z).view(n_blocks, rows, c, a_tile)[..., :m]
        bt = torch.zeros_like(x)
        for jj in range(m):
            bt = bt + ops.lt[:, jj] * zp[..., jj:jj + 1]
        x = x + drift + vol * bt
        s = torch.exp(x)
        if bool(tau[j] <= 0.0):
            val = w * torch.clamp(s - k, min=0.0)
        else:
            sq = v * sqtau[j]
            d1 = (torch.log(s / k) + cr * tau[j]) / sq
            cdf = mcmath.norm_cdf_hastings
            val = w * (s * cdf(d1) - k * disc[j] * cdf(d1 - sq))
        net = torch.zeros_like(val[..., 0])
        for i in range(m):
            net = net + val[..., i]
        ee = torch.clamp(net, min=0.0)
        hook(j, ee)
        return x, acc + dp[j] * ee

    init = (log_s0.expand(n_blocks, rows, c, m),
            torch.zeros((n_blocks, rows, c), dtype=torch.float32,
                        device=ops.device))
    _, acc = walk_pairwise(key, idx, ops.n_grid, step, init)
    return (lgd * acc).reshape(n_blocks, -1)


def plain_partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
                   n_blocks: int):
    """``((B, 2) [sum, sum2], (B, n_grid) profile sums)`` in plain PyTorch
    on the operands' device, over K40's stream (``m <= 8``) or K39's.  The
    price pairs are Kahan-carried over iterations; each node's exposure
    sum over the block, times ``1/2`` under antithetic, is added to its
    profile slot in ``mctpu``'s compensated form, walk by walk."""
    dev = ops.device
    m = ops.n_underlyings
    walk = _am_walk if use_asset_major(m) else _packed_walk
    width = LANES if use_asset_major(m) else pack_factor(m)[2]
    shape = (n_blocks, plan.rows * width)
    idx = tile_index(shape[1], dev)
    prof = torch.zeros((n_blocks, ops.n_grid), dtype=torch.float32,
                       device=dev)
    comp = torch.zeros_like(prof)
    half = 0.5 if plan.antithetic else 1.0

    def hook(j, ee):
        _add_profile(prof, comp, j, half * ee.reshape(n_blocks, -1).sum(1))

    carry = acc_init_n(2, n_blocks, dev)
    for i in range(plan.iters):
        key = iter_keys(seed, block_offset, plan.iters, i, n_blocks, dev)
        cva = walk(ops, key, idx, shape, 1.0, hook)
        if plan.antithetic:
            cva = 0.5 * (cva + walk(ops, key, idx, shape, -1.0, hook))
        carry = acc_add_n(carry, [cva.sum(1), (cva * cva).sum(1)],
                          plan.kahan)
    return acc_final_n(carry), prof + comp


def _check(ops: Operands, n_par: int) -> None:
    m, g = ops.n_underlyings, ops.n_grid
    for name, x, shape in (("scal", ops.scal, (3,)), ("lt", ops.lt, (m, m)),
                           ("par", ops.par, (n_par, m)),
                           ("nodes", ops.nodes, (5, g))):
        check_operand(name, x, shape, ops.device)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, scratch_cap: int = 0):
    """``((B, 2), (B, n_grid))`` partials: K40 (``m <= 8``) or K39 for CUDA
    operands, the plain version for CPU operands; other devices raise.
    ``scratch_cap``: K40's scratch in floats at most (0: 256 MB), past which
    it splits and folds simulation blocks and iterations in groups; the
    outputs do not depend on it."""
    dev = ops.device
    m = ops.n_underlyings
    am = use_asset_major(m)
    _check(ops, 9 if am else 7)
    if dev.type == "cpu":
        return plain_partials(ops, seed, block_offset, plan, n_blocks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    g = ops.n_grid
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((n_blocks, 2), dtype=torch.float32, device=dev)
        ee = torch.empty((n_blocks, g), dtype=torch.float32, device=dev)
        shape = (n_blocks, plan.rows, plan.iters, int(plan.antithetic))
        if am:
            n_scratch = lib.mctpu_cva_multi_am_scratch_floats(
                m, g, *shape, scratch_cap)
        else:
            n_scratch = n_blocks * lib.mctpu_cva_multi_scratch_floats(m, g)
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
        ptrs = (ops.scal.data_ptr(), ops.lt.data_ptr(), ops.par.data_ptr(),
                ops.nodes.data_ptr(), m, g)
        common = (wrap_int32(seed), wrap_int32(block_offset), *shape,
                  int(plan.kahan))
        bufs = (scratch.data_ptr(), out.data_ptr(), ee.data_ptr(), _stream())
        if am:
            name = "cva_multi_am"
            status = lib.mctpu_cva_multi_am(*ptrs, *common, scratch_cap,
                                            *bufs)
        else:
            name = "cva_multi_packed"
            a_tile, _, width = pack_factor(m)
            status = lib.mctpu_cva_multi_packed(*ptrs, a_tile, width,
                                                *common, *bufs)
    _build.check(status, name)
    LAUNCHES[name] += 1
    return out, ee


# ---------------------------------------------------------------------------
# K42: credit delta and per-underlying delta and vega, asset-major
# ---------------------------------------------------------------------------
# CVA = lgd E[sum_j dp_j ee_j] (mctpu's Greeks section): credit delta sums
# d(dp_j)/dlambda ee_j; delta_i = lgd sum_j dp_j 1{net_j > 0} w_i N(d1_ij)
# S_ij / s0_i (the 1 / s0_i in float64 on the host), vega_i = lgd sum_j dp_j
# 1{net_j > 0} w_i [N(d1_ij) S_ij dxv_ij + S_ij phi(d1_ij) sqrt(tau_j)].
# Per block: the (cva, credit) pairs and per underlying the (delta,
# delta^2, vega, vega^2) sums.

def _am_greek_walk(ops: Operands, key, idx, shape, sgn):
    m = ops.n_underlyings
    r, lgd, sqdt = ops.scal.unbind()
    dp, ddp, tau, sqtau, disc = ops.nodes
    par = ops.par

    def step(j, zs, carry):
        xs, dxvs, acc, acc_cr, acc_d, acc_v = carry
        xs, bts, ss, nd1s, phis, net = _am_node(
            [sgn * z for z in zs], xs, ops.lt, par, r, tau[j], sqtau[j],
            disc[j], True)
        dxvs = [dxvs[i] + sqdt * bts[i] - par[3, i] for i in range(m)]
        ee = torch.clamp(net, min=0.0)
        ind = (net > 0.0).to(net.dtype)
        new_d, new_v = [], []
        for i in range(m):
            ws = ind * par[4, i] * ss[i]
            dval = ws * nd1s[i]
            vval = dval * dxvs[i] + ws * phis[i] * sqtau[j]
            new_d.append(acc_d[i] + dp[j] * dval)
            new_v.append(acc_v[i] + dp[j] * vval)
        return (xs, dxvs, acc + dp[j] * ee, acc_cr + ddp[j] * ee, new_d,
                new_v)

    zero = torch.zeros(shape, dtype=torch.float32, device=ops.device)
    init = ([par[0, i].expand(shape) for i in range(m)], [zero] * m, zero,
            zero, [zero] * m, [zero] * m)
    _, _, acc, acc_cr, acc_d, acc_v = walk_pairwise_multi(
        key, idx, m, ops.n_grid, step, init)
    return ([lgd * acc, lgd * acc_cr] + [lgd * d for d in acc_d]
            + [lgd * v for v in acc_v])


def greek_plain_partials(ops: Operands, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int):
    """K42's per-block ``((B, 4), (B, 4, m))`` partials (up to 8
    underlyings, over K40's stream: the CVA pair is the pricer's bit for
    bit) or K41's ``((B, 4), (B, 4, width))`` (beyond, over K39's stream)
    in plain PyTorch on the operands' device."""
    m = ops.n_underlyings
    if use_asset_major(m):
        return vec_greek_partials(
            lambda key, idx, shape, sgn: _am_greek_walk(ops, key, idx, shape,
                                                        sgn),
            m, seed, block_offset, plan, n_blocks, ops.device)
    return packed_vec_partials(
        lambda key, idx, shape, sgn: _packed_greek_walk(ops, key, idx, shape,
                                                        sgn),
        pack_factor(m), seed, block_offset, plan, n_blocks, ops.device)


def _check_greek_ops(ops: Operands) -> None:
    try:
        _check(ops, 9)
    except ValueError as err:
        raise ValueError(
            f"{err}: the Greek kernels K42 and K41 take operands(..., "
            f"greeks=True)' (9, m) rows ({ops.n_underlyings} underlyings "
            f"given)") from None


def greek_partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
                   n_blocks: int):
    """The netting-set Greek partials: K42's ``((B, 4), (B, 4, m))`` up to
    8 underlyings, K41's ``((B, 4), (B, 4, width))`` beyond, both from
    :func:`operands`' ``greeks=True`` rows; the kernel for CUDA operands,
    the plain version for CPU operands; other devices raise."""
    _check_greek_ops(ops)
    dev = ops.device
    if dev.type == "cpu":
        return greek_plain_partials(ops, seed, block_offset, plan, n_blocks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    m = ops.n_underlyings
    ptrs = (ops.scal.data_ptr(), ops.lt.data_ptr(), ops.par.data_ptr(),
            ops.nodes.data_ptr(), m, ops.n_grid)
    common = (wrap_int32(seed), wrap_int32(block_offset), n_blocks,
              plan.rows, plan.iters, int(plan.antithetic), int(plan.kahan))
    lib = _build.library()
    with torch.cuda.device(dev):
        if use_asset_major(m):
            name = "cva_multi_greeks_am"
            out = torch.empty((n_blocks, N_GREEK_SCALARS + 4 * m),
                              dtype=torch.float32, device=dev)
            status = lib.mctpu_cva_multi_greeks_am(*ptrs, *common,
                                                   out.data_ptr(), _stream())
        else:
            name = "cva_multi_greeks_packed"
            a_tile, _, width = pack_factor(m)
            out = torch.empty((n_blocks, N_GREEK_SCALARS),
                              dtype=torch.float32, device=dev)
            vecs = torch.empty((n_blocks, 4, width), dtype=torch.float32,
                               device=dev)
            status = lib.mctpu_cva_multi_greeks_packed(
                *ptrs, a_tile, width, *common, out.data_ptr(),
                vecs.data_ptr(), _stream())
    _build.check(status, name)
    LAUNCHES[name] += 1
    return split_vec(out, m) if use_asset_major(m) else (out, vecs)


# ---------------------------------------------------------------------------
# K41: credit delta and per-underlying delta and vega, lane-packed (m > 8)
# ---------------------------------------------------------------------------
# K42's estimators on K39's walk (mctpu's _greek_step and _greek_node): per
# lane the log-spot and the vol tangent dxv += sqrt(dt) bt - v dt with bt =
# L z from 0; each leg in _am_quants' form (d1 = (x - log k + (r + v^2/2)
# tau) * (1 / sq), not K39's log(s / k): K41's CVA is close to K39's, not
# equal); the path's net from 0 over its real lanes and the indicator 1{net
# > 0} broadcast onto them (mctpu's iselT product).  The lanes carry lgd
# sum_j dp_j dval and vval, the path its CVA and credit legs; per block the
# four scalar sums and the (4, width) lane rows (K33's, packed_vec_partials).

def _packed_greek_walk(ops: Operands, key, idx, shape, sgn):
    """One packed Greek walk -> ``(cva, credit)`` per path ``(B, rows, c)``
    and ``(delta, vega)`` per real lane ``(B, rows, c, m)``, lgd applied."""
    m = ops.n_underlyings
    a_tile, c, width = pack_factor(m)
    r, lgd, sqdt = ops.scal.unbind()
    dp, ddp, tau, sqtau, disc = ops.nodes
    log_s0, drift, vol, vdt, w, k, logk, v2h, v = ops.par
    n_blocks, rows = shape[0], shape[1] // width
    cdf = mcmath.norm_cdf_hastings

    def step(j, z, carry):
        x, dxv, acc, acc_cr, acc_d, acc_v = carry
        zp = (sgn * z).view(n_blocks, rows, c, a_tile)[..., :m]
        bt = torch.zeros_like(x)
        for jj in range(m):
            bt = bt + ops.lt[:, jj] * zp[..., jj:jj + 1]
        x = x + drift + vol * bt
        dxv = dxv + sqdt * bt - vdt
        s = torch.exp(x)
        if bool(tau[j] <= 0.0):
            val = w * torch.clamp(s - k, min=0.0)
            nd1 = (s > k).to(s.dtype)
            phi = torch.zeros_like(s)
        else:
            sq = v * torch.clamp(sqtau[j], min=1e-6)
            d1 = ((x - logk + (r + v2h) * torch.clamp(tau[j], min=1e-12))
                  * (1.0 / sq))
            nd1 = cdf(d1)
            val = w * (s * nd1 - k * disc[j] * cdf(d1 - sq))
            phi = 0.3989422804014327 * torch.exp(-0.5 * d1 * d1)
        net = torch.zeros_like(val[..., 0])
        for i in range(m):
            net = net + val[..., i]
        ee = torch.clamp(net, min=0.0)
        ws = (net > 0.0).to(net.dtype).unsqueeze(-1) * w * s
        dval = ws * nd1
        vval = dval * dxv + ws * phi * sqtau[j]
        return (x, dxv, acc + dp[j] * ee, acc_cr + ddp[j] * ee,
                acc_d + dp[j] * dval, acc_v + dp[j] * vval)

    lanes = torch.zeros((n_blocks, rows, c, m), dtype=torch.float32,
                        device=ops.device)
    paths = lanes[..., 0]
    init = (log_s0.expand(n_blocks, rows, c, m), lanes, paths, paths, lanes,
            lanes)
    _, _, acc, acc_cr, acc_d, acc_v = walk_pairwise(key, idx, ops.n_grid,
                                                    step, init)
    return lgd * acc, lgd * acc_cr, lgd * acc_d, lgd * acc_v


# ---------------------------------------------------------------------------
# K43, K44: bilateral xVA and its Greeks, asset-major at any m
# ---------------------------------------------------------------------------
# The netted value V_j of K40's node carries both exposure sides: EPE_j =
# max(V_j, 0) feeds the CVA and funding-cost legs, ENE_j = EPE_j - V_j (no
# second clamp) the DVA and funding-benefit legs, each a node table times a
# per-path sum (mctpu's _am_xva_step): lgd sum w_cva EPE, own_lgd sum w_dva
# ENE, sum w_fnd EPE, sum w_fnd ENE.  K44 (mctpu's _am_xva_greek_step) adds
# the per-leg sensitivities dCVA/dlambda_C, dDVA/dlambda_B, dFVA/dspread
# over the derivative tables and the per-underlying pathwise delta and vega
# of the total XVA = CVA - DVA + FCA - FBA, with the side-selected weight
# tw = (wc' + wf) 1{V > 0} + (wd' + wf) (1 - 1{V > 0}) (wc' = lgd w_cva,
# wd' = own_lgd w_dva folded into K44's tables).  mctpu's Pallas kernels
# stop at 8 underlyings and its engine sends wider sets to a Threefry twin;
# the port extends the asset-major Philox map to any m (pair jj draws
# counter jj m + i) and serves them with runtime-m kernels.  At
# own_intensity = 0 and funding_spread = 0 K43's CVA sums and EPE profile
# are K40's bit for bit.

N_XVA_SUMS = 8  # (sum, sum^2) of the cva, dva, fca, fba legs
N_XVA_GREEK_SCALARS = 14  # ... and of dCVA/dlambda_C, dDVA/dlambda_B,
#                           dFVA/dspread


def _maturity_rows(spec: CvaMultiSpec) -> torch.Tensor:
    """``(3, g)`` float32 ``tau``, ``sqrt(tau)``, ``exp(-r tau)``: the
    last rows of :func:`greek_tables`."""
    return greek_tables(spec)[2:]


def xva_tables(xspec: XvaSpec) -> torch.Tensor:
    """K43's ``(6, n_grid)`` float32 node tables, ``mctpu``'s
    ``xva_tables``: ``w_cva``, ``w_dva`` (:func:`mcmath.xva_leg_weights`),
    ``w_fnd`` (:func:`mcmath.funding_leg_weights`), ``tau``, ``sqrt(tau)``,
    ``exp(-r tau)``."""
    sp = xspec.netting
    g = sp.n_grid
    f = torch.float32
    w_cva, w_dva = mcmath.xva_leg_weights(sp.intensity, xspec.own_intensity,
                                          sp.t, g, dtype=f)
    w_fnd = mcmath.funding_leg_weights(sp.intensity, xspec.own_intensity,
                                       xspec.funding_spread, sp.t, g, dtype=f)
    return torch.cat([torch.stack([w_cva, w_dva, w_fnd]),
                      _maturity_rows(sp)])


def xva_greek_tables(xspec: XvaSpec) -> torch.Tensor:
    """K44's ``(9, n_grid)`` float32 node tables, ``mctpu``'s
    ``xva_greek_tables``: ``lgd w_cva``, ``own_lgd w_dva``, ``w_fnd``,
    ``lgd dw_cva``, ``own_lgd dw_dva``, ``dw_fnd``
    (:func:`mcmath.xva_leg_weight_derivs`), ``tau``, ``sqrt(tau)``,
    ``exp(-r tau)``."""
    sp = xspec.netting
    g = sp.n_grid
    f = torch.float32
    lgd, olgd = f32(sp.lgd, xspec.own_lgd)
    w_cva, w_dva, w_fnd = xva_tables(xspec)[:3]
    dwc, dwd, dwf = mcmath.xva_leg_weight_derivs(
        sp.intensity, xspec.own_intensity, sp.t, g, dtype=f)
    return torch.cat([torch.stack([lgd * w_cva, olgd * w_dva, w_fnd,
                                   lgd * dwc, olgd * dwd, dwf]),
                      _maturity_rows(sp)])


def xva_operands(xspec: XvaSpec, chol, device,
                 greeks: bool = False) -> Operands:
    """K43's (or with ``greeks`` K44's) operands of ``xspec`` with lower
    Cholesky factor ``chol`` (of ``xspec.netting.corr``), formed on the CPU
    and moved to ``device``: ``scal (4,)`` = r, lgd, own_lgd, ``sqrt(dt)``;
    :func:`am_ops`' ``lt`` and ``(9, m)`` rows at every size; the node
    tables :func:`xva_tables` ``(6, g)`` or :func:`xva_greek_tables` ``(9,
    g)``."""
    sp = xspec.netting
    lt, par = am_ops(sp, chol)
    (t, r, lgd, olgd) = f32(sp.t, sp.r, sp.lgd, xspec.own_lgd)
    scal = torch.stack([r, lgd, olgd, sqrt32(t / sp.n_grid)])
    nodes = (xva_greek_tables if greeks else xva_tables)(xspec)
    return Operands(*(x.contiguous().to(device) for x in
                      (scal, lt, par, nodes)))


def _am_xva_walk(ops: Operands, key, idx, shape, sgn, hook):
    """One K43 walk -> its ``[cva, dva, fca, fba]`` tiles (LGDs applied at
    the end); ``hook(j, epe, ene)`` takes each node's exposure tiles."""
    m = ops.n_underlyings
    r, lgd, olgd, _ = ops.scal.unbind()
    wc, wd, wf, tau, sqtau, disc = ops.nodes

    def step(j, zs, carry):
        xs, ac, ad, af, ab = carry
        xs, _, _, _, _, net = _am_node([sgn * z for z in zs], xs, ops.lt,
                                       ops.par, r, tau[j], sqtau[j], disc[j],
                                       False)
        epe = torch.clamp(net, min=0.0)
        ene = epe - net
        hook(j, epe, ene)
        return (xs, ac + wc[j] * epe, ad + wd[j] * ene, af + wf[j] * epe,
                ab + wf[j] * ene)

    zero = torch.zeros(shape, dtype=torch.float32, device=ops.device)
    init = ([ops.par[0, i].expand(shape) for i in range(m)], zero, zero,
            zero, zero)
    _, ac, ad, af, ab = walk_pairwise_multi(key, idx, m, ops.n_grid, step,
                                            init)
    return [lgd * ac, olgd * ad, af, ab]


def xva_plain_partials(ops: Operands, seed: int, block_offset: int,
                       plan: Plan, n_blocks: int):
    """K43's ``((B, 8) [(sum, sum^2) of cva, dva, fca, fba], (B, 2, g)
    [EPE, ENE profile sums])`` in plain PyTorch on the operands' device,
    over K40's stream extended to any m: the leg pairs Kahan-carried over
    iterations, each node's exposures summed over the block (times 1/2
    under antithetic) into their profile slots in ``mctpu``'s compensated
    form, walk by walk; the CVA pair and EPE row are
    :func:`plain_partials`' at ``w_cva = dp``."""
    dev = ops.device
    shape = (n_blocks, plan.rows * LANES)
    idx = tile_index(shape[1], dev)
    prof = torch.zeros((n_blocks, 2, ops.n_grid), dtype=torch.float32,
                       device=dev)
    comp = torch.zeros_like(prof)
    half = 0.5 if plan.antithetic else 1.0

    def hook(j, epe, ene):
        for side, x in enumerate((epe, ene)):
            _add_profile(prof[:, side], comp[:, side], j,
                         half * x.reshape(n_blocks, -1).sum(1))

    carry = acc_init_n(N_XVA_SUMS, n_blocks, dev)
    for i in range(plan.iters):
        key = iter_keys(seed, block_offset, plan.iters, i, n_blocks, dev)
        legs = _am_xva_walk(ops, key, idx, shape, 1.0, hook)
        if plan.antithetic:
            mirror = _am_xva_walk(ops, key, idx, shape, -1.0, hook)
            legs = [0.5 * (x + y) for x, y in zip(legs, mirror)]
        sums = []
        for q in legs:
            sums += [q.sum(1), (q * q).sum(1)]
        carry = acc_add_n(carry, sums, plan.kahan)
    return acc_final_n(carry), prof + comp


def _am_xva_greek_walk(ops: Operands, key, idx, shape, sgn):
    """One K44 walk -> ``[cva, dva, fca, fba, dCVA/dlambda_C,
    dDVA/dlambda_B, dFVA/dspread, delta_0.., vega_0..]`` tiles."""
    m = ops.n_underlyings
    r, _, _, sqdt = ops.scal.unbind()
    wc, wd, wf, dwc, dwd, dwf, tau, sqtau, disc = ops.nodes
    par = ops.par

    def step(j, zs, carry):
        xs, dxvs, legs, sens, acc_d, acc_v = carry
        xs, bts, ss, nd1s, phis, net = _am_node(
            [sgn * z for z in zs], xs, ops.lt, par, r, tau[j], sqtau[j],
            disc[j], True)
        dxvs = [dxvs[i] + sqdt * bts[i] - par[3, i] for i in range(m)]
        epe = torch.clamp(net, min=0.0)
        ene = epe - net
        ind = (net > 0.0).to(net.dtype)
        tw = (wc[j] + wf[j]) * ind + (wd[j] + wf[j]) * (1.0 - ind)
        new_d, new_v = [], []
        for i in range(m):
            ws = par[4, i] * ss[i]
            dval = ws * nd1s[i]
            vval = dval * dxvs[i] + ws * phis[i] * sqtau[j]
            new_d.append(acc_d[i] + tw * dval)
            new_v.append(acc_v[i] + tw * vval)
        ac, ad, af, ab = legs
        scr, sdr, sfr = sens
        return (xs, dxvs,
                (ac + wc[j] * epe, ad + wd[j] * ene, af + wf[j] * epe,
                 ab + wf[j] * ene),
                (scr + dwc[j] * epe, sdr + dwd[j] * ene,
                 sfr + dwf[j] * (epe - ene)),
                new_d, new_v)

    zero = torch.zeros(shape, dtype=torch.float32, device=ops.device)
    init = ([par[0, i].expand(shape) for i in range(m)], [zero] * m,
            (zero,) * 4, (zero,) * 3, [zero] * m, [zero] * m)
    _, _, legs, sens, acc_d, acc_v = walk_pairwise_multi(
        key, idx, m, ops.n_grid, step, init)
    return list(legs) + list(sens) + acc_d + acc_v


def xva_greek_plain_partials(ops: Operands, seed: int, block_offset: int,
                             plan: Plan, n_blocks: int):
    """K44's per-block ``((B, 14), (B, 4, m))`` partials in plain PyTorch on
    the operands' device, over K43's stream."""
    return vec_greek_partials(
        lambda key, idx, shape, sgn: _am_xva_greek_walk(ops, key, idx, shape,
                                                        sgn),
        ops.n_underlyings, seed, block_offset, plan, n_blocks, ops.device,
        n_scal=N_XVA_GREEK_SCALARS)


def _check_xva(ops: Operands, greeks: bool) -> None:
    m, g = ops.n_underlyings, ops.n_grid
    for name, x, shape in (("scal", ops.scal, (4,)), ("lt", ops.lt, (m, m)),
                           ("par", ops.par, (9, m)),
                           ("nodes", ops.nodes, (9 if greeks else 6, g))):
        check_operand(name, x, shape, ops.device)


def _xva_launch(ops: Operands, greeks: bool, wide, n_blocks: int):
    """The device, whether the runtime-m kernel runs (``wide`` None: beyond
    8 underlyings) and the library, after the operand checks."""
    _check_xva(ops, greeks)
    dev = ops.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    m = ops.n_underlyings
    wide = not use_asset_major(m) if wide is None else bool(wide)
    return dev, wide


def xva_partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
                 n_blocks: int, wide=None, scratch_cap: int = 0):
    """K43's ``((B, 8), (B, 2, g))`` partials: for CUDA operands K43 up to
    8 underlyings and its runtime-m kernel beyond (or wherever ``wide`` is
    true), for CPU operands the plain version; other devices raise.
    ``scratch_cap``: K43's scratch in floats at most (0: 256 MB), past which
    it splits and folds simulation blocks and iterations in groups, as K40
    does; the outputs do not depend on it."""
    dev, wide = _xva_launch(ops, False, wide, n_blocks)
    if dev.type == "cpu":
        return xva_plain_partials(ops, seed, block_offset, plan, n_blocks)
    m, g = ops.n_underlyings, ops.n_grid
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((n_blocks, N_XVA_SUMS), dtype=torch.float32,
                          device=dev)
        prof = torch.empty((n_blocks, 2, g), dtype=torch.float32, device=dev)
        shape = (n_blocks, plan.rows, plan.iters, int(plan.antithetic))
        scratch = torch.empty(
            lib.mctpu_xva_scratch_floats(m, g, 0, int(wide), *shape,
                                         scratch_cap),
            dtype=torch.float32, device=dev)
        status = lib.mctpu_xva(
            ops.scal.data_ptr(), ops.lt.data_ptr(), ops.par.data_ptr(),
            ops.nodes.data_ptr(), m, g, int(wide), wrap_int32(seed),
            wrap_int32(block_offset), *shape, int(plan.kahan), scratch_cap,
            scratch.data_ptr(), out.data_ptr(), prof.data_ptr(), _stream())
    name = "xva_wide" if wide else "xva_am"
    _build.check(status, name)
    LAUNCHES[name] += 1
    return out, prof


def xva_greek_partials(ops: Operands, seed: int, block_offset: int,
                       plan: Plan, n_blocks: int, wide=None,
                       scratch_cap: int = 0):
    """K44's ``((B, 14), (B, 4, m))`` partials: for CUDA operands K44 up to
    8 underlyings and its runtime-m kernel beyond (or wherever ``wide`` is
    true), for CPU operands the plain version; other devices raise.
    ``scratch_cap``: K44's scratch in floats at most (0: 256 MB), past which
    it splits and folds simulation blocks and iterations in groups; the
    outputs do not depend on it (the runtime-m kernel's state past 32
    underlyings comes on top)."""
    dev, wide = _xva_launch(ops, True, wide, n_blocks)
    if dev.type == "cpu":
        return xva_greek_plain_partials(ops, seed, block_offset, plan,
                                        n_blocks)
    m, g = ops.n_underlyings, ops.n_grid
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((n_blocks, N_XVA_GREEK_SCALARS + 4 * m),
                          dtype=torch.float32, device=dev)
        shape = (n_blocks, plan.rows, plan.iters, int(plan.antithetic))
        scratch = torch.empty(
            lib.mctpu_xva_scratch_floats(m, g, 1, int(wide), *shape,
                                         scratch_cap),
            dtype=torch.float32, device=dev)
        status = lib.mctpu_xva_greeks(
            ops.scal.data_ptr(), ops.lt.data_ptr(), ops.par.data_ptr(),
            ops.nodes.data_ptr(), m, g, int(wide), wrap_int32(seed),
            wrap_int32(block_offset), *shape, int(plan.kahan), scratch_cap,
            scratch.data_ptr(), out.data_ptr(), _stream())
    name = "xva_greeks_wide" if wide else "xva_greeks_am"
    _build.check(status, name)
    LAUNCHES[name] += 1
    return split_vec(out, m, N_XVA_GREEK_SCALARS)
