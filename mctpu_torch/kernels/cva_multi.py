"""K39, K40 and K42: the netting-set CVA over correlated underlyings and its
asset-major Greeks (``csrc/cva_multi.cu``).

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
* wider sets, lane-packed (K39): a ``(rows, width)`` tile whose row packs
  ``c`` paths of ``a_tile`` lanes (``pack_factor``), one pair per lane per
  two nodes (:func:`walk_pairwise`); ``bt = z L^T`` formed from 0, and each
  leg prices through ``bs_call_hastings``' ``log(s / k)`` form.  The two
  regimes round differently and each keeps its own order.

K42 adds to K40's node the per-underlying vol tangent ``dxv_i += sqrt(dt)
bt_i - v_i dt``, the shared exercise indicator ``net > 0`` and the
pathwise delta and vega integrands (``mctpu``'s ``_am_greek_step``), and
the credit delta through ``d(dp_j)/dlambda``.  K40 and K42 share the node
function and the block reduction, so a Greeks CVA equals the pricer's bit
for bit on the same plan.

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
from mctpu_torch.kernels.basket import (ASSET_MAJOR_MAX, pack_factor,
                                        use_asset_major)
from mctpu_torch.kernels.common import (LANES, N_GREEK_SCALARS, Plan,
                                        acc_add_n, acc_final_n, acc_init_n,
                                        check_operand, f32, iter_keys,
                                        split_vec, sqrt32, tile_index,
                                        vec_greek_partials, walk_pairwise,
                                        walk_pairwise_multi)
from mctpu_torch.kernels.cva import credit_delta_weights
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import CvaMultiSpec

__all__ = ["make_plan", "pack_spec", "am_ops", "packed_ops", "greek_tables",
           "Operands", "operands", "plain_partials", "partials",
           "greek_plain_partials", "greek_partials", "N_GREEK_SCALARS",
           "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name: K40, K39,
# K42.
LAUNCHES = {"cva_multi_am": 0, "cva_multi_packed": 0,
            "cva_multi_greeks_am": 0}


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


def operands(spec: CvaMultiSpec, chol, device) -> Operands:
    """The operands of ``spec`` with lower Cholesky factor ``chol``, formed
    on the CPU and moved to ``device``."""
    m = spec.n_underlyings
    lt, par = (am_ops if use_asset_major(m) else packed_ops)(spec, chol)
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
             n_blocks: int):
    """``((B, 2), (B, n_grid))`` partials: K40 (``m <= 8``) or K39 for CUDA
    operands, the plain version for CPU operands; other devices raise."""
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
        scratch = torch.empty(
            n_blocks * lib.mctpu_cva_multi_scratch_floats(m, g),
            dtype=torch.float32, device=dev)
        ptrs = (ops.scal.data_ptr(), ops.lt.data_ptr(), ops.par.data_ptr(),
                ops.nodes.data_ptr(), m, g)
        common = (wrap_int32(seed), wrap_int32(block_offset), n_blocks,
                  plan.rows, plan.iters, int(plan.antithetic),
                  int(plan.kahan), scratch.data_ptr(), out.data_ptr(),
                  ee.data_ptr(), _stream())
        if am:
            name = "cva_multi_am"
            status = lib.mctpu_cva_multi_am(*ptrs, *common)
        else:
            name = "cva_multi_packed"
            a_tile, _, width = pack_factor(m)
            status = lib.mctpu_cva_multi_packed(*ptrs, a_tile, width,
                                                *common)
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
    """K42's per-block ``((B, 4), (B, 4, m))`` partials in plain PyTorch on
    the operands' device, over K40's stream: the CVA pair is the pricer's
    bit for bit."""
    return vec_greek_partials(
        lambda key, idx, shape, sgn: _am_greek_walk(ops, key, idx, shape,
                                                    sgn),
        ops.n_underlyings, seed, block_offset, plan, n_blocks, ops.device)


def greek_partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
                   n_blocks: int):
    """K42's ``((B, 4), (B, 4, m))`` partials: the kernel for CUDA
    operands, the plain version for CPU operands; other devices raise, and
    so do more than 8 underlyings (the packed K41 is not ported)."""
    m = ops.n_underlyings
    if not use_asset_major(m):
        raise ValueError(f"K42 takes 1..{ASSET_MAJOR_MAX} underlyings, got "
                         f"{m}")
    _check(ops, 9)
    dev = ops.device
    if dev.type == "cpu":
        return greek_plain_partials(ops, seed, block_offset, plan, n_blocks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((n_blocks, N_GREEK_SCALARS + 4 * m),
                          dtype=torch.float32, device=dev)
        status = lib.mctpu_cva_multi_greeks_am(
            ops.scal.data_ptr(), ops.lt.data_ptr(), ops.par.data_ptr(),
            ops.nodes.data_ptr(), m, ops.n_grid, wrap_int32(seed),
            wrap_int32(block_offset), n_blocks, plan.rows, plan.iters,
            int(plan.antithetic), int(plan.kahan), out.data_ptr(), _stream())
    _build.check(status, "cva_multi_greeks_am")
    LAUNCHES["cva_multi_greeks_am"] += 1
    return split_vec(out, m)
