"""K30-K35: the correlated multi-asset walks — basket-Asian and
basket-barrier pricing and their Greeks at every basket size
(``csrc/multi_walk.cu``).

Counterpart of :mod:`mctpu.kernels.multi_walk`.  Each unit walks a
correlated GBM basket over ``n_obs`` dates; at every date the correlated
increment is ``bt = L z + d / sqrt(n_obs)`` and the monitor acts on the
basket value ``B = sum_i w_i S_i``: a running sum for the Asian
(``max(mean B - k, 0)``) or a 0/1 ``alive`` flag for the knock-out (``B <
H`` up-and-out, ``B > H`` down-and-out; ``alive * max(B_T - k, 0)``).  The
two stream maps are ``mctpu``'s:

* up to ``ASSET_MAJOR_MAX`` assets, asset-major (K30, K32, K34): every
  element of a ``(rows, 128)`` tile is a path, and the ``a`` asset normals
  of a date come from :func:`walk_pairwise_multi` (pair ``jj`` draws counter
  ``jj * a + i`` for asset ``i``).  ``bt_i = d_i + sum_{j <= i} L_ij z_j``
  starts from ``d_i``;
* wider baskets, lane-packed (K31, K33, K35): a ``(rows, width)`` tile
  whose row packs ``c`` paths of ``a_tile`` lanes each (:func:`pack_factor`),
  one pair per lane per two dates (:func:`walk_pairwise`).  ``bt = (z @
  L^T) + d``: the product first, then ``+ d``.

``mctpu``'s docstring of ``make_plan`` says the Greek kernels run the packed
layout only; its engine sends baskets of up to 8 assets to the asset-major
Greek kernels (K32, K34) and wider ones to the packed (K33, K35), and so
does the port's.

The operand tables are formed on the CPU in float32 in ``mctpu``'s
expression order and moved to the device.  Every discontinuity (the
knock-out compare, the in-the-money indicator) sees the same bits in the
kernel and its plain version, because both take the same operations in the
same order (the kernels build with ``-fmad=false``); the plain versions do
the correlation product as separate multiplies and adds, never as a
``torch.matmul``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mctpu_torch import _build
from mctpu_torch.kernels.basket import pack_factor, use_asset_major
from mctpu_torch.kernels.common import (LANES, N_GREEK_SCALARS, Plan,
                                        check_operand, f32,
                                        packed_vec_partials, split_vec,
                                        sqrt32, vec_greek_partials,
                                        walk_pairwise, walk_pairwise_multi,
                                        walk_partials)
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import BasketOption

__all__ = ["make_plan", "walk_ops", "scalars", "am_greek_ops",
           "packed_greek_ops", "am_bar_greek_ops", "packed_bar_greek_ops",
           "plain_partials", "partials", "am_greek_plain_partials",
           "packed_greek_plain_partials", "am_greek_partials",
           "am_bar_greek_plain_partials", "am_bar_greek_partials",
           "packed_bar_greek_state", "packed_bar_greek_plain_partials",
           "bar_greek_partials", "N_GREEK_SCALARS", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name: K30 and K31
# for each product, K32, K33, K34, K35.
LAUNCHES = {"basket_asian_am": 0, "basket_barrier_am": 0,
            "basket_asian_packed": 0, "basket_barrier_packed": 0,
            "basket_asian_greeks_am": 0, "basket_asian_greeks_packed": 0,
            "basket_barrier_greeks_am": 0,
            "basket_barrier_greeks_packed": 0}

PRODUCTS = ("asian", "barrier")


def make_plan(n_paths: int, num_blocks: int, rows: int, antithetic: bool,
              kahan: bool = True, n_assets: int = 3) -> Plan:
    """The plan of a multi-asset walk: ``rows * 128`` units per (block,
    iteration) asset-major, ``rows * c`` packed (``mctpu``'s ``make_plan``;
    each Greek kernel runs its pricer's regime)."""
    if use_asset_major(n_assets):
        units = rows * LANES
    else:
        units = rows * pack_factor(n_assets)[1]
    paths = units * (2 if antithetic else 1)
    return Plan.plan(n_paths, num_blocks, rows, paths, units, antithetic,
                     kahan)


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32)


def walk_ops(opt: BasketOption, chol, n_obs: int):
    """``(lt, par)``: the float32 lower Cholesky factor ``(a, a)`` and the
    per-asset step rows ``par (5, a)`` = ``log s0``, ``(r - 0.5 v v) t /
    n``, ``v sqrt(t) / sqrt(n)``, ``d / sqrt(n)``, ``w``.  Both of
    ``mctpu``'s builders form these values in this order: ``_am_walk_ops``
    (asset-major) and ``_step_ops`` on a path's lanes (packed; its padded
    lanes are never read here)."""
    a = opt.n_assets
    (n,) = f32(n_obs)
    r, t = f32(opt.r, opt.t)
    v, s, d, w = (torch.broadcast_to(_f32(x), (a,))
                  for x in (opt.v, opt.s, opt.d, opt.w))
    sqn = sqrt32(n)
    rows = [torch.log(s), (r - 0.5 * v * v) * t / n,
            v * sqrt32(t) / sqn, d / sqn, w]
    return _f32(chol), torch.stack(rows)


def scalars(opt: BasketOption, barrier=None) -> torch.Tensor:
    """K30's and K31's ``scal (2,)``: strike and barrier (0 for the
    Asian)."""
    return torch.stack(list(f32(opt.k, 0.0 if barrier is None
                                else barrier)))


def am_greek_ops(opt: BasketOption, chol, n_obs: int):
    """K32's ``(scal, lt, par)``: ``scal (5,)`` = k, t, ``1 / n``,
    ``sqrt(dt)``, ``dt``; ``par (8, a)`` = :func:`walk_ops`' rows plus
    ``v dt``, ``w / n`` and ``1 / s0`` (``mctpu``'s ``_am_greek_ops``)."""
    lt, par = walk_ops(opt, chol, n_obs)
    a = opt.n_assets
    k, t, inv_n = f32(opt.k, opt.t, 1.0 / n_obs)
    (n,) = f32(n_obs)
    dt = t / n
    v, s, w = (torch.broadcast_to(_f32(x), (a,))
               for x in (opt.v, opt.s, opt.w))
    extra = torch.stack([v * dt, w / n, 1.0 / s])
    scal = torch.stack([k, t, inv_n, sqrt32(dt), dt])
    return scal, lt, torch.cat([par, extra])


def packed_greek_ops(opt: BasketOption, chol, n_obs: int):
    """K33's ``(scal, lt, par)``: ``scal (4 + n_obs,)`` = k, t, ``1 / n``,
    ``sqrt(dt)`` and the dates ``t_j = dt j``, ``j = 1..n``; ``par (7, a)``
    = :func:`walk_ops`' rows plus ``v dt`` and ``1 / s0``, the real lanes
    of ``mctpu``'s ``greek_step_ops`` rows in its order (``v dt`` from the
    step vol: ``(vol / sqrt(dt)) dt``; its ``w_row`` is ``w``)."""
    lt, par = walk_ops(opt, chol, n_obs)
    a = opt.n_assets
    k, t, inv_n = f32(opt.k, opt.t, 1.0 / n_obs)
    (n,) = f32(n_obs)
    dt = t / n
    sqdt = sqrt32(dt)
    vdt = (par[2] / sqdt) * dt
    inv_s0 = 1.0 / torch.broadcast_to(_f32(opt.s), (a,))
    tj = dt * torch.arange(1, n_obs + 1, dtype=torch.float32)
    scal = torch.cat([torch.stack([k, t, inv_n, sqdt]), tj])
    return scal, lt, torch.cat([par, torch.stack([vdt, inv_s0])])


def am_bar_greek_ops(opt: BasketOption, chol, n_obs: int, barrier):
    """K34's ``(scal, lt, linv, par)``: ``scal (4,)`` = k, t, H,
    ``sqrt(dt)``; ``linv`` the float32 inverse of the float32 factor, as
    ``jax.scipy.linalg.solve_triangular`` forms it (the tests hold the two
    bit for bit); ``par (8, a)`` = :func:`walk_ops`' rows plus ``1 / v``,
    ``1 / (s0 v sqrt(dt))`` and ``sqrt(dt) / v`` (``_am_bar_greek_ops``)."""
    lt, par = walk_ops(opt, chol, n_obs)
    a = opt.n_assets
    k, t, h = f32(opt.k, opt.t, barrier)
    (n,) = f32(n_obs)
    sqdt = sqrt32(t / n)
    linv = torch.linalg.solve_triangular(lt, torch.eye(a),
                                         upper=False).contiguous()
    v, s = (torch.broadcast_to(_f32(x), (a,)) for x in (opt.v, opt.s))
    extra = torch.stack([1.0 / v, 1.0 / (s * v * sqdt), sqdt / v])
    scal = torch.stack([k, t, h, sqdt])
    return scal, lt, linv, torch.cat([par, extra])


def packed_bar_greek_ops(opt: BasketOption, chol, n_obs: int, barrier):
    """K35's ``(scal, lt, linv, par)``: K34's ``scal`` and ``linv``;
    ``par (8, a)`` = :func:`walk_ops`' rows plus the real lanes of
    ``mctpu``'s ``barrier_greek_ops`` score rows in its order: with the
    step vol's ``v = vol / sqrt(dt)`` and the mask ``safe = (s0 > 0) & (v
    > 0)``, ``inv_v = 1 / v``, ``cd = 1 / (s0 v sqrt(dt))`` (0 where not
    safe) and ``sr = sqrt(dt) inv_v``."""
    scal, lt, linv, am_par = am_bar_greek_ops(opt, chol, n_obs, barrier)
    par, sqdt = am_par[:5], scal[3]
    s0 = torch.broadcast_to(_f32(opt.s), (opt.n_assets,))
    v = par[2] / sqdt
    safe = (s0 > 0) & (v > 0)
    inv_v = torch.where(safe, 1.0 / torch.clamp(v, min=1e-30), 0.0)
    cd = torch.where(safe, 1.0 / torch.clamp(s0 * v * sqdt, min=1e-30),
                     0.0)
    return scal, lt, linv, torch.cat([par, torch.stack([inv_v, cd,
                                                        sqdt * inv_v])])


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _am_core(zs, xs, lt, par, a: int):
    """One asset-major step (``mctpu``'s ``_am_core``): advanced log-spots,
    the basket value and the per-asset ``bt`` and spots.  The pricing and
    Greek walks share it, so their log-spot chains are the same bits."""
    new_xs, bts, ss = [], [], []
    basket = None
    for i in range(a):
        bt = par[3, i]
        for j in range(i + 1):
            bt = bt + lt[i, j] * zs[j]
        x = xs[i] + par[1, i] + par[2, i] * bt
        s = torch.exp(x)
        term = par[4, i] * s
        basket = term if basket is None else basket + term
        new_xs.append(x)
        bts.append(bt)
        ss.append(s)
    return new_xs, basket, bts, ss


def _monitor(product: str, barrier, up: bool):
    """``(monitor, payoff)`` of ``mctpu``'s ``_monitor_fns``; the extra
    state is the Asian running sum or the barrier's ``(alive, last)``."""
    if product == "asian":
        return (lambda basket, acc: acc + basket,
                lambda acc, n_obs, k: torch.clamp(acc / n_obs - k, min=0.0))

    def monitor(basket, carry):
        alive, _ = carry
        hit = basket < barrier if up else basket > barrier
        return alive * hit.to(alive.dtype), basket

    def payoff(carry, n_obs, k):
        alive, last = carry
        return alive * torch.clamp(last - k, min=0.0)

    return monitor, payoff


def _init_extra(product: str, shape, device):
    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    if product == "asian":
        return zero
    return torch.ones(shape, dtype=torch.float32, device=device), zero


def _am_walk(lt, par, scal, product, n_obs, up, key, idx, shape, sgn):
    a = lt.shape[0]
    k, barrier = scal.unbind()
    monitor, payoff = _monitor(product, barrier, up)

    def step(j, zs, carry):
        xs, extra = carry
        xs, basket, _, _ = _am_core([sgn * z for z in zs], xs, lt, par, a)
        return xs, monitor(basket, extra)

    init = ([par[0, i].expand(shape) for i in range(a)],
            _init_extra(product, shape, lt.device))
    _, extra = walk_pairwise_multi(key, idx, a, n_obs, step, init)
    return [payoff(extra, n_obs, k)]


def _packed_walk(lt, par, scal, product, n_obs, up, key, idx, shape, sgn):
    """One packed walk: the draw tile is ``(n_blocks, rows * width)``, its
    paths ``(n_blocks, rows, c)``.  ``L z`` is formed column by column as
    multiplies and adds from 0 (the zero terms above the diagonal add
    exactly 0), then ``+ d``."""
    a = lt.shape[0]
    a_tile, c, width = pack_factor(a)
    k, barrier = scal.unbind()
    monitor, payoff = _monitor(product, barrier, up)
    log_s0, drift, vol, d, w = par.unbind()
    n_blocks, rows = shape[0], shape[1] // width

    def step(j, z, carry):
        x, extra = carry
        zp = (sgn * z).view(n_blocks, rows, c, a_tile)[..., :a]
        bt = torch.zeros_like(x)
        for jj in range(a):
            bt = bt + lt[:, jj] * zp[..., jj:jj + 1]
        x = x + drift + vol * (bt + d)
        s = torch.exp(x)
        basket = torch.zeros_like(s[..., 0])
        for i in range(a):
            basket = basket + s[..., i] * w[i]
        return x, monitor(basket, extra)

    x0 = log_s0.expand(n_blocks, rows, c, a)
    init = (x0, _init_extra(product, (n_blocks, rows, c), lt.device))
    _, extra = walk_pairwise(key, idx, n_obs, step, init)
    return [payoff(extra, n_obs, k).reshape(n_blocks, -1)]


def plain_partials(lt: torch.Tensor, par: torch.Tensor, scal: torch.Tensor,
                   seed: int, block_offset: int, plan: Plan, n_blocks: int,
                   product: str, n_obs: int, up: bool = True
                   ) -> torch.Tensor:
    """Per-block ``[sum_p, sum_p2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on the operands' device, over K30's stream (``a <= 8``) or
    K31's."""
    a = lt.shape[0]
    if use_asset_major(a):
        return walk_partials(
            lambda key, idx, shape, sgn: _am_walk(
                lt, par, scal, product, n_obs, up, key, idx, shape, sgn),
            seed, block_offset, plan, n_blocks, lt.device)
    width = pack_factor(a)[2]
    return walk_partials(
        lambda key, idx, shape, sgn: _packed_walk(
            lt, par, scal, product, n_obs, up, key, idx, shape, sgn),
        seed, block_offset, plan, n_blocks, lt.device, width=width)


def _check_product(product: str) -> None:
    if product not in PRODUCTS:
        raise ValueError(f"product must be one of {PRODUCTS}")


@functools.lru_cache(maxsize=64)
def _am_scratch_floats(n_blocks: int, rows: int, iters: int,
                       cap: int) -> int:
    """Floats of scratch a K30 launch takes (its groups' payoffs and the
    fold's carry; a function of the plan alone)."""
    return _build.library().mctpu_multi_walk_am_scratch_floats(
        n_blocks, rows, iters, cap)


def _launch(entry: str, ptrs, a: int, n_scal_out: int, seed, block_offset,
            plan: Plan, n_blocks: int, n_obs: int, flags, device,
            scratch_floats: int = 0):
    """Launch a multi-walk kernel; its C signature is ``(*ptrs, n_assets,
    n_obs, seed, off, n_blocks, rows, iters, antithetic, kahan, *flags,
    [scratch,] out, stream)``, the scratch (``scratch_floats`` of them,
    allocated here on the current stream) only where ``scratch_floats``
    is given.  Returns the ``(n_blocks, n_scal_out)`` partials."""
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    if n_obs < 1:
        raise ValueError("n_obs must be >= 1")
    lib = _build.library()
    with torch.cuda.device(device):
        out = torch.empty((n_blocks, n_scal_out), dtype=torch.float32,
                          device=device)
        scratch = ()
        if scratch_floats:
            buf = torch.empty(scratch_floats, dtype=torch.float32,
                              device=device)
            scratch = (buf.data_ptr(),)
        status = getattr(lib, entry)(
            *ptrs, a, n_obs, wrap_int32(seed), wrap_int32(block_offset),
            n_blocks, plan.rows, plan.iters, int(plan.antithetic),
            int(plan.kahan), *(int(f) for f in flags), *scratch,
            out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(status, entry)
    return out


def partials(lt: torch.Tensor, par: torch.Tensor, scal: torch.Tensor,
             seed: int, block_offset: int, plan: Plan, n_blocks: int,
             product: str, n_obs: int, up: bool = True,
             scratch_cap: int = 0) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K30 (``a <= 8``) or K31 for
    CUDA operands, the plain version for CPU operands; any other device
    raises.  ``scratch_cap``: K30's scratch in floats at most (0: 256 MB),
    past which it splits and folds simulation blocks and iterations in
    groups; the outputs do not depend on it."""
    _check_product(product)
    dev = lt.device
    if dev.type == "cpu":
        return plain_partials(lt, par, scal, seed, block_offset, plan,
                              n_blocks, product, n_obs, up)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    a = lt.shape[0]
    for name, x, shape in (("lt", lt, (a, a)), ("par", par, (5, a)),
                           ("scal", scal, (2,))):
        check_operand(name, x, shape, dev)
    ptrs = (lt.data_ptr(), par.data_ptr(), scal.data_ptr())
    flags = (product == "barrier", up)
    if use_asset_major(a):
        name = f"basket_{product}_am"
        floats = _am_scratch_floats(max(n_blocks, 1), plan.rows, plan.iters,
                                    scratch_cap)
        out = _launch("mctpu_multi_walk_am", ptrs, a, 2, seed, block_offset,
                      plan, n_blocks, n_obs, flags + (scratch_cap,), dev,
                      scratch_floats=floats)
    else:
        name = f"basket_{product}_packed"
        a_tile, _, width = pack_factor(a)
        out = _launch("mctpu_multi_walk_packed", ptrs, a, 2, seed,
                      block_offset, plan, n_blocks, n_obs,
                      (a_tile, width) + flags, dev)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# K32: basket-Asian pathwise Greeks, asset-major
# ---------------------------------------------------------------------------
# delta_m = I (w_m / n) sum_j S_m(t_j) / s0_m, vega_m = I (w_m / n) sum_j
# S_m(t_j) dxv_m(t_j) with dxv_m += sqrt(dt) bt_m - v_m dt, rho = I (1 / n)
# sum_j t_j B_j - t P, t_j = dt (j + 1) (mctpu/kernels/multi_walk.py, Greeks
# section).  Per block: the (payoff, rho) pairs and, per asset, the (delta,
# delta^2, vega, vega^2) sums.

def _am_greek_walk(scal, lt, par, n_obs, key, idx, shape, sgn):
    a = lt.shape[0]
    k, t, inv_n, sqdt, dt = scal.unbind()

    def step(j, zs, carry):
        xs, dxvs, acc, tb, a_s, a_v = carry
        xs, basket, bts, ss = _am_core([sgn * z for z in zs], xs, lt, par, a)
        dxvs = [dxvs[i] + sqdt * bts[i] - par[5, i] for i in range(a)]
        a_s = [a_s[i] + ss[i] for i in range(a)]
        a_v = [a_v[i] + ss[i] * dxvs[i] for i in range(a)]
        tj = dt * (float(j) + 1.0)
        return xs, dxvs, acc + basket, tb + tj * basket, a_s, a_v

    zero = torch.zeros(shape, dtype=torch.float32, device=lt.device)
    init = ([par[0, i].expand(shape) for i in range(a)], [zero] * a, zero,
            zero, [zero] * a, [zero] * a)
    _, _, acc, tb, a_s, a_v = walk_pairwise_multi(key, idx, a, n_obs, step,
                                                  init)
    abar = acc * inv_n
    p = torch.clamp(abar - k, min=0.0)
    ind = (abar > k).to(torch.float32)
    gr = ind * (tb * inv_n) - t * p
    dvals = [ind * par[6, i] * a_s[i] * par[7, i] for i in range(a)]
    vvals = [ind * par[6, i] * a_v[i] for i in range(a)]
    return [p, gr] + dvals + vvals


def am_greek_plain_partials(scal: torch.Tensor, lt: torch.Tensor,
                            par: torch.Tensor, seed: int, block_offset: int,
                            plan: Plan, n_blocks: int, n_obs: int):
    """K32's per-block ``((B, 4), (B, 4, a))`` partials in plain PyTorch on
    the operands' device, over K30's stream."""
    return vec_greek_partials(
        lambda key, idx, shape, sgn: _am_greek_walk(scal, lt, par, n_obs,
                                                    key, idx, shape, sgn),
        lt.shape[0], seed, block_offset, plan, n_blocks, lt.device)


def _check_am(a: int) -> None:
    if not use_asset_major(a):
        raise ValueError(f"the asset-major Greek kernels take 1..8 assets, "
                         f"got {a}")


# ---------------------------------------------------------------------------
# K33: basket-Asian pathwise Greeks, lane-packed
# ---------------------------------------------------------------------------
# K32's estimators on K31's walk (mctpu's _greek_step_mw and
# _greek_payoff_mw): per lane the carries dxv += sqrt(dt) bt - v dt, AS +=
# S, AV += S dxv, per path acc += B and tb += t_j B; at the end dval = (I w
# / n) AS / s0 and vval = (I w / n) AV on each lane.  Per block the four
# scalar sums (Kahan-carried) and the (4, width) lane rows (dval, dval^2,
# vval, vval^2), each iteration's column sums taken by mctpu's halving tree
# over the rows and added in plain float32; the engine folds the c packed
# groups onto the assets.

def _packed_greek_walk(scal, lt, par, n_obs, key, idx, shape, sgn):
    """One packed Greek walk -> ``(p, gr)`` per path ``(B, rows, c)`` and
    ``(dval, vval)`` per real lane ``(B, rows, c, a)``."""
    a = lt.shape[0]
    a_tile, c, width = pack_factor(a)
    k, t, inv_n, sqdt = scal[:N_GREEK_SCALARS].unbind()
    tj = scal[N_GREEK_SCALARS:]
    log_s0, drift, vol, d, w, vdt, inv_s0 = par.unbind()
    n_blocks, rows = shape[0], shape[1] // width

    def step(j, z, carry):
        x, dxv, acc, tb, a_s, a_v = carry
        zp = (sgn * z).view(n_blocks, rows, c, a_tile)[..., :a]
        prod = torch.zeros_like(x)
        for jj in range(a):
            prod = prod + lt[:, jj] * zp[..., jj:jj + 1]
        bt = prod + d
        x = x + drift + vol * bt
        dxv = dxv + sqdt * bt - vdt
        s = torch.exp(x)
        basket = torch.zeros_like(s[..., 0])
        for i in range(a):
            basket = basket + s[..., i] * w[i]
        return (x, dxv, acc + basket, tb + tj[j] * basket, a_s + s,
                a_v + s * dxv)

    lanes = torch.zeros((n_blocks, rows, c, a), dtype=torch.float32,
                        device=lt.device)
    paths = lanes[..., 0]
    init = (log_s0.expand(n_blocks, rows, c, a), lanes, paths, paths, lanes,
            lanes)
    _, _, acc, tb, a_s, a_v = walk_pairwise(key, idx, n_obs, step, init)
    abar = acc * inv_n
    p = torch.clamp(abar - k, min=0.0)
    ind = (abar > k).to(torch.float32)
    gr = ind * (tb * inv_n) - t * p
    wiv = ind.unsqueeze(-1) * w * inv_n
    return p, gr, wiv * a_s * inv_s0, wiv * a_v


def packed_greek_plain_partials(scal: torch.Tensor, lt: torch.Tensor,
                                par: torch.Tensor, seed: int,
                                block_offset: int, plan: Plan, n_blocks: int,
                                n_obs: int):
    """K33's per-block ``((B, 4), (B, 4, width))`` partials in plain PyTorch
    on the operands' device, over K31's stream
    (:func:`packed_vec_partials`)."""
    return packed_vec_partials(
        lambda key, idx, shape, sgn: _packed_greek_walk(
            scal, lt, par, n_obs, key, idx, shape, sgn),
        pack_factor(lt.shape[0]), seed, block_offset, plan, n_blocks,
        lt.device)


def _check_greek_ops(scal, lt, par, n_obs: int) -> None:
    """K32's operands (``scal (5,)``, ``par (8, a)``) up to 8 assets, K33's
    (``scal (4 + n_obs,)``, ``par (7, a)``) beyond; raises otherwise."""
    a = lt.shape[0]
    if use_asset_major(a):
        shapes = (("scal", scal, (5,)), ("lt", lt, (a, a)),
                  ("par", par, (8, a)))
    else:
        shapes = (("scal", scal, (N_GREEK_SCALARS + n_obs,)),
                  ("lt", lt, (a, a)), ("par", par, (7, a)))
    try:
        for name, x, shape in shapes:
            check_operand(name, x, shape, lt.device)
    except ValueError as err:
        raise ValueError(
            f"{err}: the asset-major Greek kernel K32 takes 1..8 assets and "
            f"am_greek_ops' tables, the packed K33 more and "
            f"packed_greek_ops' ({a} assets given)") from None


def am_greek_partials(scal: torch.Tensor, lt: torch.Tensor,
                      par: torch.Tensor, seed: int, block_offset: int,
                      plan: Plan, n_blocks: int, n_obs: int):
    """The basket-Asian Greek partials ``((B, 4), (B, 4, a))`` of K32 (up
    to 8 assets, :func:`am_greek_ops`) or ``((B, 4), (B, 4, width))`` of
    K33 (beyond, :func:`packed_greek_ops`): the kernel for CUDA operands,
    the plain version for CPU operands; other devices raise."""
    a = lt.shape[0]
    if n_obs < 1:
        raise ValueError("n_obs must be >= 1")
    _check_greek_ops(scal, lt, par, n_obs)
    dev = lt.device
    am = use_asset_major(a)
    if dev.type == "cpu":
        plain = am_greek_plain_partials if am else packed_greek_plain_partials
        return plain(scal, lt, par, seed, block_offset, plan, n_blocks, n_obs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if am:
        out = _launch("mctpu_multi_walk_greeks_am",
                      (scal.data_ptr(), lt.data_ptr(), par.data_ptr()), a,
                      N_GREEK_SCALARS + 4 * a, seed, block_offset, plan,
                      n_blocks, n_obs, (), dev)
        LAUNCHES["basket_asian_greeks_am"] += 1
        return split_vec(out, a)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    a_tile, _, width = pack_factor(a)
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((n_blocks, N_GREEK_SCALARS), dtype=torch.float32,
                          device=dev)
        vecs = torch.empty((n_blocks, 4, width), dtype=torch.float32,
                           device=dev)
        status = lib.mctpu_multi_walk_greeks_packed(
            scal.data_ptr(), scal[N_GREEK_SCALARS:].data_ptr(), lt.data_ptr(),
            par.data_ptr(), a, n_obs, wrap_int32(seed),
            wrap_int32(block_offset), n_blocks, plan.rows, plan.iters,
            int(plan.antithetic), int(plan.kahan), a_tile, width,
            out.data_ptr(), vecs.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(status, "mctpu_multi_walk_greeks_packed")
    LAUNCHES["basket_asian_greeks_packed"] += 1
    return out, vecs


# ---------------------------------------------------------------------------
# K34: basket-barrier likelihood-ratio Greeks, asset-major
# ---------------------------------------------------------------------------
# The knock-out is discontinuous, so the scores differentiate the density of
# the draws (Glasserman 2004, sec. 7.3) through q_m = sum_{j >= m} Linv[j, m]
# z_j: delta_m = p qd_m / (s0_m v_m sqrt(dt)) (qd = q at the first date),
# vega_m = p (sum_j q_m (bt_m / v_m - sqrt(dt)) - n / v_m), rho = p sum_m
# sqrt(dt) / v_m sum_j q_m - t p (mctpu's _am_bar_greek_step and payoff).

def _am_bar_greek_walk(scal, lt, linv, par, n_obs, up, key, idx, shape,
                       sgn):
    a = lt.shape[0]
    k, t, barrier, sqdt = scal.unbind()

    def step(j, zs, carry):
        xs, qds, acc_q, acc_v, alive, _ = carry
        zs = [sgn * z for z in zs]
        xs, basket, bts, _ = _am_core(zs, xs, lt, par, a)
        qs = []
        for m in range(a):
            q = linv[m, m] * zs[m]
            for jj in range(m + 1, a):
                q = q + linv[jj, m] * zs[jj]
            qs.append(q)
        if j == 0:
            qds = qs
        acc_q = [acc_q[m] + qs[m] for m in range(a)]
        acc_v = [acc_v[m] + qs[m] * (bts[m] * par[5, m] - sqdt)
                 for m in range(a)]
        hit = basket < barrier if up else basket > barrier
        return xs, qds, acc_q, acc_v, alive * hit.to(alive.dtype), basket

    zero = torch.zeros(shape, dtype=torch.float32, device=lt.device)
    one = torch.ones(shape, dtype=torch.float32, device=lt.device)
    init = ([par[0, i].expand(shape) for i in range(a)], [zero] * a,
            [zero] * a, [zero] * a, one, zero)
    _, qds, acc_q, acc_v, alive, last = walk_pairwise_multi(
        key, idx, a, n_obs, step, init)
    p = alive * torch.clamp(last - k, min=0.0)
    score_r = acc_q[0] * par[7, 0]
    for m in range(1, a):
        score_r = score_r + acc_q[m] * par[7, m]
    gr = p * score_r - t * p
    dvals = [p * qds[m] * par[6, m] for m in range(a)]
    vvals = [p * (acc_v[m] - float(n_obs) * par[5, m]) for m in range(a)]
    return [p, gr] + dvals + vvals


def am_bar_greek_plain_partials(scal: torch.Tensor, lt: torch.Tensor,
                                linv: torch.Tensor, par: torch.Tensor,
                                seed: int, block_offset: int, plan: Plan,
                                n_blocks: int, n_obs: int, up: bool):
    """K34's per-block ``((B, 4), (B, 4, a))`` partials in plain PyTorch on
    the operands' device, over K30's stream."""
    return vec_greek_partials(
        lambda key, idx, shape, sgn: _am_bar_greek_walk(
            scal, lt, linv, par, n_obs, up, key, idx, shape, sgn),
        lt.shape[0], seed, block_offset, plan, n_blocks, lt.device)


@functools.lru_cache(maxsize=64)
def _bar_greek_scratch_floats(a: int, n_blocks: int, rows: int, iters: int,
                              cap: int) -> int:
    """Floats of scratch a K34 launch takes (its groups' outputs and the
    fold's carry; a function of the plan alone)."""
    return _build.library().mctpu_multi_walk_bar_greeks_am_scratch_floats(
        a, n_blocks, rows, iters, cap)


def am_bar_greek_partials(scal: torch.Tensor, lt: torch.Tensor,
                          linv: torch.Tensor, par: torch.Tensor, seed: int,
                          block_offset: int, plan: Plan, n_blocks: int,
                          n_obs: int, up: bool, scratch_cap: int = 0):
    """K34's ``((B, 4), (B, 4, a))`` partials: the kernel (a split walk and
    its fold, ``scratch_cap`` floats of scratch at most, 0 for 256 MB, past
    which it splits and folds simulation blocks and iterations in groups;
    the outputs do not depend on it) for CUDA operands, the plain version
    for CPU operands whatever the cap; other devices raise."""
    a = lt.shape[0]
    _check_am(a)
    dev = lt.device
    if dev.type == "cpu":
        return am_bar_greek_plain_partials(scal, lt, linv, par, seed,
                                           block_offset, plan, n_blocks,
                                           n_obs, up)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, x, shape in (("scal", scal, (4,)), ("lt", lt, (a, a)),
                           ("linv", linv, (a, a)), ("par", par, (8, a))):
        check_operand(name, x, shape, dev)
    floats = _bar_greek_scratch_floats(a, max(n_blocks, 1), plan.rows,
                                       plan.iters, scratch_cap)
    out = _launch("mctpu_multi_walk_bar_greeks_am",
                  (scal.data_ptr(), lt.data_ptr(), linv.data_ptr(),
                   par.data_ptr()), a, N_GREEK_SCALARS + 4 * a, seed,
                  block_offset, plan, n_blocks, n_obs, (up, scratch_cap), dev,
                  scratch_floats=floats)
    LAUNCHES["basket_barrier_greeks_am"] += 1
    return split_vec(out, a)


# ---------------------------------------------------------------------------
# K35: basket-barrier likelihood-ratio Greeks, lane-packed
# ---------------------------------------------------------------------------
# K34's scores on K31's walk (mctpu's _bar_greek_step and _bar_greek_payoff):
# per lane q = z L^-1 (q_m = sum_{j >= m} Linv[j, m] z_j), its first-date
# value qd, acc_q += q and acc_v += q (bt inv_v - sqrt(dt)); per path the
# knock-out flag and the last basket value; at the end dval = p qd cd and
# vval = p (acc_v - n inv_v) on each lane, rho = p sum_m acc_q sr - t p per
# path.  Per block K33's four scalar sums and (4, width) lane rows.

def packed_bar_greek_state(scal, lt, linv, par, n_obs, up, key, idx, shape,
                           sgn):
    """The state at the end of one packed LR walk: ``(x, qd, acc_q, acc_v)``
    per real lane ``(B, rows, c, a)``, the knock-out flag and the last
    basket value per path ``(B, rows, c)``.  ``L z`` and ``z L^-1`` are
    formed column by column from 0 (the zero terms add exactly 0), then
    ``+ d``."""
    a = lt.shape[0]
    a_tile, c, width = pack_factor(a)
    barrier, sqdt = scal[2], scal[3]
    log_s0, drift, vol, d, w, inv_v = par[:6].unbind()
    n_blocks, rows = shape[0], shape[1] // width

    def step(j, z, carry):
        x, qd, acc_q, acc_v, alive, _ = carry
        zp = (sgn * z).view(n_blocks, rows, c, a_tile)[..., :a]
        prod = torch.zeros_like(x)
        q = torch.zeros_like(x)
        for jj in range(a):
            zj = zp[..., jj:jj + 1]
            prod = prod + lt[:, jj] * zj
            q = q + linv[jj, :] * zj
        bt = prod + d
        x = x + drift + vol * bt
        if j == 0:
            qd = q
        acc_q = acc_q + q
        acc_v = acc_v + q * (bt * inv_v - sqdt)
        s = torch.exp(x)
        basket = torch.zeros_like(s[..., 0])
        for i in range(a):
            basket = basket + s[..., i] * w[i]
        hit = basket < barrier if up else basket > barrier
        return x, qd, acc_q, acc_v, alive * hit.to(alive.dtype), basket

    lanes = torch.zeros((n_blocks, rows, c, a), dtype=torch.float32,
                        device=lt.device)
    paths = lanes[..., 0]
    init = (log_s0.expand(n_blocks, rows, c, a), lanes, lanes, lanes,
            torch.ones_like(paths), paths)
    return walk_pairwise(key, idx, n_obs, step, init)


def _packed_bar_greek_walk(scal, lt, linv, par, n_obs, up, key, idx, shape,
                           sgn):
    """One packed LR walk -> ``(p, gr)`` per path ``(B, rows, c)`` and
    ``(dval, vval)`` per real lane ``(B, rows, c, a)``."""
    k, t = scal[0], scal[1]
    inv_v, cd, sr = par[5:].unbind()
    _, qd, acc_q, acc_v, alive, last = packed_bar_greek_state(
        scal, lt, linv, par, n_obs, up, key, idx, shape, sgn)
    p = alive * torch.clamp(last - k, min=0.0)
    score_r = torch.zeros_like(p)
    for m in range(lt.shape[0]):
        score_r = score_r + acc_q[..., m] * sr[m]
    gr = p * score_r - t * p
    pw = p.unsqueeze(-1)
    return p, gr, pw * qd * cd, pw * (acc_v - float(n_obs) * inv_v)


def packed_bar_greek_plain_partials(scal: torch.Tensor, lt: torch.Tensor,
                                    linv: torch.Tensor, par: torch.Tensor,
                                    seed: int, block_offset: int, plan: Plan,
                                    n_blocks: int, n_obs: int, up: bool):
    """K35's per-block ``((B, 4), (B, 4, width))`` partials in plain PyTorch
    on the operands' device, over K31's stream
    (:func:`packed_vec_partials`)."""
    return packed_vec_partials(
        lambda key, idx, shape, sgn: _packed_bar_greek_walk(
            scal, lt, linv, par, n_obs, up, key, idx, shape, sgn),
        pack_factor(lt.shape[0]), seed, block_offset, plan, n_blocks,
        lt.device)


def bar_greek_partials(scal: torch.Tensor, lt: torch.Tensor,
                       linv: torch.Tensor, par: torch.Tensor, seed: int,
                       block_offset: int, plan: Plan, n_blocks: int,
                       n_obs: int, up: bool):
    """The basket-barrier LR Greek partials: K34's ``((B, 4), (B, 4, a))``
    up to 8 assets (:func:`am_bar_greek_ops`' tables), K35's ``((B, 4),
    (B, 4, width))`` beyond (:func:`packed_bar_greek_ops`'); the kernel for
    CUDA operands, the plain version for CPU operands; other devices
    raise."""
    a = lt.shape[0]
    if use_asset_major(a):
        return am_bar_greek_partials(scal, lt, linv, par, seed, block_offset,
                                     plan, n_blocks, n_obs, up)
    if n_obs < 1:
        raise ValueError("n_obs must be >= 1")
    dev = lt.device
    if dev.type == "cpu":
        return packed_bar_greek_plain_partials(scal, lt, linv, par, seed,
                                               block_offset, plan, n_blocks,
                                               n_obs, up)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, x, shape in (("scal", scal, (4,)), ("lt", lt, (a, a)),
                           ("linv", linv, (a, a)), ("par", par, (8, a))):
        check_operand(name, x, shape, dev)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    a_tile, _, width = pack_factor(a)
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((n_blocks, N_GREEK_SCALARS), dtype=torch.float32,
                          device=dev)
        vecs = torch.empty((n_blocks, 4, width), dtype=torch.float32,
                           device=dev)
        status = lib.mctpu_multi_walk_bar_greeks_packed(
            scal.data_ptr(), lt.data_ptr(), linv.data_ptr(), par.data_ptr(),
            a, n_obs, wrap_int32(seed), wrap_int32(block_offset), n_blocks,
            plan.rows, plan.iters, int(plan.antithetic), int(plan.kahan),
            a_tile, width, int(up), out.data_ptr(), vecs.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(status, "mctpu_multi_walk_bar_greeks_packed")
    LAUNCHES["basket_barrier_greeks_packed"] += 1
    return out, vecs
