"""K4 and K5: fused CVA Monte Carlo and its Greeks — exposure walks over a
time grid (``csrc/cva.cu``, ``csrc/cva_greeks.cu``).

Counterpart of :mod:`mctpu.kernels.cva`: the price kernel here, its Greeks
walk at the end of the module.  Each path walks a log-space GBM over ``n_grid`` steps; at node
``j`` the netted exposure ``max(sum_m w_m BS(S_j, k_m, T - t_j), 0)`` (Hastings
CDF, intrinsic at the last node) is weighted by the default mass ``dp_j``
(or a path-dependent wrong-way hazard), giving the per-path default leg
``lgd * sum_j dp_j ee_j``; the per-node exposure sums form the EE profile.

The node constants are computed once here, in float32 on the CPU in the JAX
kernel's expression order, and moved to the device, so the kernel and its
plain version read identical tables.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mctpu_torch import _build
from mctpu_torch import math as mcmath
from mctpu_torch.kernels.common import (LANES, Plan, acc_add, acc_final,
                                        acc_init, check_operand, iter_keys,
                                        tile_index, walk_pairwise,
                                        walk_partials)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import CvaPortfolioSpec
from mctpu_torch.utils.accum import ds_add

__all__ = ["make_plan", "Operands", "node_constants", "bs_node_constants",
           "wwr_node_constants", "operands", "plain_partials", "partials",
           "N_GREEK_SUMS", "GREEK_NODES", "GREEK_SCAL",
           "credit_delta_weights", "credit_gamma_weights",
           "wwr_grad_constants", "GreekOperands", "greek_tables",
           "greek_operands", "greek_plain_partials", "greek_partials",
           "LAUNCHES"]

# Launches of the CUDA kernel in this process, by kernel name.
LAUNCHES = {"cva": 0, "cva_greeks": 0}


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32)


def _grid(port: CvaPortfolioSpec):
    g = port.n_grid
    return g, _f32(port.t), torch.arange(1, g + 1, dtype=torch.float32)


def node_constants(port: CvaPortfolioSpec):
    """``(dp, t_rem, drift, vol)``: default-leg masses and remaining
    maturities per node, and the per-step GBM drift and vol (float32)."""
    g, t, j = _grid(port)
    r, v = _f32(port.r), _f32(port.v)
    dp = mcmath.default_leg_weights(port.intensity, port.t, g,
                                    dtype=torch.float32)
    t_rem = t * (g - j) / g
    dt = t / g
    drift = (r - 0.5 * v * v) * dt
    vol = v * torch.sqrt(dt)
    return dp, t_rem, drift, vol


def bs_node_constants(port: CvaPortfolioSpec):
    """``(c1, isig, vsig, disc)`` per node: ``d1 = (log s - log k + c1) *
    isig``, ``d2 = d1 - vsig``, price ``s N(d1) - k disc N(d2)``; the last
    node (zero remaining maturity) is clamped and takes the intrinsic."""
    g, t, j = _grid(port)
    r, v = _f32(port.r), _f32(port.v)
    t_rem = t * (g - j) / g
    t_safe = torch.clamp(t_rem, min=float(np.float32(1e-12)))
    vsig = v * torch.sqrt(t_safe)
    c1 = (r + 0.5 * v * v) * t_safe
    isig = 1.0 / vsig
    disc = torch.exp(-r * t_safe)
    return c1, isig, vsig, disc


def wwr_node_constants(port: CvaPortfolioSpec):
    """``(mu, inv_sig)`` standardizing ``ln(S_j / S_0)`` per node."""
    g, t, j = _grid(port)
    r, v = _f32(port.r), _f32(port.v)
    t_j = t * j / g
    mu = (r - 0.5 * v * v) * t_j
    inv_sig = 1.0 / (v * torch.sqrt(t_j))
    return mu, inv_sig


@dataclasses.dataclass(frozen=True)
class Operands:
    """Kernel operands, all float32: ``scal`` ``(10,)`` = s, r, v, lgd,
    drift, vol, intensity, wwr_b, dt, log s0; ``opts`` ``(3, M)`` =
    strikes, weights, log strikes; ``nodes`` ``(7, n_grid)`` = dp, c1,
    isig_bs, vsig, disc, mu, isig."""

    scal: torch.Tensor
    opts: torch.Tensor
    nodes: torch.Tensor

    @property
    def n_options(self) -> int:
        return self.opts.shape[1]

    @property
    def n_grid(self) -> int:
        return self.nodes.shape[1]

    @property
    def device(self) -> torch.device:
        return self.scal.device


def operands(port: CvaPortfolioSpec, device) -> Operands:
    """The kernel operands of ``port``, formed on the CPU, on ``device``."""
    dp, _, drift, vol = node_constants(port)
    c1, isig_bs, vsig, disc = bs_node_constants(port)
    mu, isig = wwr_node_constants(port)
    strikes, weights = _f32(port.strikes), _f32(port.weights)
    s, t = _f32(port.s), _f32(port.t)
    scal = torch.stack([s, _f32(port.r), _f32(port.v), _f32(port.lgd), drift,
                        vol, _f32(port.intensity), _f32(port.wwr_b),
                        t / port.n_grid, torch.log(s)])
    opts = torch.stack([strikes, weights, torch.log(strikes)])
    nodes = torch.stack([dp, c1, isig_bs, vsig, disc, mu, isig])
    return Operands(scal=scal.to(device), opts=opts.contiguous().to(device),
                    nodes=nodes.contiguous().to(device))


def _wwr_hazard_step(log_rel, surv, mu_j, isig_j, lam, bw, dt):
    """Wrong-way hazard ``h = lam exp(bw z - bw^2/2)`` at one node: new
    survival and this node's default mass (series form for small ``h dt``,
    the JAX kernel's guard against cancellation)."""
    zstd = (log_rel - mu_j) * isig_j
    h = lam * torch.exp(bw * zstd - 0.5 * bw * bw)
    y = h * dt
    series = y * (1.0 + y * (-0.5 + y * (1.0 / 6.0)))
    dp = surv * torch.where(y < 0.01, series, 1.0 - torch.exp(-y))
    return surv - dp, dp


def _exposure_log(s, log_s, opts, c1_j, isig_j, vsig_j, disc_j, last: bool,
                  log_lo=None):
    """Netted exposure at one node from the log-space walk state;
    ``log_lo`` is the double-single low word (``F32_DS``)."""
    strikes, weights, log_k = opts
    value = None
    for m in range(opts.shape[1]):
        if last:
            v_m = torch.clamp(s - strikes[m], min=0.0)
        else:
            d1 = (log_s - log_k[m] + c1_j) * isig_j
            if log_lo is not None:
                d1 = d1 + log_lo * isig_j
            d2 = d1 - vsig_j
            v_m = s * mcmath.norm_cdf_hastings(d1) \
                - strikes[m] * disc_j * mcmath.norm_cdf_hastings(d2)
        term = weights[m] * v_m
        value = term if value is None else value + term
    return torch.clamp(value, min=0.0)


def plain_partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
                   n_blocks: int, wwr: bool):
    """``((n_blocks, 2) [sum, sum2], (n_blocks, n_grid) exposure sums)`` in
    plain PyTorch on the operands' device; one ``(n_blocks, rows * 128)``
    tile walks the grid per iteration."""
    dev = ops.device
    g = ops.n_grid
    _, _, _, lgd, drift, vol, lam, bw, dt, log_s0 = ops.scal.unbind()
    dp, c1, isig_bs, vsig, disc, mu, isig = ops.nodes.unbind()
    shape = (n_blocks, plan.rows * LANES)
    idx = tile_index(shape[1], dev)
    prof = torch.zeros((n_blocks, g, LANES), dtype=torch.float32, device=dev)
    comp = torch.zeros_like(prof)
    sgn_half = 0.5 if plan.antithetic else 1.0
    carry = acc_init(n_blocks, dev)

    def step(j, z, state, sgn):
        log_st, surv, acc = state
        inc = drift + vol * (sgn * z)
        last = j == g - 1
        if plan.ds:
            hi, lo = ds_add(log_st[0], log_st[1], inc)
            log_st = (hi, lo)
            s = torch.exp(hi) * (1.0 + lo)
            ee = _exposure_log(s, hi, ops.opts, c1[j], isig_bs[j], vsig[j],
                               disc[j], last, log_lo=lo)
            log_rel = (hi - log_s0) + lo
        else:
            log_st = log_st + inc
            s = torch.exp(log_st)
            ee = _exposure_log(s, log_st, ops.opts, c1[j], isig_bs[j],
                               vsig[j], disc[j], last)
            log_rel = log_st - log_s0
        if wwr:
            surv, dp_j = _wwr_hazard_step(log_rel, surv, mu[j], isig[j], lam,
                                          bw, dt)
        else:
            dp_j = dp[j]
        acc = acc + dp_j * ee
        # Exposure profile: per-lane row sums, Kahan-added over iterations
        # exactly as the TPU kernel does (its fold adds the compensation).
        row = sgn_half * ee.view(n_blocks, plan.rows, LANES).sum(1)
        if plan.kahan:
            y = row - comp[:, j]
            acc_j = prof[:, j]
            t = acc_j + y
            comp[:, j] = (t - acc_j) - y
            prof[:, j] = t
        else:
            prof[:, j] += row
        return log_st, surv, acc

    def walk(key, sgn):
        full = log_s0.expand(shape)
        zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
        init = ((full, zeros) if plan.ds else full,
                torch.ones(shape, dtype=torch.float32, device=dev), zeros)
        _, _, acc = walk_pairwise(
            key, idx, g, lambda j, z, st: step(j, z, st, sgn), init)
        return lgd * acc

    for i in range(plan.iters):
        key = iter_keys(seed, block_offset, plan.iters, i, n_blocks, dev)
        if plan.antithetic:
            cva_tile = 0.5 * (walk(key, 1.0) + walk(key, -1.0))
        else:
            cva_tile = walk(key, 1.0)
        carry = acc_add(carry, cva_tile.sum(1), (cva_tile * cva_tile).sum(1),
                        plan.kahan)
    return acc_final(carry), (prof + comp).sum(-1)


def _check(ops: Operands):
    m, g = ops.n_options, ops.n_grid
    for name, x, shape in (("scal", ops.scal, (10,)),
                           ("opts", ops.opts, (3, m)),
                           ("nodes", ops.nodes, (7, g))):
        check_operand(name, x, shape, ops.device)


def _cuda_partials(ops: Operands, seed, block_offset, plan, n_blocks, wwr):
    _check(ops)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    g = ops.n_grid
    lib = _build.library()
    with torch.cuda.device(ops.device):
        out = torch.empty((n_blocks, 2), dtype=torch.float32,
                          device=ops.device)
        ee = torch.empty((n_blocks, g), dtype=torch.float32, device=ops.device)
        scratch = torch.empty(
            lib.mctpu_cva_scratch_floats(g, n_blocks, plan.rows, plan.iters),
            dtype=torch.float32, device=ops.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        status = lib.mctpu_cva(
            ops.scal.data_ptr(), ops.opts.data_ptr(), ops.nodes.data_ptr(),
            ops.n_options, g, wrap_int32(seed), wrap_int32(block_offset),
            n_blocks, plan.rows, plan.iters, int(plan.antithetic),
            int(plan.kahan), int(plan.ds), int(wwr), scratch.data_ptr(),
            out.data_ptr(), ee.data_ptr(), stream)
    _build.check(status, "cva")
    LAUNCHES["cva"] += 1
    return out, ee


def partials(ops: Operands, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, wwr: bool):
    """``((n_blocks, 2), (n_blocks, n_grid))`` partials: K4 for CUDA
    operands, the plain version for CPU operands; other devices raise.
    ``wwr`` selects the wrong-way hazard leg (set iff ``wwr_b != 0``)."""
    if ops.device.type == "cuda":
        return _cuda_partials(ops, seed, block_offset, plan, n_blocks, wwr)
    if ops.device.type == "cpu":
        return plain_partials(ops, seed, block_offset, plan, n_blocks, wwr)
    raise ValueError(f"unsupported device {ops.device}")


# ---------------------------------------------------------------------------
# K5: the CVA Greeks walk (csrc/cva_greeks.cu)
# ---------------------------------------------------------------------------
# CVA + credit delta, spot delta, vega, spot gamma, credit gamma and cross
# gamma (mctpu.kernels.cva, Greeks section): pathwise through the smooth BS
# exposure at inner nodes, mixed pathwise-LR at the terminal node, and under
# wrong-way risk forward-mode hazard tangents carried through the walk.  The
# stream and plan are K4's (reseed per (block, iteration), pairs of steps
# per draw, the antithetic mirror replaying the same draws), without the
# double-single walk state: the JAX Greeks path plans without ``ds``.

N_GREEK_SUMS = 14  # (sum, sum^2) of: cva, credit delta, spot delta, vega,
#                    spot gamma, credit gamma, cross gamma
_INV_SQRT_2PI = 0.3989422804014327

# Rows of GreekOperands.nodes, one value per grid node.
GREEK_NODES = ("dp", "ddp", "ddp2", "c1", "isigbs", "vsig", "disc", "mu",
               "isig", "dmu", "disig", "tz")
# Entries of GreekOperands.scal.
GREEK_SCAL = ("drift", "vol", "v_dt", "sqdt", "inv_v", "inv_s0", "log_s0",
              "lam", "bw", "dt", "lgd", "v_t", "isqt")


def credit_delta_weights(port: CvaPortfolioSpec) -> torch.Tensor:
    """``d(dp_j)/dlambda`` per node of the deterministic default leg."""
    g = port.n_grid
    t, lam = _f32(port.t), _f32(port.intensity)
    tj = t * torch.arange(0, g + 1, dtype=torch.float32) / g
    w = tj * torch.exp(-lam * tj)
    return w[1:] - w[:-1]


def credit_gamma_weights(port: CvaPortfolioSpec) -> torch.Tensor:
    """``d2(dp_j)/dlambda2 = t_{j-1}^2 e^{-lam t_{j-1}} - t_j^2 e^{-lam
    t_j}`` per node."""
    g = port.n_grid
    t, lam = _f32(port.t), _f32(port.intensity)
    tj = t * torch.arange(0, g + 1, dtype=torch.float32) / g
    u = tj * tj * torch.exp(-lam * tj)
    return u[:-1] - u[1:]


def wwr_grad_constants(port: CvaPortfolioSpec):
    """``(dmu, disig)``: vega sensitivities of the WWR standardization,
    ``-v t_j`` and ``-1 / (v^2 sqrt(t_j))``."""
    g, t, j = _grid(port)
    v = _f32(port.v)
    t_j = t * j / g
    return -v * t_j, -1.0 / (v * v * torch.sqrt(t_j))


@dataclasses.dataclass(frozen=True)
class GreekOperands:
    """K5's float32 operands: ``scal`` ``(13,)`` (:data:`GREEK_SCAL`),
    ``opts`` ``(3, M)`` = strikes, weights, log strikes, and ``nodes``
    ``(12, n_grid)`` (:data:`GREEK_NODES`)."""

    scal: torch.Tensor
    opts: torch.Tensor
    nodes: torch.Tensor

    @property
    def n_options(self) -> int:
        return self.opts.shape[1]

    @property
    def n_grid(self) -> int:
        return self.nodes.shape[1]

    @property
    def device(self) -> torch.device:
        return self.scal.device


def greek_tables(port: CvaPortfolioSpec):
    """``(nodes, scal)`` dicts of float32 tensors, ``_greek_tables``'
    values in its expression order."""
    dp, _, drift, vol = node_constants(port)
    c1, isig_bs, vsig, disc = bs_node_constants(port)
    mu, isig = wwr_node_constants(port)
    dmu, disig = wwr_grad_constants(port)
    g, t, j = _grid(port)
    v, s = _f32(port.v), _f32(port.s)
    nodes = {"dp": dp, "ddp": credit_delta_weights(port),
             "ddp2": credit_gamma_weights(port), "c1": c1,
             "isigbs": isig_bs, "vsig": vsig, "disc": disc, "mu": mu,
             "isig": isig, "dmu": dmu, "disig": disig,
             "tz": v * (t * j / g) / torch.sqrt(t)}
    dt = t / g
    scal = {"drift": drift, "vol": vol, "v_dt": v * dt,
            "sqdt": torch.sqrt(dt), "inv_v": 1.0 / v, "inv_s0": 1.0 / s,
            "log_s0": torch.log(s), "lam": _f32(port.intensity),
            "bw": _f32(port.wwr_b), "dt": dt, "lgd": _f32(port.lgd),
            "v_t": v * t, "isqt": 1.0 / torch.sqrt(t)}
    return nodes, scal


def greek_operands(port: CvaPortfolioSpec, device) -> GreekOperands:
    """K5's operands, formed on the CPU and moved to ``device``."""
    nodes, scal = greek_tables(port)
    strikes, weights = _f32(port.strikes), _f32(port.weights)
    opts = torch.stack([strikes, weights, torch.log(strikes)])
    return GreekOperands(
        scal=torch.stack([scal[k] for k in GREEK_SCAL]).to(device),
        opts=opts.contiguous().to(device),
        nodes=torch.stack([nodes[k] for k in GREEK_NODES]).contiguous()
        .to(device))


def _exposure_grads(s, log_s, opts, c1_j, isig_j, vsig_j, disc_j, inv_v,
                    last: bool):
    """``(ee, dV/ds, vega_bs, gam_bs, gl)`` at one node (``mctpu``'s
    ``_exposure_grads``): the netted exposure, its spot slope, its explicit
    BS vega, the inner-node BS gamma times ``s`` and the terminal node's LR
    option factor ``sum w_m k_m 1{s > k_m}``, each gated by ``1{V > 0}``."""
    strikes, weights, log_k = opts
    value = dvds = veg = gam = gl = None
    for m in range(opts.shape[1]):
        w_m = weights[m]
        itm = (s > strikes[m]).to(s.dtype)
        if last:
            v_m = torch.clamp(s - strikes[m], min=0.0)
            dv_m = itm
            veg_m = torch.zeros_like(s)
            gam_m = torch.zeros_like(s)  # unused at the last node
        else:
            d1 = (log_s - log_k[m] + c1_j) * isig_j
            d2 = d1 - vsig_j
            nd1 = mcmath.norm_cdf_hastings(d1)
            v_m = s * nd1 - strikes[m] * disc_j * mcmath.norm_cdf_hastings(d2)
            dv_m = nd1
            phi = _INV_SQRT_2PI * torch.exp(-0.5 * d1 * d1)
            veg_m = s * phi * vsig_j * inv_v
            gam_m = phi * isig_j
        gl_m = strikes[m] * itm
        terms = (w_m * v_m, w_m * dv_m, w_m * veg_m, w_m * gam_m, w_m * gl_m)
        if value is None:
            value, dvds, veg, gam, gl = terms
        else:
            value, dvds, veg, gam, gl = (
                x + y for x, y in zip((value, dvds, veg, gam, gl), terms))
    ind = (value > 0.0).to(s.dtype)
    return (torch.clamp(value, min=0.0), ind * dvds, ind * veg, ind * gam,
            ind * gl)


def _wwr_hazard_step_grads(log_rel, dxv, surv, dsl, dsv, csum, dsz, mu_j,
                           isig_j, dmu_j, disig_j, tz_j, lam, bw, dt):
    """One WWR hazard step with forward-mode (lambda, v, z-tilt) tangents
    (``mctpu``'s ``_wwr_hazard_step_grads``): new ``(surv, dsl, dsv, csum,
    dsz)`` and the node's ``(dp, ddp_l, ddp_v, ddp2_l, ddp_z)``."""
    zstd = (log_rel - mu_j) * isig_j
    h = lam * torch.exp(bw * zstd - 0.5 * bw * bw)
    y = h * dt
    series = y * (1.0 + y * (-0.5 + y * (1.0 / 6.0)))
    emy = torch.exp(-y)
    e = torch.where(y < 0.01, series, 1.0 - emy)
    dp = surv * e
    de_dh = emy * dt
    dh_dl = h / lam
    dh_dv = h * bw * ((dxv - dmu_j) * isig_j + (log_rel - mu_j) * disig_j)
    dh_dz = h * bw * isig_j * tz_j
    ddp_l = dsl * e + surv * de_dh * dh_dl
    ddp_v = dsv * e + surv * de_dh * dh_dv
    ddp_z = dsz * e + surv * de_dh * dh_dz
    surv_new = surv - dp
    csum_new = csum + dt * dh_dl
    ddp2_l = csum * csum * surv - csum_new * csum_new * surv_new
    return (surv_new, dsl - ddp_l, dsv - ddp_v, csum_new, dsz - ddp_z,
            dp, ddp_l, ddp_v, ddp2_l, ddp_z)


def _greek_walk(ops: GreekOperands, key, idx, shape, sgn: float, wwr: bool):
    """One Greeks walk of a ``(n_blocks, rows * 128)`` tile -> the seven
    per-path outputs, each times ``lgd`` (``mctpu``'s ``_greek_step``)."""
    g = ops.n_grid
    sc = dict(zip(GREEK_SCAL, ops.scal.unbind()))
    tb = dict(zip(GREEK_NODES, ops.nodes.unbind()))
    inv_s0_2 = sc["inv_s0"] * sc["inv_s0"]
    gl_scale = inv_s0_2 * sc["inv_v"] * sc["isqt"]
    dev = ops.device
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    state = {"log_s": sc["log_s0"].expand(shape), "dxv": zero}
    if wwr:
        state.update(surv=torch.ones(shape, dtype=torch.float32, device=dev),
                     dsl=zero, dsv=zero, csum=zero, dsz=zero)
    acc = [zero] * 7  # a, al, ad, av, ag, acg, axg

    def step(j, z, _):
        a, al, ad, av, ag, acg, axg = acc
        zs = sgn * z
        log_s = state["log_s"] + sc["drift"] + sc["vol"] * zs
        dxv = state["dxv"] - sc["v_dt"] + sc["sqdt"] * zs
        state.update(log_s=log_s, dxv=dxv)
        s = torch.exp(log_s)
        last = j == g - 1
        ee, dvds, veg_bs, gam_bs, gl = _exposure_grads(
            s, log_s, ops.opts, tb["c1"][j], tb["isigbs"][j], tb["vsig"][j],
            tb["disc"][j], sc["inv_v"], last)
        dee_ds0 = dvds * s * sc["inv_s0"]
        dee_dv = dvds * s * dxv + veg_bs
        z_std = (dxv + sc["v_t"]) * sc["isqt"]
        if wwr:
            (surv, dsl, dsv, csum, dsz, dp_j, ddp_l, ddp_v, ddp2_j,
             ddp_z) = _wwr_hazard_step_grads(
                log_s - sc["log_s0"], dxv, state["surv"], state["dsl"],
                state["dsv"], state["csum"], state["dsz"], tb["mu"][j],
                tb["isig"][j], tb["dmu"][j], tb["disig"][j], tb["tz"][j],
                sc["lam"], sc["bw"], sc["dt"])
            state.update(surv=surv, dsl=dsl, dsv=dsv, csum=csum, dsz=dsz)
            av = av + dp_j * dee_dv + ddp_v * ee
        else:
            dp_j, ddp_l, ddp2_j = tb["dp"][j], tb["ddp"][j], tb["ddp2"][j]
            ddp_z = 0.0
            av = av + dp_j * dee_dv
        a = a + dp_j * ee
        al = al + ddp_l * ee
        ad = ad + dp_j * dee_ds0
        if last:
            ag = ag + (dp_j * z_std - ddp_z) * (gl * gl_scale)
        else:
            ag = ag + dp_j * gam_bs * s * inv_s0_2
        acg = acg + ddp2_j * ee
        axg = axg + ddp_l * dee_ds0
        acc[:] = [a, al, ad, av, ag, acg, axg]

    walk_pairwise(key, idx, g, step, None)
    return [sc["lgd"] * q for q in acc]


def greek_plain_partials(ops: GreekOperands, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int, wwr: bool):
    """Per-block ``(n_blocks, 14)`` Greek partials in plain PyTorch on the
    operands' device, over K4's stream."""
    return walk_partials(
        lambda key, idx, shape, sgn: _greek_walk(ops, key, idx, shape, sgn,
                                                 wwr),
        seed, block_offset, plan, n_blocks, ops.device)


def _greek_cuda_partials(ops: GreekOperands, seed, block_offset, plan,
                         n_blocks, wwr):
    m, g = ops.n_options, ops.n_grid
    for name, x, shape in (("scal", ops.scal, (len(GREEK_SCAL),)),
                           ("opts", ops.opts, (3, m)),
                           ("nodes", ops.nodes, (len(GREEK_NODES), g))):
        check_operand(name, x, shape, ops.device)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    lib = _build.library()
    with torch.cuda.device(ops.device):
        out = torch.empty((n_blocks, N_GREEK_SUMS), dtype=torch.float32,
                          device=ops.device)
        scratch = torch.empty(
            lib.mctpu_cva_greeks_scratch_floats(g, n_blocks, plan.rows,
                                                plan.iters),
            dtype=torch.float32, device=ops.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        status = lib.mctpu_cva_greeks(
            ops.scal.data_ptr(), ops.opts.data_ptr(), ops.nodes.data_ptr(),
            m, g, wrap_int32(seed), wrap_int32(block_offset), n_blocks,
            plan.rows, plan.iters, int(plan.antithetic), int(plan.kahan),
            int(wwr), scratch.data_ptr(), out.data_ptr(), stream)
    _build.check(status, "cva_greeks")
    LAUNCHES["cva_greeks"] += 1
    return out


def greek_partials(ops: GreekOperands, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, wwr: bool) -> torch.Tensor:
    """``(n_blocks, 14)`` Greek partials: K5 for CUDA operands, the plain
    version for CPU operands; other devices raise."""
    if ops.device.type == "cuda":
        return _greek_cuda_partials(ops, seed, block_offset, plan, n_blocks,
                                    wwr)
    if ops.device.type == "cpu":
        return greek_plain_partials(ops, seed, block_offset, plan, n_blocks,
                                    wwr)
    raise ValueError(f"unsupported device {ops.device}")
