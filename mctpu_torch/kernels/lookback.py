"""K15 and K16: fused lookback-option Monte Carlo and its pathwise Greeks
(``csrc/lookback.cu``).

Counterpart of :mod:`mctpu.kernels.lookback`.  Each unit walks a log-space
GBM over ``n_obs`` dates on the walk kernels' stream (as K9's) and carries
the running extreme of the log-spot, which starts at the initial fixing
``log s0``: the minimum for the floating call and the fixed put, the
maximum for the floating put and the fixed call.  Two ``exp`` per path turn
the terminal log-spot and the extreme into the payoff.  ``mode`` is ``2 *
fixed + put``, the kernel's static variant.  The scalars are formed in
float32 on the CPU in the JAX kernels' expression order and moved to the
device.
"""
from __future__ import annotations

import torch

from mctpu_torch.kernels.common import (Plan, f32, launch_split_walk,
                                        launch_walk, walk_pairwise,
                                        walk_partials)
from mctpu_torch.kernels.common import walk_plan as make_plan
from mctpu_torch.models import asian as masian
from mctpu_torch.types import LookbackOption

__all__ = ["make_plan", "mode_of", "params", "plain_partials", "partials",
           "N_GREEK_SUMS", "GREEK_SCAL", "greek_params",
           "greek_plain_partials", "greek_partials", "LAUNCHES"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"lookback": 0, "lookback_greeks": 0}

N_GREEK_SUMS = 8  # (sum, sum^2) of: payoff, delta, vega, rho
# Entries of greek_params(), in the JAX kernel's scal order.
GREEK_SCAL = ("log_s0", "s0", "k", "drift", "vol", "inv_v", "c1", "dt", "t")


def mode_of(opt: LookbackOption) -> int:
    """The kernels' static variant: ``2 * fixed + put``."""
    return 2 * (opt.kind == "fixed") + (opt.payoff == "put")


def _split(mode: int):
    """``(fixed, put, use_min)`` of a mode: the floating call and the fixed
    put track the minimum."""
    fixed, put = bool(mode & 2), bool(mode & 1)
    return fixed, put, fixed == put


def params(opt: LookbackOption, device) -> torch.Tensor:
    """``[log s0, k, drift, vol]`` in float32 (K15's ``scal``)."""
    s, k = f32(opt.s, opt.k)
    drift, vol = masian.step_constants(opt)
    return torch.stack([torch.log(s), k, drift, vol]).to(device)


def _payoff(s, ext, k, fixed: bool, put: bool):
    """Terminal payoff from the spot and the running extreme."""
    if not fixed:
        return (ext - s) if put else (s - ext)
    return torch.clamp((k - ext) if put else (ext - k), min=0.0)


def _walk(par, n_obs: int, mode: int, key, idx, shape, sgn):
    """One pricing walk of a ``(n_blocks, rows * 128)`` tile -> payoffs."""
    log_s0, k, drift, vol = par.unbind()
    fixed, put, use_min = _split(mode)
    extreme = torch.minimum if use_min else torch.maximum

    def step(j, z, carry):
        log_s, log_ext = carry
        log_s = log_s + drift + vol * (sgn * z)
        return log_s, extreme(log_ext, log_s)

    init = (log_s0.expand(shape), log_s0.expand(shape))
    log_s, log_ext = walk_pairwise(key, idx, n_obs, step, init)
    return [_payoff(torch.exp(log_s), torch.exp(log_ext), k, fixed, put)]


def plain_partials(par: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int,
                   mode: int) -> torch.Tensor:
    """Per-block ``[sum_p, sum_p2]``, shape ``(n_blocks, 2)``, in plain
    PyTorch on ``par``'s device."""
    return walk_partials(
        lambda key, idx, shape, sgn: _walk(par, n_obs, mode, key, idx, shape,
                                           sgn),
        seed, block_offset, plan, n_blocks, par.device)


def partials(par: torch.Tensor, seed: int, block_offset: int, plan: Plan,
             n_blocks: int, n_obs: int, mode: int,
             scratch_cap: int = 0) -> torch.Tensor:
    """Per-block partials ``(n_blocks, 2)``: K15 for a CUDA ``par``, the
    plain version for a CPU ``par``; any other device raises.
    ``scratch_cap``: K15's scratch in floats at most (0: 256 MB), past which
    it splits and folds simulation blocks and iterations in groups; the
    outputs do not depend on it."""
    if par.device.type == "cuda":
        out = launch_split_walk("mctpu_lookback", par, 4, 2, seed,
                                block_offset, plan, n_blocks, n_obs, mode,
                                scratch_cap)
        LAUNCHES["lookback"] += 1
        return out
    if par.device.type == "cpu":
        return plain_partials(par, seed, block_offset, plan, n_blocks, n_obs,
                              mode)
    raise ValueError(f"unsupported device {par.device}")


# ---------------------------------------------------------------------------
# K16: pathwise delta, vega and rho
# ---------------------------------------------------------------------------
# Every s_j is proportional to s0, so delta is p / s0 for the floating kind
# and +-1{itm} ext / s0 for the fixed one.  d(s_j)/dv = s_j f_j with f_j =
# (log s_j - log s0) / v + c1 (j + 1), and d(s_j)/dr = t_j s_j: the walk
# carries f and t at the arg-extreme beside the extreme, updated by the
# same strict compare (a tie keeps the earlier date), and the running
# scalars cj = c1 (j + 1) and tj = t_j as sums, as the JAX kernel does.
# Rho folds in the -t p discount term.  A fixed strike at k == s0 puts
# mass on the payoff's kink (the extreme has an atom at s0), where the
# estimator returns the left derivative.


def greek_params(opt: LookbackOption, device) -> torch.Tensor:
    """K16's float32 ``scal`` (:data:`GREEK_SCAL`), formed in the JAX
    kernel's expression order."""
    s, k, r, v, t = f32(opt.s, opt.k, opt.r, opt.v, opt.t)
    drift, vol = masian.step_constants(opt)
    dt = t / opt.n_obs
    inv_v = 1.0 / v
    c1 = -(r + 0.5 * v * v) * dt * inv_v
    return torch.stack([torch.log(s), s, k, drift, vol, inv_v, c1, dt,
                        t]).to(device)


def _greek_epilogue(sc, n_obs: int, fixed: bool, put: bool, log_s, log_ext,
                    f_ext, t_ext):
    """``[p, gd, gv, gr]`` tiles from the final walk state (``mctpu``'s
    ``_greek_epilogue``; ``/ s0`` divides by the device scalar, so it is an
    IEEE division on every device)."""
    s_t = torch.exp(log_s)
    ext = torch.exp(log_ext)
    f_t = (log_s - sc["log_s0"]) * sc["inv_v"] + sc["c1"] * n_obs
    k, s0, t = sc["k"], sc["s0"], sc["t"]
    if not fixed:
        p = (ext - s_t) if put else (s_t - ext)
        gd = p / s0
        gv = s_t * f_t - ext * f_ext
        gr = ext * (t - t_ext)
        if put:
            gv, gr = -gv, -gr
    elif put:  # ext tracks the minimum
        ind = (ext < k).to(ext.dtype)
        p = torch.clamp(k - ext, min=0.0)
        gd = -ind * ext / s0
        gv = -ind * ext * f_ext
        gr = -ind * t_ext * ext - t * p
    else:      # ext tracks the maximum
        ind = (ext > k).to(ext.dtype)
        p = torch.clamp(ext - k, min=0.0)
        gd = ind * ext / s0
        gv = ind * ext * f_ext
        gr = ind * t_ext * ext - t * p
    return [p, gd, gv, gr]


def _greek_walk(gp, n_obs: int, mode: int, key, idx, shape, sgn):
    """One Greeks walk of a ``(n_blocks, rows * 128)`` tile -> the four
    per-path integrands (``mctpu``'s ``_greek_step_fn``)."""
    sc = dict(zip(GREEK_SCAL, gp.unbind()))
    log_s0, drift, vol = sc["log_s0"], sc["drift"], sc["vol"]
    inv_v, c1, dt = sc["inv_v"], sc["c1"], sc["dt"]
    fixed, put, use_min = _split(mode)

    def step(j, z, carry):
        log_s, log_ext, f_ext, t_ext, cj, tj = carry
        log_s = log_s + drift + vol * (sgn * z)
        tj = tj + dt
        f = (log_s - log_s0) * inv_v + cj
        upd = log_s < log_ext if use_min else log_s > log_ext
        return (log_s, torch.where(upd, log_s, log_ext),
                torch.where(upd, f, f_ext), torch.where(upd, tj, t_ext),
                cj + c1, tj)

    zero = torch.zeros(shape, dtype=torch.float32, device=gp.device)
    init = (log_s0.expand(shape), log_s0.expand(shape), zero, zero, c1,
            torch.zeros((), dtype=torch.float32, device=gp.device))
    log_s, log_ext, f_ext, t_ext, _, _ = walk_pairwise(key, idx, n_obs, step,
                                                       init)
    return _greek_epilogue(sc, n_obs, fixed, put, log_s, log_ext, f_ext,
                           t_ext)


def greek_plain_partials(gp: torch.Tensor, seed: int, block_offset: int,
                         plan: Plan, n_blocks: int, n_obs: int,
                         mode: int) -> torch.Tensor:
    """Per-block ``(n_blocks, 8)`` Greek partials in plain PyTorch on
    ``gp``'s device, over K15's stream."""
    return walk_partials(
        lambda key, idx, shape, sgn: _greek_walk(gp, n_obs, mode, key, idx,
                                                 shape, sgn),
        seed, block_offset, plan, n_blocks, gp.device)


def greek_partials(gp: torch.Tensor, seed: int, block_offset: int,
                   plan: Plan, n_blocks: int, n_obs: int,
                   mode: int) -> torch.Tensor:
    """``(n_blocks, 8)`` Greek partials: K16 for a CUDA ``gp``, the plain
    version for a CPU ``gp``; other devices raise."""
    if gp.device.type == "cuda":
        out = launch_walk("mctpu_lookback_greeks", gp, len(GREEK_SCAL),
                          N_GREEK_SUMS, seed, block_offset, plan, n_blocks,
                          n_obs, mode)
        LAUNCHES["lookback_greeks"] += 1
        return out
    if gp.device.type == "cpu":
        return greek_plain_partials(gp, seed, block_offset, plan, n_blocks,
                                    n_obs, mode)
    raise ValueError(f"unsupported device {gp.device}")
