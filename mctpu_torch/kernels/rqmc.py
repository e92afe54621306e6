"""K52-K55: the randomized-QMC net kernels (``csrc/rqmc.cu``).

Counterpart of the Pallas kernels of :mod:`mctpu.qmc_engine`.  Each
replicate ``b`` is one digitally shifted copy of a Sobol net; its points
stream in chunks of ``ppc`` points (``plan.paths_per_iter``), point ``j``
of chunk ``i`` having the u32 index ``i * ppc + j``.  Per point and dim:
the 30-bit Sobol integer, XOR the shift's top 30 bits, the uniform
``bitcast((x >> 7) | 0x3F800000) - 1``, the Giles normal quantile
(:func:`mctpu_torch.math.norm_ppf_f32`), then the payoff:

* K52 ``rqmc_vanilla``: dim 0; ``max(+-(s0 e^{mu + sig z} - k), 0)``;
* K53 ``rqmc_greeks``: dim 0; the payoff and K6's seven Greek integrands
  (:func:`mctpu_torch.kernels.greeks._greek_tile`);
* K54 ``rqmc_basket``: ``a`` dims, one point per packed path; K3's basket
  (:func:`mctpu_torch.kernels.basket.packed_basket`);
* K55 ``rqmc_asian``: ``m`` dims driving a Brownian bridge
  (:func:`mctpu_torch.sobol.brownian_bridge_plan`) in draw order, then the
  adjacent-pair tree sum of ``s_j`` (arithmetic) or ``log s_j``
  (geometric), ``max(avg - k, 0)``.

Each chunk contributes its float32 sums ``(sum p, sum p^2)`` (16 sums for
K53), which a Neumaier carry adds in chunk order, as ``mctpu``'s
``acc_add_n`` does: the partials are the unfolded quads ``[s, c, s2, c2]``
per output, ``(R, 4)`` or ``(R, 32)``.  Replicate ``b`` of a launch at
``block_offset`` is shifted by the words of global replicate ``block_offset
+ b`` (:func:`rep_shifts`; the kernels draw them in place), so a
replicate's partials do not depend on the launch that holds it.

Each wrapper launches its CUDA kernel for CUDA operands and runs its plain
PyTorch version for CPU operands; any other device raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from mctpu_torch import _build
from mctpu_torch import math as mcmath
from mctpu_torch import sobol as msobol
from mctpu_torch.kernels import basket as kbasket
from mctpu_torch.kernels import greeks as kgreeks
from mctpu_torch.kernels import vanilla as kvanilla
from mctpu_torch.kernels.common import Plan, check_operand, sqrt32
from mctpu_torch.rng import M32, philox4x32, wrap_int32
from mctpu_torch.types import AsianOption, BasketOption, VanillaOption
from mctpu_torch.utils.accum import kahan_add

__all__ = ["LAUNCHES", "SHIFT_TAG", "rep_shifts", "u_from_bits30",
           "net_bits", "chunk_carry", "NetOperands", "vanilla_operands",
           "greek_operands", "basket_operands", "asian_operands",
           "vanilla_plain_partials", "vanilla_partials",
           "greek_plain_partials", "greek_partials",
           "basket_plain_partials", "basket_partials",
           "asian_plain_partials", "asian_partials"]

# Launches of the CUDA kernels in this process, by kernel name.
LAUNCHES = {"rqmc_vanilla": 0, "rqmc_greeks": 0, "rqmc_basket": 0,
            "rqmc_asian": 0}

BITS = 30
SHIFT_TAG = 0x51D5  # word 2 of the shifts' Philox counter
# Elements of one plain-version batch of chunks (replicates x points x
# dims) on the CPU and on a card: bounds its int64 temporaries.
_PLAIN_BATCH = {"cpu": 1 << 22, "cuda": 1 << 25}


def rep_shifts(k0: int, k1: int, block_offset: int, n_blocks: int,
               dim: int) -> torch.Tensor:
    """``(n_blocks, dim)`` u32 shift words (int64) of global replicates
    ``block_offset ..``: word 0 of Philox-4x32-10 under key ``(k0, k1)``
    at counter ``(block_offset + b, d, SHIFT_TAG, 0)``."""
    ids = (torch.arange(n_blocks, dtype=torch.int64) + block_offset) & M32
    didx = torch.arange(dim, dtype=torch.int64)
    w = philox4x32((k0 & M32, k1 & M32),
                   (ids[:, None], didx[None, :], SHIFT_TAG, 0))
    return w[0] & M32


def u_from_bits30(x: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) of 30-bit integers (int64): the top 23
    bits as a mantissa, ``bitcast((x >> 7) | 0x3F800000) - 1``."""
    return ((x >> 7) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def net_bits(chunks: torch.Tensor, ppc: int, v: torch.Tensor,
             shifts: torch.Tensor) -> torch.Tensor:
    """Shifted Sobol integers ``(R, nc, ppc, dim)`` (int64) of every point
    of ``chunks`` (``(nc,)`` int64): u32 index ``chunk * ppc + j``, ``v``
    the ``(dim, 30)`` direction numbers, ``shifts`` ``(R, dim)`` words."""
    j = torch.arange(ppc, dtype=torch.int64, device=chunks.device)
    idx = (chunks[:, None] * ppc + j[None, :]) & M32
    return msobol.sobol_bits(idx, v)[None] ^ (shifts[:, None, None, :] >> 2)


def chunk_carry(tiles: torch.Tensor) -> torch.Tensor:
    """``(R, iters, n)`` per-chunk float32 sums -> ``(R, 2n)`` Neumaier
    carries ``[s_0, c_0, s_1, c_1, ..]``, added in chunk order."""
    s = torch.zeros_like(tiles[:, 0])
    carry = (s, s)
    for i in range(tiles.shape[1]):
        carry = kahan_add(carry, tiles[:, i])
    return torch.stack(carry, -1).reshape(tiles.shape[0], -1)


@functools.lru_cache(maxsize=16)
def _tables(dim: int):
    """``(v, low)`` int64 numpy: the ``(dim, 30)`` direction numbers and
    the ``(dim, 32)`` Sobol integers of the points ``0 .. 31`` (the kernels
    form point ``n``'s integer as the XOR of its 32-aligned base's and of
    ``n & 31``'s, the construction being linear over XOR)."""
    v = msobol._directions()[:dim].astype(np.int64)
    lo = np.arange(32, dtype=np.int64)
    gray = lo ^ (lo >> 1)
    low = np.zeros((dim, 32), np.int64)
    for b in range(5):
        low ^= np.where(((gray >> b) & 1)[None, :] > 0, v[:, b:b + 1], 0)
    return v, low


def _i32(x) -> torch.Tensor:
    """u32 values (int64) as an int32 tensor of the same bits."""
    x = torch.as_tensor(x, dtype=torch.int64)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & M32


@dataclasses.dataclass(frozen=True)
class NetOperands:
    """A kernel's operands: ``par`` (float32 scalars or rows, per kernel),
    ``v`` ``(dim, 30)`` and ``low`` ``(dim, 32)`` int32 tables of the net,
    and for K54 the lower Cholesky factor ``lt`` ``(a, a)`` and K3's rows
    ``rows`` ``(5, a)``, for K55 the ``drift`` ``(m,)`` and ``bridge``
    ``(6, m)`` tables."""

    par: torch.Tensor
    v: torch.Tensor
    low: torch.Tensor
    lt: torch.Tensor | None = None
    rows: torch.Tensor | None = None
    drift: torch.Tensor | None = None
    bridge: torch.Tensor | None = None

    @property
    def dim(self) -> int:
        return self.v.shape[0]

    @property
    def device(self) -> torch.device:
        return self.par.device


@functools.lru_cache(maxsize=16)
def _device_tables(dim: int, device: str):
    """:func:`_tables` as contiguous int32 tensors on ``device``, formed
    once per (dim, device)."""
    return tuple(_i32(x).contiguous().to(device) for x in _tables(dim))


def _net(par, dim: int, device, **extra) -> NetOperands:
    v, low = _device_tables(dim, str(torch.device(device)))
    return NetOperands(par=par.contiguous().to(device), v=v, low=low,
                       **{k: x.contiguous().to(device)
                          for k, x in extra.items()})


def vanilla_operands(opt: VanillaOption, device) -> NetOperands:
    """K52: ``par = [s0, k, mu, sig]`` (K1's), the dim-0 tables."""
    return _net(kvanilla.params(opt, "cpu"), 1, device)


def greek_operands(opt: VanillaOption, device) -> NetOperands:
    """K53: ``par = [s, k, r, v, t, mu, sig, sqt]`` (K6's), the dim-0
    tables."""
    return _net(kgreeks.params(opt, "cpu"), 1, device)


def basket_operands(opt: BasketOption, chol, device) -> NetOperands:
    """K54: ``par = [k]``, K3's ``lt`` and rows (drift, vol, d, s0, w),
    the ``a``-dim tables."""
    if opt.n_assets > msobol.MAX_DIM:
        raise ValueError(f"sobol supports up to {msobol.MAX_DIM} dims")
    lt, rows = kbasket.pack_assets(opt, chol)
    return _net(torch.tensor([float(opt.k)], dtype=torch.float32),
                opt.n_assets, device, lt=lt, rows=rows)


def asian_operands(opt: AsianOption, device) -> NetOperands:
    """K55: ``par = [log s0, k, v, sqrt(t / m), 1/m]``, ``drift_j = (r -
    v^2/2) t_j`` with ``t_j = t j / m``, and the bridge ``[left, right,
    out, ca, cb, sds]`` (``sds = f32(sd) * sqrt(t / m)``), all float32 in
    ``mctpu``'s expression order."""
    m = opt.n_obs
    if m > msobol.MAX_DIM:
        raise ValueError(f"sobol asian supports n_obs <= {msobol.MAX_DIM}")
    s, k, r, v, t = (torch.tensor(float(x), dtype=torch.float32)
                     for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
    t_j = t * torch.arange(1, m + 1, dtype=torch.float32) / m
    drift = (r - 0.5 * v * v) * t_j
    step = sqrt32(t / m)
    log_s0 = torch.log(s.double()).float()
    par = torch.stack([log_s0, k, v, step,
                       torch.tensor(1.0 / m, dtype=torch.float32)])
    left, right, out, ca, cb, sd = msobol.brownian_bridge_plan(m)
    f32 = dict(dtype=torch.float32)
    sds = torch.tensor(sd, **f32) * step
    bridge = torch.stack([torch.tensor(left, **f32),
                          torch.tensor(right, **f32),
                          torch.tensor(out, **f32), torch.tensor(ca, **f32),
                          torch.tensor(cb, **f32), sds])
    return _net(par, m, device, drift=drift, bridge=bridge)


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def _plain(ops: NetOperands, key, block_offset: int, plan: Plan,
           n_blocks: int, tile_sums) -> torch.Tensor:
    """Chunk sums of ``tile_sums(z)`` (``z`` ``(R, nc, ppc, dim)`` normals
    -> list of ``(R, nc)`` sums), carried over the chunks in order."""
    dev = ops.device
    shifts = rep_shifts(*key, block_offset, n_blocks, ops.dim).to(dev)
    v = _u32(ops.v)
    ppc = plan.paths_per_iter
    per = max(1, _PLAIN_BATCH[dev.type] // (n_blocks * ppc * ops.dim))
    tiles = []
    for c0 in range(0, plan.iters, per):
        chunks = torch.arange(c0, min(c0 + per, plan.iters),
                              dtype=torch.int64, device=dev)
        z = mcmath.norm_ppf_f32(u_from_bits30(net_bits(chunks, ppc, v,
                                                       shifts)))
        tiles.append(torch.stack(tile_sums(z), -1))
    return chunk_carry(torch.cat(tiles, 1))


def _pay_sums(p):
    return [p.sum(-1), (p * p).sum(-1)]


def vanilla_plain_partials(ops: NetOperands, key, block_offset: int,
                           plan: Plan, n_blocks: int,
                           put: bool) -> torch.Tensor:
    """``(n_blocks, 4)`` quads in plain PyTorch on the operands' device."""
    s0, k, mu, sig = ops.par.unbind()

    def tile_sums(z):
        st = s0 * torch.exp(mu + sig * z[..., 0])
        return _pay_sums(torch.clamp(k - st if put else st - k, min=0.0))

    return _plain(ops, key, block_offset, plan, n_blocks, tile_sums)


def greek_plain_partials(ops: NetOperands, key, block_offset: int,
                         plan: Plan, n_blocks: int,
                         put: bool) -> torch.Tensor:
    """``(n_blocks, 32)``: 8 quads (payoff, delta, vega, rho, theta, gamma,
    vanna, volga) in plain PyTorch on the operands' device."""
    def tile_sums(z):
        out = []
        for q in kgreeks._greek_tile(ops.par, z[..., 0], False, put):
            out += _pay_sums(q)
        return out

    return _plain(ops, key, block_offset, plan, n_blocks, tile_sums)


def basket_plain_partials(ops: NetOperands, key, block_offset: int,
                          plan: Plan, n_blocks: int) -> torch.Tensor:
    """``(n_blocks, 4)`` quads in plain PyTorch on the operands' device:
    one packed path per point of the ``a``-dim net."""
    k = ops.par[0]

    def tile_sums(z):
        basket = kbasket.packed_basket(z, ops.lt, ops.rows)
        return _pay_sums(torch.clamp(basket - k, min=0.0))

    return _plain(ops, key, block_offset, plan, n_blocks, tile_sums)


def _tree(terms):
    """Adjacent-pair halving sum, an odd tail carried to the next level."""
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def asian_plain_partials(ops: NetOperands, key, block_offset: int,
                         plan: Plan, n_blocks: int,
                         geometric: bool) -> torch.Tensor:
    """``(n_blocks, 4)`` quads in plain PyTorch on the operands' device:
    the Brownian bridge in draw order, the tree sum of the dates."""
    log_s0, k, vol, _, inv_m = ops.par.unbind()
    m = ops.dim
    left, right, out = (ops.bridge[i].to(torch.int64).tolist()
                        for i in range(3))
    ca, cb, sds = ops.bridge[3], ops.bridge[4], ops.bridge[5]

    def tile_sums(z):
        w = [None] * m
        w[out[0]] = sds[0] * z[..., 0]
        for q in range(1, m):
            wb = cb[q] * w[right[q]]
            if left[q] >= 0:
                wb = ca[q] * w[left[q]] + wb
            w[out[q]] = wb + sds[q] * z[..., q]
        obs = []
        for j in range(m):
            log_s = (log_s0 + ops.drift[j]) + vol * w[j]
            obs.append(log_s if geometric else torch.exp(log_s))
        avg = _tree(obs) * inv_m
        if geometric:
            avg = torch.exp(avg)
        return _pay_sums(torch.clamp(avg - k, min=0.0))

    return _plain(ops, key, block_offset, plan, n_blocks, tile_sums)


# ---------------------------------------------------------------------------
# The CUDA launches
# ---------------------------------------------------------------------------

def _launch(name: str, ops: NetOperands, key, block_offset: int,
            plan: Plan, n_blocks: int, n_sums: int, head: tuple,
            tail: tuple, scratch_cap: int | None = None) -> torch.Tensor:
    """Launch ``mctpu_{name}`` (both passes) with ``head`` pointers before
    the net's tables and ``tail`` ints after the dims; the kernel draws the
    shifts itself from ``key`` and ``block_offset``.  With ``scratch_cap``
    (K55) the cap follows ``tail`` and the scratch that ``mctpu_{name}
    _scratch_floats`` sizes goes before the tiles.  Returns the
    ``(n_blocks, 2 n_sums)`` quads.  Raises on a failed launch."""
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    dev = ops.device
    for tname, x, width in (("v", ops.v, BITS), ("low", ops.low, 32)):
        if x.dtype != torch.int32 or tuple(x.shape) != (ops.dim, width) \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{tname} must be a contiguous int32 tensor of "
                             f"shape {(ops.dim, width)} on {dev}")
    if ops.dim > msobol.MAX_DIM:
        raise ValueError(f"sobol supports up to {msobol.MAX_DIM} dims")
    lib = _build.library()
    with torch.cuda.device(dev):
        tiles = torch.empty((n_blocks, plan.iters, n_sums),
                            dtype=torch.float32, device=dev)
        out = torch.empty((n_blocks, 2 * n_sums), dtype=torch.float32,
                          device=dev)
        split = ()
        if scratch_cap is not None:
            floats = getattr(lib, f"mctpu_{name}_scratch_floats")(
                n_blocks, plan.paths_per_iter, plan.iters, scratch_cap)
            scratch = torch.empty(floats, dtype=torch.float32, device=dev)
            split = (scratch_cap, scratch.data_ptr())
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        status = getattr(lib, f"mctpu_{name}")(
            *(x.data_ptr() for x in head), ops.v.data_ptr(),
            ops.low.data_ptr(), *(wrap_int32(w) for w in key),
            wrap_int32(block_offset), ops.dim, n_blocks,
            plan.paths_per_iter, plan.iters, *tail, *split, tiles.data_ptr(),
            out.data_ptr(), stream)
    _build.check(status, name)
    LAUNCHES[name] += 1
    return out


def _dispatch(cuda, plain, ops: NetOperands):
    if ops.device.type == "cuda":
        return cuda()
    if ops.device.type == "cpu":
        return plain()
    raise ValueError(f"unsupported device {ops.device}")


def vanilla_partials(ops: NetOperands, key, block_offset: int, plan: Plan,
                     n_blocks: int, put: bool) -> torch.Tensor:
    """``(n_blocks, 4)`` quads: K52 for CUDA operands, the plain version
    for CPU operands; any other device raises."""
    def cuda():
        check_operand("par", ops.par, (4,), ops.device)
        return _launch("rqmc_vanilla", ops, key, block_offset, plan,
                       n_blocks, 2, (ops.par,), (int(put),))

    return _dispatch(cuda, lambda: vanilla_plain_partials(
        ops, key, block_offset, plan, n_blocks, put), ops)


def greek_partials(ops: NetOperands, key, block_offset: int, plan: Plan,
                   n_blocks: int, put: bool) -> torch.Tensor:
    """``(n_blocks, 32)`` quads: K53 for CUDA operands, the plain version
    for CPU operands; any other device raises."""
    def cuda():
        check_operand("par", ops.par, (8,), ops.device)
        return _launch("rqmc_greeks", ops, key, block_offset, plan,
                       n_blocks, 16, (ops.par,), (int(put),))

    return _dispatch(cuda, lambda: greek_plain_partials(
        ops, key, block_offset, plan, n_blocks, put), ops)


def basket_partials(ops: NetOperands, key, block_offset: int, plan: Plan,
                    n_blocks: int) -> torch.Tensor:
    """``(n_blocks, 4)`` quads: K54 for CUDA operands, the plain version
    for CPU operands; any other device raises."""
    def cuda():
        a = ops.dim
        check_operand("par", ops.par, (1,), ops.device)
        check_operand("lt", ops.lt, (a, a), ops.device)
        check_operand("rows", ops.rows, (5, a), ops.device)
        return _launch("rqmc_basket", ops, key, block_offset, plan,
                       n_blocks, 2, (ops.par, ops.lt, ops.rows), ())

    return _dispatch(cuda, lambda: basket_plain_partials(
        ops, key, block_offset, plan, n_blocks), ops)


def asian_partials(ops: NetOperands, key, block_offset: int, plan: Plan,
                   n_blocks: int, geometric: bool,
                   scratch_cap: int = 0) -> torch.Tensor:
    """``(n_blocks, 4)`` quads: K55 for CUDA operands (a split net and its
    fold, ``scratch_cap`` floats of scratch at most, 0 for 256 MB, the
    quads the same), the plain version for CPU operands whatever the cap;
    any other device raises."""
    def cuda():
        m = ops.dim
        check_operand("par", ops.par, (5,), ops.device)
        check_operand("drift", ops.drift, (m,), ops.device)
        check_operand("bridge", ops.bridge, (6, m), ops.device)
        return _launch("rqmc_asian", ops, key, block_offset, plan,
                       n_blocks, 2, (ops.par, ops.drift, ops.bridge),
                       (int(geometric),), scratch_cap=scratch_cap)

    return _dispatch(cuda, lambda: asian_plain_partials(
        ops, key, block_offset, plan, n_blocks, geometric), ops)
