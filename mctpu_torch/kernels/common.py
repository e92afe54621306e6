"""Shared kernel plumbing: the launch plan and the in-kernel random stream.

Counterpart of :mod:`mctpu.kernels.common`.  The stream is the one every
JAX kernel draws in interpret mode:

* key: the seed words (int32, read as u32) folded with the murmur3
  finalizer ``_mix32`` into a Philox key ``(k0, k1)`` (:func:`seed_key`);
* counter: (flat tile element index, draw counter, call-site tag, 0);
* normals: Box-Muller of the first two Philox words (:func:`draw_normal_pair`).

The CUDA kernels draw the same stream from ``csrc/philox.cuh``; the plain
versions in ``kernels/*.py`` draw it here, vectorised over blocks.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from mctpu_torch import _build
from mctpu_torch import rng as mcrng
from mctpu_torch.rng import M32, wrap_int32
from mctpu_torch.utils.accum import kahan_add

__all__ = ["LANES", "Plan", "walk_plan", "seed_key", "block_keys",
           "iter_keys", "tile_index", "draw_normal_pair", "walk_pairwise",
           "walk_pairwise_multi", "walk_steps", "walk_partials", "acc_init",
           "acc_add", "acc_final", "acc_init_n", "acc_add_n", "acc_final_n",
           "det_col_sums", "N_GREEK_SCALARS", "split_vec",
           "vec_greek_partials", "check_operand", "f32", "sqrt32",
           "launch_walk", "launch_split_walk", "launch_items",
           "check_level", "terminal_partials"]

# Lane width of one path tile: tiles are (rows, LANES) with the flat element
# index row * LANES + lane, as the JAX kernels lay them out.
LANES = 128


@dataclasses.dataclass(frozen=True)
class Plan:
    """Static launch geometry of one Monte Carlo run.

    ``num_blocks`` simulation blocks each run ``iters`` iterations over a
    ``(rows, LANES)`` tile; ``paths_per_iter`` GBM paths and
    ``units_per_iter`` i.i.d. estimator samples (pairs under antithetic)
    per block iteration.  ``kahan`` compensates the per-block sums and
    ``ds`` carries the CVA walk state as a double-single pair.
    """

    num_blocks: int
    iters: int
    rows: int
    paths_per_iter: int
    units_per_iter: int
    antithetic: bool
    kahan: bool = True
    ds: bool = False

    @property
    def paths_per_block(self) -> int:
        return self.iters * self.paths_per_iter

    @property
    def total_paths(self) -> int:
        return self.num_blocks * self.paths_per_block

    @property
    def total_units(self) -> int:
        return self.num_blocks * self.iters * self.units_per_iter

    @staticmethod
    def plan(n_paths: int, num_blocks: int, rows: int, paths_per_iter: int,
             units_per_iter: int, antithetic: bool, kahan: bool,
             ds: bool = False) -> "Plan":
        """Round ``n_paths`` up to whole (block, iteration) tiles."""
        iters = max(1, -(-n_paths // (num_blocks * paths_per_iter)))
        return Plan(num_blocks=num_blocks, iters=iters, rows=rows,
                    paths_per_iter=paths_per_iter,
                    units_per_iter=units_per_iter, antithetic=antithetic,
                    kahan=kahan, ds=ds)


def walk_plan(n_paths: int, num_blocks: int, rows: int, antithetic: bool,
              kahan: bool = True, ds: bool = False) -> Plan:
    """Plan of a walk kernel (CVA, Asian, barrier): one ``(rows, 128)``
    tile of units walks the grid per block iteration, two mirrored paths
    per unit under antithetic."""
    units = rows * LANES
    paths = units * (2 if antithetic else 1)
    return Plan.plan(n_paths, num_blocks, rows, paths, units, antithetic,
                     kahan, ds)


def _mix32(x):
    """murmur3 finalizer on u32 values (int64 tensor or int)."""
    x = x ^ (x >> 16)
    x = mcrng.mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mcrng.mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def seed_key(*words):
    """Philox key ``(k0, k1)`` of the seed words (ints or int64 tensors,
    int32 values read as u32) — the JAX ``seed_prng`` fold."""
    k0 = 0x9E3779B9
    for w in words:
        k0 = _mix32(k0 ^ (w & M32))
    return k0, _mix32(k0 ^ 0xBB67AE85)


def block_keys(seed: int, words, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys of ``seed_prng(seed, w)`` for each second word ``w``, as
    ``(n, 1)`` int64 tensors on ``device`` (one row per block)."""
    w = torch.as_tensor(words, dtype=torch.int64)
    k0, k1 = seed_key(seed, w)
    return k0.view(-1, 1).to(device), k1.view(-1, 1).to(device)


def iter_keys(seed: int, block_offset: int, iters: int, i: int,
              n_blocks: int, device):
    """Keys of the walk kernels' per-(block, iteration) reseed: block ``b``
    in iteration ``i`` draws under ``seed_prng(seed, (block_offset + b) *
    iters + i)``, int32 wrap, so the antithetic mirror can replay it."""
    words = [wrap_int32((block_offset + b) * iters + i)
             for b in range(n_blocks)]
    return block_keys(seed, words, device)


def tile_index(n: int, device) -> torch.Tensor:
    """Flat element index ``0..n-1`` of a tile, as int64 u32 values."""
    return torch.arange(n, dtype=torch.int64, device=device)


def draw_normal_pair(key, idx: torch.Tensor, ctr: int, tag: int = 0):
    """Both Box-Muller branches for every tile element: Philox block
    ``(idx, ctr, tag, 0)`` under ``key``; words 0 and 1 feed the transform."""
    b1, b2, _, _ = mcrng.philox4x32(key, (idx, ctr & M32, tag, 0))
    return mcrng.box_muller(b1, b2)


def acc_init(n_blocks: int, device):
    """Zeroed per-block ``((sum, comp), (sum2, comp2))`` float32 carries."""
    z = torch.zeros(n_blocks, dtype=torch.float32, device=device)
    return (z, z), (z, z)


def acc_add(carry, cs, cs2, kahan: bool):
    """Add one iteration's per-block tile sums (compensated if ``kahan``)."""
    a, b = carry
    if kahan:
        return kahan_add(a, cs), kahan_add(b, cs2)
    return (a[0] + cs, a[1]), (b[0] + cs2, b[1])


def acc_final(carry) -> torch.Tensor:
    """``(n_blocks, 2)`` partials ``[sum_p, sum_p2]`` with the compensation
    folded back in (zero without Kahan)."""
    (s, c), (s2, c2) = carry
    return torch.stack([s + c, s2 + c2], dim=1)


def f32(*xs):
    """Each of ``xs`` as a 0-d float32 CPU tensor, so that a kernel's
    scalars round as the JAX kernels' float32 operations do."""
    return (torch.tensor(float(x), dtype=torch.float32) for x in xs)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 scalar, as
    ``jnp.sqrt`` gives it on the CPU: taken in float64 and rounded once
    (``torch.sqrt`` on a CPU float32 tensor may miss by an ulp)."""
    return torch.sqrt(x.double()).float()


def check_operand(name: str, x: torch.Tensor, shape, device) -> None:
    """Raise unless ``x`` is a contiguous float32 tensor of ``shape`` on
    ``device`` (what a kernel's C entry point takes)."""
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{name} must be a contiguous float32 tensor of "
                         f"shape {tuple(shape)} on {device}")


def acc_init_n(n: int, n_blocks: int, device):
    """``n`` zeroed per-block ``(sum, comp)`` float32 carries."""
    z = torch.zeros(n_blocks, dtype=torch.float32, device=device)
    return tuple((z, z) for _ in range(n))


def acc_add_n(carry, vals, kahan: bool):
    """Add ``vals[i]`` (per-block iteration sums) into ``carry[i]``,
    compensated if ``kahan``."""
    if kahan:
        return tuple(kahan_add(c, v) for c, v in zip(carry, vals))
    return tuple((c[0] + v, c[1]) for c, v in zip(carry, vals))


def acc_final_n(carry) -> torch.Tensor:
    """``(n_blocks, n)`` partials with the compensations folded back in
    (zero without Kahan)."""
    return torch.stack([s + c for s, c in carry], dim=1)


def det_col_sums(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` by a fixed halving tree (``mctpu``'s
    ``det_col_sums``): rows ``[:h]`` and ``[h:2h]`` are added and an odd
    last row is carried, until one row is left."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        half = n // 2
        y = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
        if n % 2:
            y = torch.cat([y, x.narrow(dim, 2 * half, 1)], dim=dim)
        x = y
    return x.squeeze(dim)


def walk_pairwise(key, idx: torch.Tensor, n_steps: int, step_fn, carry):
    """Drive a walk that consumes both Box-Muller branches.

    Pair ``jj`` draws counter ``jj``; its cosine branch feeds step ``2jj``
    and its sine branch step ``2jj+1``.  An odd step count takes the cosine
    branch of counter ``n_steps // 2`` for its last step.  ``step_fn(j, z,
    carry) -> carry``.
    """
    half = n_steps // 2
    for jj in range(half):
        z1, z2 = draw_normal_pair(key, idx, jj)
        carry = step_fn(2 * jj, z1, carry)
        carry = step_fn(2 * jj + 1, z2, carry)
    if n_steps % 2:
        z1, _ = draw_normal_pair(key, idx, half)
        carry = step_fn(n_steps - 1, z1, carry)
    return carry


def walk_pairwise_multi(key, idx: torch.Tensor, n_draws: int, n_steps: int,
                        step_fn, carry):
    """Drive a walk that takes ``n_draws`` normals per step (one per asset)
    and consumes both Box-Muller branches.

    Pair ``jj`` draws counter ``jj * n_draws + i`` for draw ``i``; the
    cosine branches feed step ``2jj`` and the sine branches step ``2jj+1``.
    An odd step count takes the cosine branches of counters
    ``(n_steps // 2) * n_draws + i`` for its last step.  ``step_fn(j, zs,
    carry) -> carry`` with ``zs`` a list of ``n_draws`` tiles.
    """
    half = n_steps // 2
    for jj in range(half):
        pairs = [draw_normal_pair(key, idx, jj * n_draws + i)
                 for i in range(n_draws)]
        carry = step_fn(2 * jj, [z1 for z1, _ in pairs], carry)
        carry = step_fn(2 * jj + 1, [z2 for _, z2 in pairs], carry)
    if n_steps % 2:
        zs = [draw_normal_pair(key, idx, half * n_draws + i)[0]
              for i in range(n_draws)]
        carry = step_fn(n_steps - 1, zs, carry)
    return carry


def walk_steps(key, idx: torch.Tensor, n_steps: int, step_fn, carry):
    """Drive a walk that takes one Box-Muller pair per step (the Heston
    walks): step ``j`` draws counter ``j`` and gets both branches,
    ``step_fn(j, z1, z2, carry) -> carry``."""
    for j in range(n_steps):
        z1, z2 = draw_normal_pair(key, idx, j)
        carry = step_fn(j, z1, z2, carry)
    return carry


def walk_partials(walk, seed: int, block_offset: int, plan: Plan,
                  n_blocks: int, device, width: int = LANES,
                  sums=None) -> torch.Tensor:
    """Per-block ``(n_blocks, 2 * n_out)`` partials ``[sum x, sum x^2]`` of
    each per-path output of a walk, iteration by iteration over
    :func:`iter_keys`' streams.

    ``walk(key, idx, shape, sgn)`` gets the ``(n_blocks, rows * width)``
    draw tile's shape and element indices and returns the ``n_out`` output
    tiles, each ``(n_blocks, -1)``; under antithetic the mirror
    (``sgn = -1``) replays the same key and the two are averaged before
    the sums, which are Kahan-added over iterations if ``plan.kahan``.
    ``sums(tiles)``, if given, returns the per-block sums of an
    iteration's (pair-meaned) tiles in place of the ``[sum x, sum x^2]``
    pairs (K46's centered moments).
    """
    shape = (n_blocks, plan.rows * width)
    idx = tile_index(shape[1], device)
    carry = None
    for i in range(plan.iters):
        key = iter_keys(seed, block_offset, plan.iters, i, n_blocks, device)
        tiles = walk(key, idx, shape, 1.0)
        if plan.antithetic:
            mirror = walk(key, idx, shape, -1.0)
            tiles = [0.5 * (x + y) for x, y in zip(tiles, mirror)]
        if sums is None:
            vals = []
            for q in tiles:
                vals += [q.sum(1), (q * q).sum(1)]
        else:
            vals = sums(tiles)
        if carry is None:
            carry = acc_init_n(len(vals), n_blocks, device)
        carry = acc_add_n(carry, vals, plan.kahan)
    return acc_final_n(carry)


# The asset-major vector-Greek kernels (K32, K34, K42) write per block
# ``4 + 4a`` sums: the (sum, sum^2) pairs of two scalar outputs (a price
# and rho, or the CVA and its credit delta), then per asset ``(d.., d^2..,
# v.., v^2..)``.
N_GREEK_SCALARS = 4


def split_vec(out: torch.Tensor, a: int, n_scal: int = N_GREEK_SCALARS):
    """``(B, n_scal + 4a)`` sums ``[p, p2, gr, gr2, d.., d2.., v.., v2..]``
    (``n_scal / 2`` scalar pairs; K44 has 7) -> ``((B, n_scal), (B, 4,
    a))``, the second as ``mctpu``'s lane rows 0..3 in lanes 0..a-1."""
    return out[:, :n_scal], out[:, n_scal:].reshape(out.shape[0], 4, a)


def vec_greek_partials(walk, a: int, seed: int, block_offset: int,
                       plan: Plan, n_blocks: int, device,
                       n_scal: int = N_GREEK_SCALARS):
    """:func:`walk_partials` of an asset-major Greek walk's ``[p, gr, d_0..,
    v_0..]`` tiles (``n_scal / 2`` scalar outputs first), reordered to the
    kernels' ``(B, n_scal + 4a)`` layout and split by :func:`split_vec`."""
    out = walk_partials(walk, seed, block_offset, plan, n_blocks, device)
    dv = out[:, n_scal:]
    d, v = dv[:, :2 * a], dv[:, 2 * a:]
    vec = torch.stack([d[:, 0::2], d[:, 1::2], v[:, 0::2], v[:, 1::2]], 1)
    return out[:, :n_scal], vec


def packed_vec_partials(walk, pack, seed: int, block_offset: int,
                        plan: Plan, n_blocks: int, device):
    """K33's, K35's and K41's per-block ``((B, 4), (B, 4, width))``
    partials of a packed Greek walk ``walk(key, idx, shape, sgn) -> (p, gr,
    dval, vval)`` (two per-path scalars, ``(B, rows, c)``, and two per-lane
    values of the ``a`` real lanes, ``(B, rows, c, a)``) over the packed
    shape ``pack = (a_tile, c, width)``: the scalar pairs Kahan-carried
    (their tiles summed as K31's plain version sums its payoffs), the lane
    rows by :func:`det_col_sums` over the rows, padded lanes exactly 0."""
    a_tile, c, width = pack
    shape = (n_blocks, plan.rows * width)
    idx = tile_index(shape[1], device)
    carry = acc_init_n(N_GREEK_SCALARS, n_blocks, device)
    vecs = torch.zeros((n_blocks, 4, width), dtype=torch.float32,
                       device=device)
    for i in range(plan.iters):
        key = iter_keys(seed, block_offset, plan.iters, i, n_blocks, device)
        tiles = walk(key, idx, shape, 1.0)
        if plan.antithetic:
            mirror = walk(key, idx, shape, -1.0)
            tiles = [0.5 * (x + y) for x, y in zip(tiles, mirror)]
        p, gr, dval, vval = tiles
        sums = []
        for x in (p.reshape(n_blocks, -1), gr.reshape(n_blocks, -1)):
            sums += [x.sum(1), (x * x).sum(1)]
        carry = acc_add_n(carry, sums, plan.kahan)
        rows = [torch.nn.functional.pad(x, (0, a_tile - x.shape[-1]))
                .reshape(n_blocks, plan.rows, width) for x in (dval, vval)]
        vecs = vecs + torch.stack(
            [det_col_sums(rows[0], 1), det_col_sums(rows[0] * rows[0], 1),
             det_col_sums(rows[1], 1), det_col_sums(rows[1] * rows[1], 1)],
            1)
    return acc_final_n(carry), vecs


def terminal_partials(draw_sums, n_sums: int, seed: int, block_offset: int,
                      plan: Plan, n_blocks: int, device) -> torch.Tensor:
    """Per-block ``(n_blocks, n_sums)`` partials of a terminal-draw kernel
    over K1's stream (K21-K24): block ``b`` is seeded ``(seed,
    block_offset + b)`` and iteration ``i`` draws counter ``i``.
    ``draw_sums(z)`` returns the ``n_sums`` per-block sums of one
    Box-Muller branch's tile ``z``; the two branches' sums are added, then
    Kahan-added over iterations if ``plan.kahan``."""
    key = block_keys(seed, [block_offset + b for b in range(n_blocks)],
                     device)
    idx = tile_index(plan.rows * LANES, device)
    carry = acc_init_n(n_sums, n_blocks, device)
    for i in range(plan.iters):
        z1, z2 = draw_normal_pair(key, idx, i)
        sums = [a + b for a, b in zip(draw_sums(z1), draw_sums(z2))]
        carry = acc_add_n(carry, sums, plan.kahan)
    return acc_final_n(carry)


def launch_items(entry: str, ptrs, n_items: int, n_sums: int, seed: int,
                 block_offset: int, plan: Plan, n_blocks: int, device,
                 flags=()) -> torch.Tensor:
    """Launch a kernel over a vector of strikes or instruments (the ladder
    and the books, K21-K26) on ``device`` and return its ``(n_blocks,
    n_items, n_sums)`` partials.  Their C signatures are ``(*ptrs, n_items,
    seed, block_offset, n_blocks, rows, iters, antithetic, *flags, kahan,
    out, stream)``; ``flags`` are the ladder's put flag or the barrier
    book's ``n_obs``.  The caller checks the operands; raises on a failed
    launch."""
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    lib = _build.library()
    with torch.cuda.device(device):
        out = torch.empty((n_blocks, n_items, n_sums), dtype=torch.float32,
                          device=device)
        status = getattr(lib, entry)(
            *ptrs, n_items, wrap_int32(seed), wrap_int32(block_offset),
            n_blocks, plan.rows, plan.iters, int(plan.antithetic),
            *(int(f) for f in flags), int(plan.kahan), out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(status, entry)
    return out


def check_level(n_fine: int) -> None:
    """Raise unless ``n_fine`` is an MLMC level's fine grid (K11, K14,
    K29): an even step count, at least 2."""
    if n_fine < 2 or n_fine % 2:
        raise ValueError(f"an MLMC level's fine grid has an even step count "
                         f">= 2, got {n_fine}")


def launch_walk(entry: str, scal: torch.Tensor, n_scal: int, n_out: int,
                seed: int, block_offset: int, plan: Plan, n_blocks: int,
                n_obs: int, mode: int) -> torch.Tensor:
    """Launch a single-asset walk kernel of the simple design (K9, K13,
    K14, K16-K18, K20, K28 and K46 share one C signature) on ``scal``'s
    device and return its ``(n_blocks, n_out)`` partials.  ``mode`` selects
    the kernel's static variant: 1 for the geometric Asian, the up-and-out
    barrier or the variance swap's Heston leg, ``2 * fixed + put`` for the
    lookback, 0 otherwise;
    ``n_obs`` is the step count (the cliquet's ``n_periods``, an MLMC
    level's fine step count).  Raises on a bad operand or a failed launch."""
    check_operand("scal", scal, (n_scal,), scal.device)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    if n_obs < 1:
        raise ValueError("n_obs must be >= 1")
    lib = _build.library()
    with torch.cuda.device(scal.device):
        out = torch.empty((n_blocks, n_out), dtype=torch.float32,
                          device=scal.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        status = getattr(lib, entry)(
            scal.data_ptr(), n_obs, wrap_int32(seed),
            wrap_int32(block_offset), n_blocks, plan.rows, plan.iters,
            int(plan.antithetic), int(plan.kahan), int(mode), out.data_ptr(),
            stream)
    _build.check(status, entry)
    return out


@functools.lru_cache(maxsize=256)
def _split_scratch_floats(entry: str, n_blocks: int, rows: int, iters: int,
                          cap: int) -> int:
    """Floats of scratch a split walk's launch takes (its groups' outputs
    and the fold's carry; a function of the plan alone)."""
    return getattr(_build.library(), f"{entry}_scratch_floats")(
        n_blocks, rows, iters, cap)


def launch_split_walk(entry: str, scal: torch.Tensor, n_scal: int,
                      n_out: int, seed: int, block_offset: int, plan: Plan,
                      n_blocks: int, n_obs: int, mode: int | None,
                      scratch_cap: int = 0,
                      scratch_floats: int | None = None) -> torch.Tensor:
    """Launch a split walk (K10, K11, K12, K15, K19, K20, K27, K29:
    ``csrc/common.cuh``'s ``walk_split_launch``, a thread per path element
    and a fold in the simple design's order) on ``scal``'s device and
    return its ``(n_blocks, n_out)`` partials, the scratch that ``entry``
    + ``_scratch_floats`` sizes allocated here on the current stream.
    ``mode`` is the kernel's static variant, as :func:`launch_walk`'s (the
    lookback's ``2 * fixed + put`` for K15, the variance swap's Heston leg
    for K19, the QE scheme for K27), or None
    where the entry takes none (K29);
    ``scratch_cap``: the scratch in floats at most (0: 256 MB), past which
    the simulation blocks and iterations go in groups, the outputs the
    same; ``scratch_floats``, where given, sizes the scratch instead (0 for
    K20's GBM leg, which takes none).  Raises on a bad operand or a failed
    launch."""
    check_operand("scal", scal, (n_scal,), scal.device)
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    if n_obs < 1:
        raise ValueError("n_obs must be >= 1")
    lib = _build.library()
    flags = (int(plan.antithetic), int(plan.kahan))
    if mode is not None:
        flags += (int(mode),)
    with torch.cuda.device(scal.device):
        out = torch.empty((n_blocks, n_out), dtype=torch.float32,
                          device=scal.device)
        if scratch_floats is None:
            scratch_floats = _split_scratch_floats(entry, n_blocks, plan.rows,
                                                   plan.iters, scratch_cap)
        scratch = torch.empty(scratch_floats, dtype=torch.float32,
                              device=scal.device)
        status = getattr(lib, entry)(
            scal.data_ptr(), n_obs, wrap_int32(seed),
            wrap_int32(block_offset), n_blocks, plan.rows, plan.iters,
            *flags, scratch_cap, scratch.data_ptr(), out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(status, entry)
    return out
