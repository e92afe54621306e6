"""Build the CUDA kernels from ``csrc/`` at first use and bind them by ctypes.

One ``nvcc`` process per ``.cu`` file, all started together, compiles the
sources to objects; one more links them into a shared library with a plain
C interface (no PyTorch headers, so it builds in seconds) under
``mctpu_torch/_build/``.  The library's name carries a hash of the sources
and flags, so an edited kernel rebuilds.  Nothing is built at import, and a
failed build raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "build", "library", "check"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("vanilla.cu", "basket.cu", "cva.cu", "greeks.cu",
           "cva_greeks.cu", "asian.cu", "barrier.cu", "lookback.cu",
           "cliquet.cu", "ladder.cu", "book.cu", "varswap.cu",
           "barrier_book.cu", "heston.cu", "multi_walk.cu", "rainbow.cu",
           "cva_multi.cu", "varred.cu", "lsm.cu", "rqmc.cu")
HEADERS = ("philox.cuh", "common.cuh", "packed.cuh", "basket.cuh",
           "greeks.cuh")
# sm_90a (Hopper).  No --use_fast_math: the kernels rely on IEEE expf/logf/
# sqrtf and on un-reassociated compensated sums.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# Per-source flags.  The single-asset walks, the strike ladder and the books
# take no FMA contraction, so each path rounds as the plain version's
# separate operations do: their discontinuities (knock-out, in-the-money
# indicator, arg-extreme, the cliquet's band mask, the Heston walks'
# truncation max(v, 0) and QE's branch switches, the basket walks' knock-out
# and in-the-money indicator, the rainbow's arg-extreme asset, the netting
# set's and the xVA's exercise indicator and positive part, the American
# walk's exercise decision) fall on the same side (see the head of
# csrc/asian.cu and of csrc/lsm.cu), and a deep out-of-the-money
# strike's st - k and an antithetic pair's cancelling gamma terms are exact
# as there (see the head of csrc/ladder.cu), and so is the control
# variates' residual d = (p - p0) - (c - m), the difference of two nearly
# equal terms (see the head of csrc/varred.cu), and the RQMC nets' normal
# quantile, payoff kink and in-the-money indicator (see the head of
# csrc/rqmc.cu).
SOURCE_FLAGS = {name: ("-fmad=false",)
                for name in ("asian.cu", "barrier.cu", "lookback.cu",
                             "cliquet.cu", "ladder.cu", "book.cu",
                             "varswap.cu", "barrier_book.cu", "heston.cu",
                             "multi_walk.cu", "rainbow.cu", "cva_multi.cu",
                             "varred.cu", "lsm.cu", "rqmc.cu")}

_P, _I = ctypes.c_void_p, ctypes.c_int
# Every entry point returns cudaGetLastError() after its launch.
_SIGNATURES = {
    # par, seed, off, n_blocks, rows, iters, antithetic, put, kahan, out,
    # stream
    "mctpu_vanilla": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # lt, par, k, n_assets, seed, off, n_blocks, rows, iters, antithetic,
    # kahan, out, stream
    "mctpu_basket_am": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # lt, par, k, n_assets, a_tile, width, seed, off, n_blocks, rows, iters,
    # antithetic, kahan, scratch cap in floats, scratch, out, stream
    "mctpu_basket_packed": (_P, _P, _P) + (_I,) * 11 + (_P, _P, _P),
    # a_tile, width, n_blocks, rows, iters, cap -> float count of K3's
    # scratch (its groups' payoffs and fold carry)
    "mctpu_basket_packed_scratch_floats": (_I,) * 6,
    # scal, opts, nodes, n_options, n_grid, seed, off, n_blocks, rows,
    # iters, antithetic, kahan, ds, wwr, scratch, out, ee, stream
    "mctpu_cva": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                  _P, _P, _P, _P),
    # n_grid, n_blocks, rows, iters -> float count of K4's scratch (its
    # slices' sums and profile rows, profile slots past shared memory)
    "mctpu_cva_scratch_floats": (_I, _I, _I, _I),
    # par, seed, off, n_blocks, rows, iters, antithetic, put, kahan, out,
    # stream
    "mctpu_greeks_vanilla": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # scal, lt, par, vec, n_assets, seed, off, n_blocks, rows, iters,
    # antithetic, kahan, out, stream
    "mctpu_greeks_basket_am": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P, _P),
    # scal, lt, rows, n_assets, a_tile, width, seed, off, n_blocks, rows,
    # iters, antithetic, kahan, scratch cap in floats, scratch, out, vecs,
    # stream
    "mctpu_greeks_basket_packed": (_P, _P, _P) + (_I,) * 11 + (_P,) * 4,
    # n_assets, a_tile, width, n_blocks, rows, iters, antithetic, cap ->
    # float count of K8's scratch (its groups' items and fold carry)
    "mctpu_greeks_basket_packed_scratch_floats": (_I,) * 8,
    # scal, opts, nodes, n_options, n_grid, seed, off, n_blocks, rows,
    # iters, antithetic, kahan, wwr, scratch, out, stream
    "mctpu_cva_greeks": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P),
    # n_grid, n_blocks, rows, iters -> float count of K5's scratch (its
    # slices' sums)
    "mctpu_cva_greeks_scratch_floats": (_I, _I, _I, _I),
    # The single-asset walks of the simple design (K9, K13, K16-K18, K28,
    # K46, K14's level walk): scal, n_obs (the cliquet's n_periods, the
    # Heston walk's n_steps, an MLMC level's fine step count), seed, off,
    # n_blocks, rows, iters, antithetic, kahan, mode (geometric Asian,
    # up-and-out barrier, 2 * fixed + put for the lookback; 0 for the
    # cliquet, K28 and K46), out, stream
    **{name: (_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P)
       for name in ("mctpu_asian", "mctpu_barrier_greeks",
                    "mctpu_lookback_greeks", "mctpu_cliquet",
                    "mctpu_cliquet_greeks", "mctpu_heston_greeks",
                    "mctpu_asian_cv", "mctpu_barrier_level")},
    # The split walks K10, K11, K12, K15, K19, K27 and K20 (its Heston leg;
    # its GBM leg the simple design, no scratch): scal, n_obs (K11's
    # n_fine, K27's n_steps), seed, off, n_blocks, rows, iters, antithetic,
    # kahan, mode (geometric Asian, up-and-out barrier, 2 * fixed + put for
    # the lookback, the variance swap's Heston leg, the QE scheme), scratch
    # cap in floats, scratch, out, stream
    **{name: (_P,) + (_I,) * 10 + (_P, _P, _P)
       for name in ("mctpu_asian_greeks", "mctpu_asian_level",
                    "mctpu_barrier", "mctpu_lookback", "mctpu_varswap",
                    "mctpu_heston", "mctpu_varswap_greeks")},
    # K29, the split Heston level walk: scal, n_fine, seed, off, n_blocks,
    # rows, iters, antithetic, kahan, scratch cap in floats, scratch, out,
    # stream
    "mctpu_heston_level": (_P,) + (_I,) * 9 + (_P, _P, _P),
    # n_blocks, rows, iters, cap -> float count of a split walk's scratch
    # (its groups' outputs and fold carry): K10, K11, K12, K15, K19, K20's
    # Heston leg, K27, K29, K30
    **{name: (_I,) * 4 for name in ("mctpu_asian_greeks_scratch_floats",
                                     "mctpu_varswap_greeks_scratch_floats",
                                     "mctpu_asian_level_scratch_floats",
                                     "mctpu_barrier_scratch_floats",
                                     "mctpu_lookback_scratch_floats",
                                     "mctpu_varswap_scratch_floats",
                                     "mctpu_heston_scratch_floats",
                                     "mctpu_heston_level_scratch_floats",
                                     "mctpu_multi_walk_am_scratch_floats")},
    # The strike ladder (K21, K22): par, strikes, n_strikes, seed, off,
    # n_blocks, rows, iters, antithetic, put, kahan, out, stream
    **{name: (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P)
       for name in ("mctpu_ladder", "mctpu_ladder_greeks")},
    # The vanilla book (K23, K24): table, n_instruments, seed, off,
    # n_blocks, rows, iters, antithetic, kahan, out, stream
    **{name: (_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P)
       for name in ("mctpu_book", "mctpu_book_greeks")},
    # The barrier book (K25, K26): table, n_instruments, seed, off,
    # n_blocks, rows, iters, antithetic, n_obs, kahan, out, stream
    **{name: (_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P)
       for name in ("mctpu_barrier_book", "mctpu_barrier_book_greeks")},
    # The multi-asset walks (K30-K35): their operands, then
    # n_assets, n_obs, seed, off, n_blocks, rows, iters, antithetic, kahan,
    # the kernel's flags, out, stream.  K30: lt, par, scal; flags barrier,
    # up, scratch cap in floats; its scratch before out.
    "mctpu_multi_walk_am": (_P, _P, _P) + (_I,) * 12 + (_P, _P, _P),
    # K31: lt, par, scal; flags a_tile, width, barrier, up.
    "mctpu_multi_walk_packed": (_P, _P, _P) + (_I,) * 13 + (_P, _P),
    # K32: scal, lt, par; no flags.
    "mctpu_multi_walk_greeks_am": (_P, _P, _P) + (_I,) * 9 + (_P, _P),
    # K34: scal, lt, linv, par; flags up, scratch cap in floats; its
    # scratch before out.
    "mctpu_multi_walk_bar_greeks_am": (_P, _P, _P, _P) + (_I,) * 11
    + (_P, _P, _P),
    # n_assets, n_blocks, rows, iters, cap -> float count of K34's scratch
    # (its groups' outputs and fold carry)
    "mctpu_multi_walk_bar_greeks_am_scratch_floats": (_I,) * 5,
    # K33: scal, tj, lt, par; flags a_tile, width; out, vecs, stream.
    "mctpu_multi_walk_greeks_packed": (_P, _P, _P, _P) + (_I,) * 11
    + (_P, _P, _P),
    # K35: scal, lt, linv, par; flags a_tile, width, up; out, vecs, stream.
    "mctpu_multi_walk_bar_greeks_packed": (_P, _P, _P, _P) + (_I,) * 12
    + (_P, _P, _P),
    # The rainbow (K36, K38, K37): lt, par, k (K38: scal, lt, par, inv_s0),
    # n_assets, [K37: a_tile, width,] use_min, seed, off, n_blocks, rows,
    # iters, antithetic, kahan, out, stream
    "mctpu_rainbow_am": (_P, _P, _P) + (_I,) * 9 + (_P, _P),
    "mctpu_rainbow_packed": (_P, _P, _P) + (_I,) * 11 + (_P, _P),
    "mctpu_rainbow_greeks": (_P, _P, _P, _P) + (_I,) * 9 + (_P, _P),
    # The netting-set CVA (K40, K39, K42, K41): scal, lt, par, nodes,
    # n_under, n_grid, [K39, K41: a_tile, width,] seed, off, n_blocks, rows,
    # iters, antithetic, kahan, [K40: scratch cap in floats,] [K40, K39:
    # scratch,] out, [K40, K39: ee, K41: vecs,] stream
    "mctpu_cva_multi_am": (_P,) * 4 + (_I,) * 10 + (_P,) * 4,
    "mctpu_cva_multi_packed": (_P,) * 4 + (_I,) * 11 + (_P,) * 4,
    "mctpu_cva_multi_greeks_am": (_P,) * 4 + (_I,) * 9 + (_P, _P),
    "mctpu_cva_multi_greeks_packed": (_P,) * 4 + (_I,) * 11 + (_P,) * 3,
    # n_under, n_grid -> float count of one K39 block's profile scratch
    "mctpu_cva_multi_scratch_floats": (_I, _I),
    # n_under, n_grid, n_blocks, rows, iters, antithetic, cap -> float count
    # of K40's scratch (its groups' split items and fold carry)
    "mctpu_cva_multi_am_scratch_floats": (_I,) * 7,
    # The xVA (K43, K44 and their runtime-m kernels): scal, lt, par, nodes,
    # n_under, n_grid, wide, seed, off, n_blocks, rows, iters, antithetic,
    # kahan, scratch cap in floats, scratch, out, [K43: prof,] stream
    "mctpu_xva": (_P,) * 4 + (_I,) * 11 + (_P,) * 4,
    "mctpu_xva_greeks": (_P,) * 4 + (_I,) * 11 + (_P,) * 3,
    # n_under, n_grid, greeks, wide, n_blocks, rows, iters, antithetic, cap
    # -> float count of a launch's scratch (its groups' split items and fold
    # carry; the runtime-m kernels' slice rows and state)
    "mctpu_xva_scratch_floats": (_I,) * 9,
    # The control variates (K45, K47, K48; K46 takes the single-asset
    # walks' signature above): K45 par, seed, off, n_blocks, rows, iters,
    # antithetic, kahan, out, stream
    "mctpu_vanilla_cv": (_P,) + (_I,) * 7 + (_P, _P),
    # The importance-sampled call (K49): K45's signature.
    "mctpu_vanilla_is": (_P,) + (_I,) * 7 + (_P, _P),
    # The American forward pass (K50) and its Greeks (K51): scal, beta,
    # tables, n_steps, seed, off, n_blocks, rows, iters, antithetic, put,
    # kahan, out, stream
    **{name: (_P, _P, _P) + (_I,) * 9 + (_P, _P)
       for name in ("mctpu_lsm", "mctpu_lsm_greeks")},
    # K47, K48: K2's and K3's signatures with the strike replaced by scal
    # (k, p0, m); K48 takes its scratch before out
    "mctpu_basket_cv_am": (_P, _P, _P) + (_I,) * 8 + (_P, _P),
    "mctpu_basket_cv_packed": (_P, _P, _P) + (_I,) * 10 + (_P, _P, _P),
    # n_blocks, iters -> float count of K48's scratch (its (block,
    # iteration) rows of five sums)
    "mctpu_basket_cv_packed_scratch_floats": (_I, _I),
    # The RQMC nets (K52-K55), both passes: their operands (K52, K53: par;
    # K54: par, lt, rows; K55: par, drift, bridge), v, low, the shifts' key
    # words k0, k1 and block offset, dims, n_blocks, ppc, iters, [K52, K53:
    # put; K55: geometric, scratch cap in floats, scratch,] tiles, out,
    # stream
    **{name: (_P,) * 3 + (_I,) * 8 + (_P,) * 3
       for name in ("mctpu_rqmc_vanilla", "mctpu_rqmc_greeks")},
    "mctpu_rqmc_basket": (_P,) * 5 + (_I,) * 7 + (_P,) * 3,
    "mctpu_rqmc_asian": (_P,) * 5 + (_I,) * 9 + (_P,) * 4,
    # n_blocks, ppc, iters, cap -> float count of K55's scratch (its
    # groups' payoffs)
    "mctpu_rqmc_asian_scratch_floats": (_I,) * 4,
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from mctpu_torch/csrc at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update(" ".join(SOURCE_FLAGS.get(name, ())).encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    so = BUILD_DIR / f"libmctpu_torch_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [str(Path(work) / f"{Path(name).stem}.o") for name in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-c", "-o",
                 obj, str(CSRC / name)]
                for name, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outs = [p.communicate()[0] for p in procs]  # waits for every one
        for cmd, p, out in zip(cmds, procs, outs):
            _raise_on_failure(cmd, p.returncode, out)
        tmp = str(Path(work) / "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _raise_on_failure(cmd, proc.returncode, proc.stdout + proc.stderr)
        os.replace(tmp, so)  # atomic: builders never see a partial file
    return so


def _raise_on_failure(cmd, returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {returncode}):\n"
                           f"{' '.join(cmd)}\n{output}")


def library() -> ctypes.CDLL:
    """The kernel library, built and bound on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mctpu_error_string.argtypes = (_I,)
        lib.mctpu_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if status != 0:
        msg = library().mctpu_error_string(status).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status} "
                           f"({msg})")
