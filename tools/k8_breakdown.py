#!/usr/bin/env python3
"""Split K8's time (the packed basket Greeks) by phase on one GPU.

Run from the repository root on a machine with a CUDA device and ``nvcc``:

    python3 tools/k8_breakdown.py [--reps 5]

Builds ``mctpu_torch/csrc/greeks.cu`` alone (the flags
``mctpu_torch/_build.py`` builds it with) as it stands and in variants
that each leave one phase of the width-128 split kernel
(``greeks_tiled_kernel``) out -- the draw of the normals, the tiled L z
product with S_T, the per-unit fold over the slots, the per-slot column
sums -- or the fold kernel's launch, or all four phases of the split
kernel at once (what remains: L's slices, the operand rows, the barriers,
the block's row and the fold); one ``nvcc`` per variant, all started
together, into a temporary directory.  Each variant runs K8 at
``chip_smoke.py``'s phase-6 shape (``equicorrelated(100)``, 2^22 paths,
the default ``EngineConfig``, plain and antithetic) and prints the median
of ``--reps`` launches timed by CUDA events after one warm-up launch.  A
variant's outputs are meaningless (a phase's results are never formed):
the difference to the whole kernel is that phase's share of its time.
Prints the card's name and power limit first and a JSON line of the rows
last.  Imports neither jax nor mctpu.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 20240607

# Phase -> (text in greeks_tiled_kernel, its replacement).
_DRAW = "        for (int l = l0; l < a; l += g) {"
_PROD = "      if (j0 + jw + 8 <= 0) continue;"
_UNIT = "    for (int q3 = tid; q3 < 3 * NS * nu; q3 += THREADS) {"
_SUMS = "    for (int q = tid; q < nu; q += THREADS) {"
_COLS = "    for (int q = tid; q < 2 * width; q += THREADS) {"
PHASES = {
    "draw": [(_DRAW, _DRAW.replace("l < a", "l < 0"))],
    "product": [(_PROD, "      continue;")],
    "unit fold": [(_UNIT, _UNIT.replace("q3 < 3 * NS * nu", "q3 < 0")),
                  (_SUMS, _SUMS.replace("q < nu", "q < 0"))],
    "columns": [(_COLS, _COLS.replace("q < 2 * width", "q < 0"))],
}


def variants(src: str) -> dict:
    """``{name: source}``: the whole kernel, one phase left out each, the
    fold's launch left out, and every phase left out."""
    start = src.index("    greeks_tiled_kernel(const float*")
    end = src.index("// Past width 128")

    def without(edits):
        body = src[start:end]
        for old, new in edits:
            if body.count(old) != 1:
                raise RuntimeError(f"greeks_tiled_kernel changed: {old!r}")
            body = body.replace(old, new)
        return src[:start] + body + src[end:]

    fold = "      fold<<<nb * k8_fold_blocks(width), THREADS, 0, s>>>("
    if src.count(fold) != 1:
        raise RuntimeError("launch_packed changed")
    out = {"whole": src}
    out.update({f"no {k}": without(e) for k, e in PHASES.items()})
    out["no fold launch"] = src.replace(fold, "      if (false) " + fold[6:])
    out["no phase"] = without([e for v in PHASES.values() for e in v])
    return out


def build(srcs: dict, work: Path) -> dict:
    """Each variant's library, compiled in parallel."""
    from mctpu_torch import _build

    nvcc = _build._nvcc()
    procs = {}
    for k, (name, text) in enumerate(srcs.items()):
        d = work / f"v{k}"
        d.mkdir()
        for h in _build.HEADERS:
            (d / h).write_text((_build.CSRC / h).read_text())
        (d / "greeks.cu").write_text(text)
        procs[name] = (d, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "greeks.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        pk = lib.mctpu_greeks_basket_packed
        pk.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 11 + (
            ctypes.c_void_p,) * 4
        lib.mctpu_greeks_basket_packed_scratch_floats.argtypes = (
            (ctypes.c_int,) * 8)
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mctpu_torch import _build, engine
    from mctpu_torch.kernels import basket as kbasket
    from mctpu_torch.types import BasketOption

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    rows = []
    with tempfile.TemporaryDirectory() as work:
        libs = build(variants((_build.CSRC / "greeks.cu").read_text()),
                     Path(work))
        for anti in (False, True):
            plan, ops, _ = engine.greeks_basket_setup(
                BasketOption.equicorrelated(100), 1 << 22,
                engine.EngineConfig(antithetic=anti))
            a = ops.n_assets
            a_tile, _, width = kbasket.pack_factor(a)
            nb = plan.num_blocks
            shape = (nb, plan.rows, plan.iters, int(anti))
            out = torch.empty((nb, 6), dtype=torch.float32, device=dev)
            vecs = torch.empty((nb, 6, width), dtype=torch.float32,
                               device=dev)
            for name, lib in libs.items():
                scratch = torch.empty(
                    lib.mctpu_greeks_basket_packed_scratch_floats(
                        a, a_tile, width, *shape, 0),
                    dtype=torch.float32, device=dev)

                def run(lib=lib, scratch=scratch):
                    status = lib.mctpu_greeks_basket_packed(
                        ops.scal.data_ptr(), ops.lt.data_ptr(),
                        ops.rows.data_ptr(), a, a_tile, width, SEED, 0,
                        *shape, int(plan.kahan), 0, scratch.data_ptr(),
                        out.data_ptr(), vecs.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if status != 0:
                        raise RuntimeError(f"K8 {name}: CUDA error {status}")

                run()
                times = []
                for _ in range(args.reps):
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in "se")
                    start.record()
                    run()
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
                ms = statistics.median(times)
                label = (f"K8 a=100 2^22{' antithetic' if anti else ''} "
                         f"{name}")
                print(f"{label}: {ms:.4f} ms", flush=True)
                rows.append({"case": label, "ms": ms, "card": smi})
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
