#!/usr/bin/env python3
"""Print the registers, spills and shared memory ptxas gives each kernel.

Run from the repository root on a machine with the CUDA toolkit (``nvcc``):

    python3 tools/ptxas_report.py [source.cu ...]

Compiles each source of ``mctpu_torch/csrc`` (all of ``_build.SOURCES`` by
default, ``multi_walk.cu``, ``rainbow.cu``, ``heston.cu`` -- K27's and
K29's split walks ``walk_split_kernel<HestonWalk<..>, ..>`` and
``<HestonLevelWalk, ..>`` and their fold ``walk_fold_kernel<1024, ..>``
-- ``asian.cu`` -- K10's ``walk_split_kernel<AsianGreekWalk<..>, ..>``
and its fold ``walk_fold_kernel<512, .., true, 5>``, K11's
``walk_split_kernel<AsianLevelWalk<..>, ..>`` and its fold
``walk_fold_kernel<1024, ..>`` -- ``cva_multi.cu`` -- K41's register
instances ``cva_multi_greeks_reg_kernel<16 | 32, ANTI, KAHAN>`` beside
its shared-memory kernel ``cva_multi_greeks_packed_kernel`` --
``varswap.cu`` -- K19's split walks ``walk_split_kernel<VarswapGbmWalk
| VarswapHestonWalk, ..>`` and their fold ``walk_fold_kernel<1024, ..>``
-- ``lookback.cu`` -- K15's split walks ``walk_split_kernel<LookbackWalk<
MODE>, ..>`` and their fold ``walk_fold_kernel<1024, ..>`` -- and
``rqmc.cu`` -- K55's split net ``rqmc_asian_split_kernel<64 | 256 |
2048, GEO>`` and its fold ``rqmc_asian_fold_kernel``, K54's tiled net
``rqmc_basket_tiled_kernel`` beside its local-array instances
``rqmc_basket_kernel<MAXA>`` -- among them)
with the flags ``mctpu_torch/_build.py`` builds it with, plus ``-Xptxas -v``,
one ``nvcc`` per source, all started together, into a temporary
directory, and prints each source's compile time (wall seconds from the
common start, as ``_build.build`` runs them) and one line per kernel
instance: its source, its name (demangled where ``cu++filt`` is found),
registers, spill stores and loads in bytes, and static shared memory.
Builds nothing the port loads.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def _demangle(names, nvcc: str):
    tool = Path(nvcc).with_name("cu++filt")
    if not tool.exists():
        found = shutil.which("cu++filt") or shutil.which("c++filt")
        if found is None:
            return names
        tool = Path(found)
    out = subprocess.run([str(tool)], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    from mctpu_torch import _build

    sources = argv or list(_build.SOURCES)
    nvcc = _build._nvcc()
    rows = []
    with tempfile.TemporaryDirectory() as work:
        start = time.perf_counter()

        def compile_one(name):
            proc = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(name, ()),
                 "-Xptxas", "-v", "-c", "-o", str(Path(work) / f"{name}.o"),
                 str(_build.CSRC / name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return proc, time.perf_counter() - start

        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            done = list(pool.map(compile_one, sources))
        for name, (_, secs) in zip(sources, done):
            print(f"{name}: compiled in {secs:.1f} s ({len(sources)} "
                  "sources at once)")
        for name, (proc, _) in zip(sources, done):
            out = proc.stdout
            if proc.returncode != 0:
                print(out)
                raise RuntimeError(f"nvcc failed on {name}")
            kernel = spill = None
            for line in out.splitlines():
                if m := _ENTRY.search(line):
                    kernel, spill = m.group(1), ("0", "0")
                elif (m := _SPILL.search(line)) and kernel:
                    spill = m.groups()
                elif (m := _USED.search(line)) and kernel:
                    rows.append((name, kernel, int(m.group(1)), int(spill[0]),
                                 int(spill[1]), int(m.group(2) or 0)))
                    kernel = None
    names = _demangle([r[1] for r in rows], nvcc)
    for (src, _, regs, st, ld, smem), name in zip(rows, names):
        print(f"{src}: {name}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B, smem {smem} B")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
