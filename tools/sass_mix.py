#!/usr/bin/env python3
"""Count the SASS of the walk kernels by pipe and turn it into an issue time.

Run from the repository root on a machine with the CUDA toolkit (``nvcc``,
``cuobjdump``) and a GPU for the clock:

    python3 tools/sass_mix.py [--csrc DIR] [--only TEXT ...]

Compiles each source a case names (from ``--csrc``, by default this
checkout's ``mctpu_torch/csrc``; another checkout's to count its kernels)
with the flags ``mctpu_torch/_build.py`` builds it with, to a cubin in a
temporary directory, and reads ``cuobjdump -sass``.  In each case's kernel
it finds the innermost loops (a backward branch with no other inside) that
hold a ``MUFU.RSQ`` -- the IEEE sqrtf of a Box-Muller pair, one a Philox
block, and of the Heston walks' variance, one an Euler step -- and counts
the loop body's instructions by class: ``IMAD.WIDE``, the other ``IMAD``,
``LOP3``/``IADD3``, FP32 (``FADD``, ``FMUL``, ``FFMA``, ``FMNMX``,
``FSETP``, ``FSEL``, ``FSET``, ``FCHK``), ``MUFU`` and the rest.
A path that takes ``k`` normals a date (1 for the barrier, lookback and
Asian Greeks walks, ``a`` for the asset-major basket walk, 2 for a Heston
step) and ``q`` more roots a date (the Heston level: its fine step's and
half its coarse step's, 1.5, or 3 for both signs; the Heston Euler walk
1, or 2 for both signs) takes ``k / 2 + q`` roots a
date, so a body of ``n`` roots walks ``n / (k / 2 + q)`` dates (the
Asian level walk: one normal a fine date, a pair a coarse step); a walk
that draws the stream again for the antithetic mirror (the simple design)
walks each date ``walks = 2`` times.  Per path-date = the largest such
loop's counts / its dates x walks.  The issue time at the case's
path-dates (2^22 x 50, the Heston level's 2^22 x 128 fine steps, the
Heston walk's 2^22 x 100 steps, the Asian level's 2^22 x 64 fine dates,
K34's 2^23 x 50 at 3 assets, K20's Heston leg's 2^22 x 252 dates) is
that
count / 32 warp
instructions, over 4 warp instructions a clock an SM, at the card's SM
count and its maximum SM clock (``nvidia-smi``): the least time the SMs
can take to issue the walk's instructions, beside ``chip_smoke.py``'s bound
from the sources.  The loops are static counts: instructions outside them
(the key, the payoff, the write or the sums) are left out.

Prints the card's name and power limit, its SM count and clock, one line
per case and loop, and a JSON line of the cases last.  Imports neither jax
nor mctpu.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from ptxas_report import _demangle  # noqa: E402

PATH_DATES = (1 << 22) * 50  # phase 6: 2^22 paths, 50 dates
LEVEL_DATES = (1 << 22) * 128  # K29 in phase 6: 128 fine steps
HESTON_DATES = (1 << 22) * 100  # K27 in phase 6: 100 steps
ASIAN_LEVEL_DATES = (1 << 22) * 64  # K11 in phase 6: 64 fine dates
BAR_GREEK_DATES = (1 << 23) * 50  # K34 in phase 6: 2^23 paths, 50 dates
VARSWAP_DATES = (1 << 22) * 252  # K20 in phase 6: 252 dates
# (case, source, text of the demangled kernel name, normals a date, walks
# [, more roots a date, path-dates]) at ANTI false, KAHAN true, up-and-out
# / the 3-asset basket / the arithmetic average / Euler / the floating
# call: the simple designs (K12 barrier_kernel, K30 mw_walk_am_kernel, K29
# heston_level_kernel, K10 asian_greeks_kernel, K27 heston_kernel, K11
# asian_level_kernel, K15 lookback_kernel, K34 mw_bar_greeks_am_kernel,
# K20's Heston leg varswap_heston_greeks_kernel) and the split walks.
CASES = (
    ("K12 simple", "barrier.cu", "barrier_kernel<false, true, true>", 1, 1),
    ("K12 simple antithetic", "barrier.cu",
     "barrier_kernel<true, true, true>", 1, 2),
    ("K12 split", "barrier.cu", "BarrierWalk<true>, false>", 1, 1),
    ("K12 split antithetic", "barrier.cu", "BarrierWalk<true>, true>", 1, 1),
    ("K30 asian a=3 simple", "multi_walk.cu",
     "mw_walk_am_kernel<3, false, true, false>", 3, 1),
    ("K30 knock-out a=3 simple", "multi_walk.cu",
     "mw_walk_am_kernel<3, false, true, true>", 3, 1),
    ("K30 asian a=3 simple antithetic", "multi_walk.cu",
     "mw_walk_am_kernel<3, true, true, false>", 3, 2),
    ("K30 asian a=3 split", "multi_walk.cu", "AmWalk<3, false>, false>", 3,
     1),
    ("K30 knock-out a=3 split", "multi_walk.cu", "AmWalk<3, true>, false>",
     3, 1),
    ("K30 asian a=3 split antithetic", "multi_walk.cu",
     "AmWalk<3, false>, true>", 3, 1),
    ("K29 simple", "heston.cu", "heston_level_kernel<false, true>", 2, 1,
     1.5, LEVEL_DATES),
    ("K29 simple antithetic", "heston.cu", "heston_level_kernel<true, true>",
     2, 2, 1.5, LEVEL_DATES),
    ("K29 split", "heston.cu", "HestonLevelWalk, false>", 2, 1, 1.5,
     LEVEL_DATES),
    ("K29 split antithetic", "heston.cu", "HestonLevelWalk, true>", 2, 1, 3,
     LEVEL_DATES),
    ("K10 simple", "asian.cu", "asian_greeks_kernel<false, true, false>", 1,
     1),
    ("K10 simple antithetic", "asian.cu",
     "asian_greeks_kernel<true, true, false>", 1, 2),
    ("K10 split", "asian.cu", "AsianGreekWalk<false>, false>", 1, 1),
    ("K10 split antithetic", "asian.cu", "AsianGreekWalk<false>, true>", 1,
     1),
    ("K27 Euler simple", "heston.cu", "heston_kernel<false, true, false>", 2,
     1, 1, HESTON_DATES),
    ("K27 Euler simple antithetic", "heston.cu",
     "heston_kernel<true, true, false>", 2, 2, 1, HESTON_DATES),
    ("K27 Euler split", "heston.cu", "HestonWalk<false>, false>", 2, 1, 1,
     HESTON_DATES),
    ("K27 Euler split antithetic", "heston.cu", "HestonWalk<false>, true>",
     2, 1, 2, HESTON_DATES),
    ("K11 simple", "asian.cu", "asian_level_kernel<false, true, false>", 1,
     1, 0, ASIAN_LEVEL_DATES),
    ("K11 simple antithetic", "asian.cu",
     "asian_level_kernel<true, true, false>", 1, 2, 0, ASIAN_LEVEL_DATES),
    ("K11 split", "asian.cu", "AsianLevelWalk<false>, false>", 1, 1, 0,
     ASIAN_LEVEL_DATES),
    ("K11 split antithetic", "asian.cu", "AsianLevelWalk<false>, true>", 1,
     1, 0, ASIAN_LEVEL_DATES),
    ("K15 simple", "lookback.cu", "lookback_kernel<false, true, 0>", 1, 1),
    ("K15 simple antithetic", "lookback.cu",
     "lookback_kernel<true, true, 0>", 1, 2),
    ("K15 split", "lookback.cu", "LookbackWalk<0>, false>", 1, 1),
    ("K15 split antithetic", "lookback.cu", "LookbackWalk<0>, true>", 1, 1),
    ("K34 a=3 simple", "multi_walk.cu",
     "mw_bar_greeks_am_kernel<3, false, true>", 3, 1, 0, BAR_GREEK_DATES),
    ("K34 a=3 simple antithetic", "multi_walk.cu",
     "mw_bar_greeks_am_kernel<3, true, true>", 3, 2, 0, BAR_GREEK_DATES),
    ("K34 a=3 split", "multi_walk.cu", "AmBarGreekWalk<3, false>, false>", 3,
     1, 0, BAR_GREEK_DATES),
    ("K34 a=3 split antithetic", "multi_walk.cu",
     "AmBarGreekWalk<3, true>, true>", 3, 1, 0, BAR_GREEK_DATES),
    ("K34 a=8 simple", "multi_walk.cu",
     "mw_bar_greeks_am_kernel<8, false, true>", 8, 1),
    ("K34 a=8 split", "multi_walk.cu", "AmBarGreekWalk<8, false>, false>", 8,
     1),
    ("K34 a=8 split antithetic", "multi_walk.cu",
     "AmBarGreekWalk<8, true>, true>", 8, 1),
    ("K20H simple", "varswap.cu", "varswap_heston_greeks_kernel<false, true>",
     2, 1, 1, VARSWAP_DATES),
    ("K20H simple antithetic", "varswap.cu",
     "varswap_heston_greeks_kernel<true, true>", 2, 2, 1, VARSWAP_DATES),
    ("K20H split", "varswap.cu", "VarswapHestonGreekWalk<false>, false>", 2,
     1, 1, VARSWAP_DATES),
    ("K20H split antithetic", "varswap.cu",
     "VarswapHestonGreekWalk<true>, true>", 2, 1, 2, VARSWAP_DATES),
)
FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK"}
CLASSES = ("IMAD.WIDE", "IMAD", "LOP3/IADD3", "FP32", "MUFU", "other")

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def plain_name(name: str) -> str:
    """A demangled name with cu++filt's ``(bool)1`` / ``(int)3`` template
    arguments written ``true`` / ``3``."""
    name = name.replace("(bool)1", "true").replace("(bool)0", "false")
    return re.sub(r"\(int\)(-?\d+)", r"\1", name)


def op_class(op: str) -> str:
    base = op.split(".")[0]
    if op.startswith("IMAD.WIDE"):
        return "IMAD.WIDE"
    if base == "IMAD":
        return "IMAD"
    if base in ("LOP3", "IADD3"):
        return "LOP3/IADD3"
    if base in FP32:
        return "FP32"
    if base == "MUFU":
        return "MUFU"
    return "other"


def parse(sass: str):
    """``{mangled name: [(addr, opcode, branch target or None)]}``."""
    funcs, labels, name = {}, {}, None
    pending = []
    for line in sass.splitlines():
        if m := _FUNC.match(line):
            name = m.group(1)
            funcs[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        if m := _LABEL.match(line):
            pending.append(m.group(1))
            continue
        if m := _INSTR.match(line):
            addr, text = int(m.group(1), 16), m.group(2)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            toks = text.split()
            if toks and toks[0].startswith("@"):
                toks = toks[1:]
            if not toks:
                continue
            op, target = toks[0], None
            if op.startswith("BRA"):
                t = _TARGET.search(text[text.index(op) + len(op):])
                if t:
                    target = t.group(1) or int(t.group(2), 16)
            funcs[name].append((addr, op, target))
    out = {}
    for fname, ins in funcs.items():
        out[fname] = [(a, op, labels[fname].get(t, None) if isinstance(t, str)
                       else t) for a, op, t in ins]
    return out


def walk_loops(ins):
    """The innermost loops holding a MUFU.RSQ: ``[(n_pairs, Counter)]``."""
    loops = [(t, a) for a, op, t in ins if t is not None and t <= a]
    inner = [(lo, hi) for lo, hi in loops
             if not any((lo2, hi2) != (lo, hi) and lo <= lo2 and hi2 <= hi
                        for lo2, hi2 in loops)]
    found = []
    for lo, hi in inner:
        body = [op for a, op, _ in ins if lo <= a <= hi]
        n_pairs = sum(op.startswith("MUFU.RSQ") for op in body)
        if n_pairs:
            found.append((n_pairs, Counter(op_class(op) for op in body)))
    return found


def card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, power, clock = (x.strip() for x in smi.splitlines()[0].split(","))
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return f"{name}, {power} W", sms, float(clock) * 1e6


def main() -> int:
    from mctpu_torch import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--only", action="append", default=[])
    args = ap.parse_args()
    cases = [c for c in CASES
             if not args.only or any(o in c[0] for o in args.only)]
    label, sms, clock = card()
    print(f"{label}; {sms} SMs at {clock / 1e6:.0f} MHz", flush=True)
    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    sass = {}
    with tempfile.TemporaryDirectory() as work:
        sources = sorted({c[1] for c in cases})
        cubins = [str(Path(work) / f"{src}.cubin") for src in sources]
        procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS,
                                   *_build.SOURCE_FLAGS.get(src, ()),
                                   "-cubin", "-o", cubin,
                                   str(args.csrc / src)])
                 for src, cubin in zip(sources, cubins)]
        if any([proc.wait() != 0 for proc in procs]):
            raise RuntimeError("nvcc failed")
        for src, cubin in zip(sources, cubins):
            funcs = parse(subprocess.run(
                [cuobjdump, "-sass", cubin], capture_output=True, text=True,
                check=True).stdout)
            names = [plain_name(n) for n in _demangle(list(funcs), nvcc)]
            sass[src] = dict(zip(names, funcs.values()))
    rows = []
    for case, src, text, normals, walks, *more in cases:
        roots, path_dates = more or (0, PATH_DATES)
        hits = [(n, ins) for n, ins in sass[src].items() if text in n]
        if not hits:
            print(f"{case}: no kernel matching {text!r} in {src}")
            continue
        name, ins = hits[0]
        loops = walk_loops(ins)
        for n_pairs, cnt in loops:
            dates = n_pairs / (normals / 2 + roots)
            print(f"{case}: loop of {sum(cnt.values())} instructions, "
                  f"{n_pairs} roots (MUFU.RSQ) ({dates:g} dates): "
                  + ", ".join(f"{k} {cnt[k]}" for k in CLASSES), flush=True)
        if not loops:
            print(f"{case}: no walk loop found in {name}")
            continue
        n_pairs, cnt = max(loops, key=lambda x: (x[0], sum(x[1].values())))
        per = {k: cnt[k] * walks * (normals / 2 + roots) / n_pairs
               for k in CLASSES}
        total = sum(per.values())
        issue_ms = total * path_dates / 32 / (4 * sms * clock) * 1e3
        print(f"{case}: per path-date " + ", ".join(
            f"{k} {per[k]:.2f}" for k in CLASSES)
              + f"; total {total:.2f}; issue time at 2^22 x "
                f"{path_dates >> 22} {issue_ms:.4f} ms [{label}]",
              flush=True)
        rows.append({"case": case, "kernel": name, "per_path_date": per,
                     "total": total, "issue_ms": issue_ms,
                     "path_dates": path_dates, "sms": sms,
                     "clock_hz": clock, "card": label})
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
