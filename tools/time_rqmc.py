#!/usr/bin/env python3
"""Time the RQMC net kernels (K52-K55) at ``chip_smoke.py``'s phase 6
shapes on one GPU.

Run from the repository root on a machine with a CUDA device and ``nvcc``:

    python3 tools/time_rqmc.py [--root DIR] [--reps 7]

``--root`` imports ``mctpu_torch`` from another checkout (an unpacked
earlier version, say), so that two versions are timed in one run on one
card.  16 replicates on the default ``EngineConfig``'s layout: K52 and K53
on the call at 2^24 points a replicate, K54 on ``equicorrelated(3, 0.3)``
at 2^20 and ``equicorrelated(100, 0.3)`` at 2^18, K55 arithmetic at 50
dates and 2^18 and geometric at 252 dates and 2^16.  Each time is the
median of ``--reps`` launches (both passes) timed by CUDA events after one
warm-up launch.  Prints the card's name and power limit, one line per
kernel and shape, and a JSON line of them last.  Imports neither jax nor
mctpu.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SEED = 20240607
REPLICATES = 16


def kernel_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    from mctpu_torch import qmc_engine
    from mctpu_torch.engine import EngineConfig
    from mctpu_torch.kernels import rqmc as krqmc
    from mctpu_torch.types import AsianOption, BasketOption, VanillaOption

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = EngineConfig()
    key = qmc_engine.rqmc_key(SEED)
    r = REPLICATES
    call = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
    cases = []
    for name, greeks in (("K52 call 2^24", False), ("K53 call 2^24", True)):
        plan, ops = qmc_engine.vanilla_rqmc_setup(call, 1 << 24, cfg, r,
                                                  greeks=greeks)
        fn = krqmc.greek_partials if greeks else krqmc.vanilla_partials
        cases.append((name, lambda f=fn, o=ops, p=plan: f(o, key, 0, p, r,
                                                          False)))
    for a, n in ((3, 1 << 20), (100, 1 << 18)):
        plan, ops = qmc_engine.basket_rqmc_setup(
            BasketOption.equicorrelated(a, 0.3), n, cfg, r)
        cases.append((f"K54 a={a} 2^{n.bit_length() - 1}",
                      lambda o=ops, p=plan: krqmc.basket_partials(
                          o, key, 0, p, r)))
    for m, avg, n in ((50, "arithmetic", 1 << 18),
                      (252, "geometric", 1 << 16)):
        plan, ops = qmc_engine.asian_rqmc_setup(
            AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=m, average=avg),
            n, cfg, r)
        cases.append((f"K55 {avg} {m} dates 2^{n.bit_length() - 1}",
                      lambda o=ops, p=plan, g=avg == "geometric":
                      krqmc.asian_partials(o, key, 0, p, r, g)))
    out = []
    for name, fn in cases:
        ms = kernel_ms(fn, args.reps)
        out.append({"kernel": name, "ms": ms, "root": str(args.root),
                    "card": smi})
        print(f"{name}: {ms:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
