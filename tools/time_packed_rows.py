#!/usr/bin/env python3
"""Time the packed basket walk (K31) and its Greeks (K33) at several tile
heights ``rows`` on one GPU.

Run from the repository root on a machine with a CUDA device and ``nvcc``:

    python3 tools/time_packed_rows.py [--root DIR] [--rows 256 200 96 24]

``--root`` imports ``mctpu_torch`` from another checkout (an unpacked
earlier commit, say), so that two versions are timed in one run on one
card.  For each ``rows``, with ``EngineConfig(rows=rows)`` and 2^22 paths:
the kernel of ``price_basket_asian`` on ``BasketOption.equicorrelated(16)``
at 50 dates, and the kernel of ``greeks_basket_asian`` on
``equicorrelated(16, 0.3)`` at 12 dates where the checkout has it (null
where it refuses 16 assets).  Each time is the median of 7 launches timed
by CUDA events after one warm-up launch.  Prints the card's name and power
limit, one line per ``rows`` and a JSON line of the rows last.  Imports
neither jax nor mctpu.
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
N_PATHS = 1 << 22
REPS = 7


def kernel_ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
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
    ap.add_argument("--rows", type=int, nargs="+", default=[256, 200, 96, 24])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    from mctpu_torch import engine
    from mctpu_torch.kernels import multi_walk as kmw
    from mctpu_torch.types import BasketAsianOption, BasketOption

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    price_opt = BasketAsianOption(BasketOption.equicorrelated(16), n_obs=50)
    greek_opt = BasketAsianOption(BasketOption.equicorrelated(16, 0.3),
                                  n_obs=12)
    out = []
    for rows in args.rows:
        cfg = engine.EngineConfig(rows=rows)
        plan, ops = engine.basket_asian_setup(price_opt, N_PATHS, cfg)
        k31 = kernel_ms(lambda: kmw.partials(*ops, SEED, 0, plan,
                                             plan.num_blocks, "asian", 50))
        try:
            gplan, gops = engine.greeks_basket_asian_setup(greek_opt, N_PATHS,
                                                           cfg)
            k33 = kernel_ms(lambda: kmw.am_greek_partials(
                *gops, SEED, 0, gplan, gplan.num_blocks, 12))
        except NotImplementedError:
            k33 = None
        out.append({"rows": rows, "plan_rows": plan.rows,
                    "num_blocks": plan.num_blocks, "iters": plan.iters,
                    "k31_ms": k31, "k33_ms": k33, "root": str(args.root),
                    "card": smi})
        print(f"rows {rows} (plan {plan.num_blocks} x {plan.iters} x "
              f"{plan.rows}): K31 {k31:.4f} ms, K33 "
              f"{'n/a' if k33 is None else f'{k33:.4f} ms'}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
