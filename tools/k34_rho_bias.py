#!/usr/bin/env python3
"""Tell bias from noise in the gap between K34's likelihood-ratio rho and a
common-random-number bump of r, over many seeds, on one GPU.

Run from the repository root on a machine with a CUDA device and ``nvcc``:

    python3 tools/k34_rho_bias.py [--seeds 16] [--log2-paths 23]

On ``chip_smoke.py``'s basket-barrier Greeks cell (``equicorrelated(3,
0.3)``, up-and-out at H = 130, 50 dates, the default ``EngineConfig``) and
for each seed: ``greeks_basket_barrier``'s rho (K34) and its standard
error, and the central difference ``(p(r + h) - p(r - h)) / 2h`` of
``price_basket_barrier`` on the same seed (common random numbers) at h =
0.01 (``chip_smoke.py``'s gate) and h = 0.02.  Per seed the gap is the LR
rho less the bump; over the seeds the mean gap, its standard error (the
gaps' sample deviation over sqrt(seeds)), their ratio, and the LR rho's
mean standard error over sqrt(seeds) beside it.  A mean gap many
standard errors from zero at both h is a bias of one of the estimators; a
mean gap within about two is noise.

Prints the card's name and power limit, one line per seed, the summary,
and a JSON line last.  Imports neither jax nor mctpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BASE_SEED = 20240607
STEPS = (0.01, 0.02)


def main() -> int:
    import mctpu_torch as mt
    from mctpu_torch.types import BasketBarrierOption, BasketOption

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--log2-paths", type=int, default=23)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    n = 1 << args.log2_paths
    gb = BasketBarrierOption(BasketOption.equicorrelated(3, 0.3), 130.0,
                             n_obs=50)
    r0 = float(gb.basket.r)

    def price(r, seed):
        opt = dataclasses.replace(
            gb, basket=dataclasses.replace(gb.basket, r=r))
        return float(mt.price_basket_barrier(opt, n, seed).price)

    rows = []
    for i in range(args.seeds):
        seed = BASE_SEED + 7919 * i
        g = mt.greeks(gb, n, seed)
        row = {"seed": seed, "rho": float(g.rho.price),
               "se": float(g.rho.std_error)}
        for h in STEPS:
            row[f"bump_{h:g}"] = (price(r0 + h, seed)
                                  - price(r0 - h, seed)) / (2 * h)
            row[f"gap_{h:g}"] = row["rho"] - row[f"bump_{h:g}"]
        rows.append(row)
        print(f"seed {seed}: LR rho {row['rho']:.6f} (se {row['se']:.3e}); "
              + "; ".join(f"bump h={h:g} {row[f'bump_{h:g}']:.6f}, gap "
                          f"{row[f'gap_{h:g}']:+.6f}" for h in STEPS),
              flush=True)
    k = len(rows)
    summary = {"card": smi, "paths": n, "seeds": k,
               "lr_se_of_mean": statistics.fmean(r["se"] for r in rows)
               / math.sqrt(k)}
    for h in STEPS:
        gaps = [r[f"gap_{h:g}"] for r in rows]
        mean = statistics.fmean(gaps)
        se = statistics.stdev(gaps) / math.sqrt(k) if k > 1 else math.nan
        summary[f"h={h:g}"] = {"mean_gap": mean, "se_of_mean_gap": se,
                               "z": mean / se if se > 0 else math.nan}
        print(f"h={h:g}: mean gap {mean:+.6f}, its standard error "
              f"{se:.6f} (z = {mean / se:+.2f}) over {k} seeds at 2^"
              f"{args.log2_paths} paths [{smi}]", flush=True)
    print(f"LR rho's standard error over sqrt(seeds): "
          f"{summary['lr_se_of_mean']:.6f}", flush=True)
    print(json.dumps({"rows": rows, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
