#!/usr/bin/env python3
"""How far the frozen-rule American Greeks move with the pilot's seed.

Run from the repository root (``--device cpu`` runs the kernels' plain
versions, which draw the same paths):

    python3 tools/american_greeks_spread.py [--device cpu] [--paths 20]
        [--seeds 8]

For the at-the-money put (S=K=100, r=0.05, v=0.2, T=1) at 12 and 50
exercise dates, ``greeks_american`` at ``2^paths`` paths and seeds 1..N:
each Greek's z-score against central differences of the Bermudan lattice
at the same dates (``chip_smoke.bermudan``, 4800 or 5000 steps) and of the
continuous CRR-4000 lattice, and the pathwise delta minus the frozen-rule
CRN difference of ``price_american`` (h = 0.5).  The rule is refitted on
each seed's 2^15-path pilot, so the spread of the z-scores beyond +-4 is
the rule's boundary term, which no path count removes.  Prints one line a
seed and a JSON list last.  Imports neither jax nor mctpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def diffs(price):
    """Central differences of ``price(s, r, v)``: delta, vega, rho."""
    at = {"s": 100.0, "r": 0.05, "v": 0.2}

    def fd(name, h):
        up, dn = dict(at), dict(at)
        up[name] += h
        dn[name] -= h
        return (price(**up) - price(**dn)) / (2 * h)

    return {"delta": fd("s", 0.25), "vega": fd("v", 5e-3),
            "rho": fd("r", 2e-3)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paths", type=int, default=20, help="log2 of paths")
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import mctpu_torch as mt
    from chip_smoke import bermudan
    from mctpu_torch import lsm
    from mctpu_torch.math import binomial_american

    cfg = mt.EngineConfig(device=args.device)
    n = 1 << args.paths
    amer = diffs(lambda s, r, v: binomial_american(s, 100.0, r, v, 1.0, 4000,
                                                   "put"))
    rows = []
    for n_steps, lattice in ((12, 4800), (50, 5000)):
        berm = diffs(lambda s, r, v: bermudan(s, 100.0, r, v, 1.0, n_steps,
                                              lattice))
        opt = mt.AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                n_steps=n_steps)
        for seed in range(1, args.seeds + 1):
            g = mt.greeks_american(opt, n, seed, cfg)
            beta = lsm.fit_exercise_rule(100.0, 100.0, 0.05, 0.2, 1.0, seed,
                                         1 << 15, n_steps, "put",
                                         device=cfg.torch_device())
            crn = [float(lsm._price_forward_engine(
                dataclasses.replace(opt, s=100.0 + ds), beta, seed, n, cfg,
                False).price) for ds in (0.5, -0.5)]
            row = {"n_steps": n_steps, "seed": seed, "paths": n,
                   "delta_minus_crn": float(g.delta.price) - (crn[0]
                                                              - crn[1])}
            for name in ("delta", "vega", "rho"):
                r = getattr(g, name)
                got, se = float(r.price), float(r.std_error)
                row[name] = got
                row[f"z_{name}_bermudan"] = (got - berm[name]) / se
                row[f"z_{name}_crr4000"] = (got - amer[name]) / se
            rows.append(row)
            print(" ".join(f"{k}={v:.4g}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in row.items()),
                  flush=True)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
