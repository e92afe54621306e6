#!/usr/bin/env python3
"""Measure the discretization bias of the full-truncation Euler Heston walk.

Run from the repository root (CPU only, NumPy float64, a few minutes):

    python3 tools/heston_euler_bias.py [--paths 4194304] [--steps 100]

Walks the scheme of ``mctpu_torch.kernels.heston`` (log-spot x, ``vp =
max(v, 0)``, one correlated normal pair a step) in float64 over NumPy
normals.  For each Heston option the port's chip gates use it prints

- the Monte Carlo call price minus the characteristic-function price, with
  the discounted terminal spot as a control variate (its mean is ``s0``
  exactly);
- delta, vega (d/dv0) and rho of the scheme, as central differences over
  common random numbers, minus the same central differences of the
  characteristic-function price.

Each gap is the scheme's bias at that step count (within its standard
error), which ``chip_smoke.py`` allows beside its own standard errors.
Imports nothing of jax or mctpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mctpu_torch.models.heston import cf_call_price  # noqa: E402
from mctpu_torch.types import HestonOption  # noqa: E402

OPTIONS = {
    # tests/test_heston.py's option (Feller satisfied: 2 kappa theta > xi^2)
    "opt": HestonOption(100.0, 100.0, 0.05, 1.0, 0.04, 2.0, 0.04, 0.3, -0.7),
    # tests/test_greeks.py's Greeks option
    "gopt": HestonOption(100.0, 100.0, 0.03, 1.0, 0.09, 2.0, 0.09, 0.4, -0.6),
}
# Central-difference half-widths of the Greeks: spot, v0, r.
BUMPS = {"delta": ("s", 0.5), "vega": ("v0", 2e-3), "rho": ("r", 2e-3)}


def euler_payoffs(opt: HestonOption, n_paths: int, n_steps: int, seed: int,
                  chunk: int = 1 << 18):
    """Per-path discounted payoffs and discounted terminal spots."""
    rng = np.random.default_rng(seed)
    dt = opt.t / n_steps
    sqdt = math.sqrt(dt)
    rho_s = math.sqrt(1.0 - opt.rho * opt.rho)
    disc = math.exp(-opt.r * opt.t)
    pays, sts = [], []
    for start in range(0, n_paths, chunk):
        m = min(chunk, n_paths - start)
        x = np.zeros(m)
        v = np.full(m, opt.v0)
        for _ in range(n_steps):
            z_v, z_p = rng.standard_normal((2, m))
            vp = np.maximum(v, 0.0)
            sq_v = np.sqrt(vp) * sqdt
            z_s = opt.rho * z_v + rho_s * z_p
            x += opt.r * dt - 0.5 * vp * dt + sq_v * z_s
            v += opt.kappa * dt * (opt.theta - vp) + opt.xi * sq_v * z_v
        st = opt.s * np.exp(x)
        pays.append(disc * np.maximum(st - opt.k, 0.0))
        sts.append(disc * st)
    return np.concatenate(pays), np.concatenate(sts)


def price_gap(opt: HestonOption, n_paths: int, n_steps: int, seed: int):
    """``(mc - cf, standard error)`` of the control-variate estimate."""
    pay, st = euler_payoffs(opt, n_paths, n_steps, seed)
    beta = np.cov(pay, st)[0, 1] / np.var(st)
    adj = pay - beta * (st - opt.s)
    return (float(adj.mean()) - cf_call_price(opt),
            float(adj.std() / math.sqrt(n_paths)))


def greek_gap(opt: HestonOption, field: str, h: float, n_paths: int,
              n_steps: int, seed: int):
    """``(scheme - cf, standard error)`` of a central difference in
    ``field``, the scheme's over common random numbers."""
    up = dataclasses.replace(opt, **{field: getattr(opt, field) + h})
    down = dataclasses.replace(opt, **{field: getattr(opt, field) - h})
    fd = (euler_payoffs(up, n_paths, n_steps, seed)[0]
          - euler_payoffs(down, n_paths, n_steps, seed)[0]) / (2 * h)
    cf = (cf_call_price(up) - cf_call_price(down)) / (2 * h)
    return float(fd.mean()) - cf, float(fd.std() / math.sqrt(n_paths)), cf


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", type=int, default=1 << 22)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--no-greeks", action="store_true")
    args = ap.parse_args()
    for name, opt in OPTIONS.items():
        gap, se = price_gap(opt, args.paths, args.steps, args.seed)
        print(f"{name}: Euler {args.steps} steps, {args.paths} paths: "
              f"price MC - CF = {gap:+.6f} (se {se:.6f}); CF "
              f"{cf_call_price(opt):.6f}", flush=True)
        if args.no_greeks or name != "gopt":
            continue
        for greek, (field, h) in BUMPS.items():
            gap, se, cf = greek_gap(opt, field, h, args.paths, args.steps,
                                    args.seed)
            print(f"{name}: {greek} CRN central difference (h {h}) minus "
                  f"CF's = {gap:+.6f} (se {se:.6f}); CF {cf:.6f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
