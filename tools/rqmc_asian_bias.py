#!/usr/bin/env python3
"""Split the RQMC Asian's gap to its closed form into its sources.

Run from the repository root (a card by default; ``--device cpu`` runs the
plain version, for a small ``--points``):

    python3 tools/rqmc_asian_bias.py [--n-obs 252] [--points 131072]
        [--average geometric] [--seed 20240607 ...] [--device cuda]

``mctpu_torch.qmc_engine.price_asian_rqmc`` evaluates its nets in float32:
the 23-bit uniform ``(x >> 7) 2^-23`` of each 30-bit shifted Sobol integer
``x``, the Giles quantile, the bridge, the tree sum and the payoff.  This
script prices the same option on the same points (the engine's plan, its
replicate shifts, every integer ``x``) four ways and prints each price, its
replicate spread and its gap to the closed form (geometric) in units of the
engine's floored standard error:

- ``float32``: the engine as it runs (K55 on a card);
- ``giles->f64``: the engine's float32 normals, everything after them in
  float64;
- ``ndtri(u23)``: the same 23-bit uniforms through the exact quantile,
  float64 throughout;
- ``ndtri(mid30)``: the 30-bit midpoints ``(x + 1/2) 2^-30`` through the
  exact quantile, float64 throughout.

The float32 arithmetic's share is the first gap less the second; the
quantile's, the second less the third; the uniforms' truncation to 23 bits,
the third less the fourth.  The chunks of every replicate carry in float64.
Given several seeds, it ends with each variant's mean gap in standard
errors over them.  Imports nothing of jax or mctpu.
"""
from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mctpu_torch import math as mcmath  # noqa: E402
from mctpu_torch import qmc_engine, sobol  # noqa: E402
from mctpu_torch.engine import EngineConfig, _discount  # noqa: E402
from mctpu_torch.kernels import rqmc as krqmc  # noqa: E402
from mctpu_torch.types import AsianOption  # noqa: E402

# Elements (replicates x points x dims) of one float64 batch.
BATCH = 1 << 24


def f64_replicate_means(opt: AsianOption, plan, key, n_blocks: int,
                        device) -> dict[str, torch.Tensor]:
    """Each float64 variant's ``(n_blocks,)`` replicate-mean payoffs over
    the plan's points."""
    m = opt.n_obs
    v = krqmc._tables(m)[0]
    v = torch.as_tensor(v, device=device)
    shifts = krqmc.rep_shifts(*key, 0, n_blocks, m).to(device)
    ppc = plan.paths_per_iter
    t_j = opt.t * torch.arange(1, m + 1, dtype=torch.float64,
                               device=device) / m
    base = math.log(opt.s) + (opt.r - 0.5 * opt.v * opt.v) * t_j
    eps = 1e-7

    def payoffs(z):
        w = sobol.bridge_paths(z, opt.t)  # (m, R, nc, ppc)
        log_s = base.view(m, 1, 1, 1) + opt.v * w
        if opt.average == "geometric":
            avg = torch.exp(log_s.mean(0))
        else:
            avg = torch.exp(log_s).mean(0)
        return torch.clamp(avg - opt.k, min=0.0).sum((1, 2))

    sums = {k: torch.zeros(n_blocks, dtype=torch.float64, device=device)
            for k in ("giles->f64", "ndtri(u23)", "ndtri(mid30)")}
    per = max(1, BATCH // (n_blocks * ppc * m))
    for c0 in range(0, plan.iters, per):
        chunks = torch.arange(c0, min(c0 + per, plan.iters),
                              dtype=torch.int64, device=device)
        x = krqmc.net_bits(chunks, ppc, v, shifts)  # (R, nc, ppc, m)
        u32 = krqmc.u_from_bits30(x)
        sums["giles->f64"] += payoffs(mcmath.norm_ppf_f32(u32).double())
        u23 = torch.clamp(u32.double(), eps, 1.0 - eps)
        sums["ndtri(u23)"] += payoffs(torch.special.ndtri(u23))
        mid = (x.double() + 0.5) * 2.0 ** -30
        sums["ndtri(mid30)"] += payoffs(torch.special.ndtri(mid))
    return {k: s / plan.paths_per_block for k, s in sums.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-obs", type=int, default=252)
    ap.add_argument("--points", type=int, default=131072,
                    help="points a replicate (the JAX CLI's default)")
    ap.add_argument("--replicates", type=int, default=16)
    ap.add_argument("--average", default="geometric",
                    choices=("geometric", "arithmetic"))
    ap.add_argument("--seed", type=int, nargs="+", default=[20240607])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip())
    opt = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=args.n_obs,
                      average=args.average)
    cfg = EngineConfig(device=args.device)
    r = args.replicates
    plan, ops = qmc_engine.asian_rqmc_setup(opt, args.points, cfg, r)
    geo = args.average == "geometric"
    disc = math.exp(-opt.r * opt.t)
    cf = (float(mcmath.geometric_asian_call(opt.s, opt.k, opt.r, opt.v,
                                            opt.t, opt.n_obs))
          if geo else None)
    zs = {}
    for seed in args.seed:
        key = qmc_engine.rqmc_key(seed)
        quads = krqmc.asian_partials(ops, key, 0, plan, r, geo)
        res = qmc_engine._rqmc_estimate(quads, plan.paths_per_block,
                                        _discount(opt.r, opt.t))
        q = quads.double().cpu()
        means = {"float32": (q[:, 0] + q[:, 1]) / plan.paths_per_block}
        means.update({k: x.cpu() for k, x in f64_replicate_means(
            opt, plan, key, r, device).items()})
        se = float(res.std_error)
        print(f"{args.average} Asian, {opt.n_obs} dates, {r} x "
              f"{plan.paths_per_block} points, seed {seed}: engine price "
              f"{float(res.price):.9f}, floored std error {se:.6e}"
              + (f", closed form {cf:.9f}" if geo else ""))
        for name, mv in means.items():
            price = disc * float(mv.mean())
            spread = disc * float(mv.std()) / math.sqrt(r)
            line = f"{name:>13}: {price:.9f}  spread {spread:.3e}"
            if geo:
                zs.setdefault(name, []).append((price - cf) / se)
                line += (f"  - closed form {price - cf:+.4e} "
                         f"({(price - cf) / se:+.2f} se)")
            print(line, flush=True)
    if len(args.seed) > 1:
        for name, z in zs.items():
            n = len(z)
            print(f"{name:>13}: mean gap {sum(z) / n:+.3f} se over {n} "
                  f"seeds, mean square {sum(x * x for x in z) / n:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
