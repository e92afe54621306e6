#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (one line each; any failure raises, so the exit code is non-zero):

1. device — the card's name and power limit (nvidia-smi);
2. build — the four kernels from ``mctpu_torch/csrc`` with nvcc (sm_90a);
3. kernel vs plain — each kernel against its plain PyTorch version on the
   card at a medium plan (64 blocks, rows 32, 2 iterations): equal at
   rtol 2e-5, two launches bitwise equal, block offsets bitwise;
4. main path — ``mctpu_torch.price_*`` with the default EngineConfig at
   real sizes, each within 4 standard errors of its closed form (or equal
   to the plain version at the same plan);
5. launch counters — every kernel launched during phase 4;
6. times — each kernel and its plain version at its phase-4 shape, median
   of 5 synchronized runs.

The last two lines of output are a JSON line of per-kernel results and the
line ``{"ok": true, "device": {...}}``.  Imports nothing of jax or mctpu.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL = 2e-5  # kernel vs plain: same draws, other summation orders and FMAs
N_SIGMA = 4.0
SEED = 20240607


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def close_rtol(got, want, what: str) -> None:
    """Assert ``got`` equals ``want`` at RTOL elementwise."""
    err = (got.double() - want.double()).abs()
    bound = RTOL * want.double().abs()
    check(bool((err <= bound).all()),
          f"{what}: kernel vs plain beyond rtol {RTOL}: max abs err "
          f"{float(err.max()):.3e}")


def within_sigma(value, want, se, what: str) -> float:
    z = abs(float(value) - float(want)) / float(se)
    check(z < N_SIGMA, f"{what}: {float(value):.6f} vs {float(want):.6f} "
                       f"is {z:.2f} standard errors away")
    return z


def main() -> int:
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mctpu_torch
    from mctpu_torch import _build, engine, estimator as mcest
    from mctpu_torch import math as mcmath
    from mctpu_torch.kernels import basket as kbasket
    from mctpu_torch.kernels import cva as kcva
    from mctpu_torch.kernels import vanilla as kvanilla
    from mctpu_torch.parallel.reduce import pairwise_tree_sum
    from mctpu_torch.types import (BasketOption, CvaPortfolioSpec, CvaSpec,
                                   Precision, VanillaOption)

    check(Path(mctpu_torch.__file__).resolve().is_relative_to(ROOT),
          f"mctpu_torch imported from {mctpu_torch.__file__}, not this "
          "checkout")
    check("jax" not in sys.modules, "jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain K3 reference: FP32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    phase("device", f"{name}; torch {torch.__version__}, CUDA "
                    f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
    print(smi, flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    phase("build", f"{so.relative_to(ROOT)} in "
                   f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. kernel vs plain at a medium plan ----------------------------
    nb, rows, iters = 64, 32, 2

    def contract(label, fn, plain):
        outs = [fn(0, nb), fn(0, nb), fn(2, nb - 2), plain(0, nb)]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        torch.cuda.synchronize()
        worst = 0.0
        for got, again, tail, want in zip(*outs):
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
            check(torch.equal(got, again), f"{label}: launches differ")
            check(torch.equal(got[2:], tail), f"{label}: block offset")
            close_rtol(got, want, label)
            rel = ((got.double() - want.double()).abs()
                   / want.double().abs().clamp(min=1e-30)).max()
            worst = max(worst, float(rel))
        phase("kernel-vs-plain", f"{label}: ok, max rel err {worst:.2e}")

    opt = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
    for label, kind, anti in (("K1 call", "call", False),
                              ("K1 put", "put", False),
                              ("K1 call antithetic", "call", True)):
        o = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
        par = kvanilla.params(o, dev)
        plan = kvanilla.make_plan(nb * iters * 2 * rows * 128, nb, rows, anti)
        put = kind == "put"
        contract(label,
                 lambda off, n: kvanilla.partials(par, SEED, off, plan, n, put),
                 lambda off, n: kvanilla.plain_partials(par, SEED, off, plan,
                                                        n, put))
    for label, bopt in (("K2 default_reference(3)",
                         BasketOption.default_reference(3)),
                        ("K3 default_reference(10)",
                         BasketOption.default_reference(10)),
                        ("K3 equicorrelated(100)",
                         BasketOption.equicorrelated(100))):
        a = bopt.n_assets
        ops = kbasket.operands(bopt, mcmath.cholesky_lower(bopt.corr), dev)
        plan = kbasket.make_plan(1, nb, rows, False, n_assets=a)
        plan = kbasket.make_plan(nb * iters * plan.paths_per_iter, nb, rows,
                                 False, n_assets=a)
        contract(label,
                 lambda off, n: kbasket.partials(ops, SEED, off, plan, n),
                 lambda off, n: kbasket.plain_partials(ops, SEED, off, plan,
                                                       n))
    spec50 = CvaSpec(0.03, 0.6, VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0),
                     50)
    for label, port, prec in (
            ("K4 n_grid=50", CvaPortfolioSpec.from_single(spec50),
             Precision.F32_KAHAN),
            ("K4 WWR b=0.8", CvaPortfolioSpec.from_single(spec50, wwr_b=0.8),
             Precision.F32_KAHAN),
            ("K4 F32_DS", CvaPortfolioSpec.from_single(spec50),
             Precision.F32_DS),
            ("K4 netted 2-option", CvaPortfolioSpec(
                0.03, 0.6, 100.0, 0.05, 0.2, 1.0, [95.0, 110.0], [1.0, -0.5],
                0.0, 50), Precision.F32_KAHAN)):
        ops = kcva.operands(port, dev)
        wwr = float(port.wwr_b) != 0.0
        plan = kcva.make_plan(nb * iters * rows * 128, nb, rows, False,
                              prec.kahan, prec.ds)
        contract(label,
                 lambda off, n: kcva.partials(ops, SEED, off, plan, n, wwr),
                 lambda off, n: kcva.plain_partials(ops, SEED, off, plan, n,
                                                    wwr))

    # ---- 4. the main path at real size -----------------------------------
    counters = (kvanilla.LAUNCHES, kbasket.LAUNCHES, kcva.LAUNCHES)
    for c in counters:
        for k in c:
            c[k] = 0
    cfg = engine.EngineConfig()
    t_main = time.perf_counter()

    n_van = 1 << 28
    bs = float(mcmath.bs_call(100.0, 100.0, 0.048790, 0.2, 1.0))
    res = mctpu_torch.price_vanilla(opt, n_van, SEED)
    z = within_sigma(res.price, bs, res.std_error, "vanilla call")
    phase("main-path", f"vanilla call 2^28: {float(res.price):.6f} "
                       f"(BS {bs:.6f}, z={z:.2f}, n_paths={res.n_paths})")
    put = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind="put")
    bs_put = float(mcmath.bs_put(100.0, 100.0, 0.048790, 0.2, 1.0))
    res = mctpu_torch.price_vanilla(put, n_van, SEED)
    z = within_sigma(res.price, bs_put, res.std_error, "vanilla put")
    phase("main-path", f"vanilla put 2^28: {float(res.price):.6f} "
                       f"(parity {bs_put:.6f}, z={z:.2f})")
    res_a = mctpu_torch.price_vanilla(
        opt, n_van, SEED, engine.EngineConfig(antithetic=True))
    z = within_sigma(res_a.price, bs, res_a.std_error, "vanilla antithetic")
    phase("main-path", f"vanilla call antithetic 2^28: "
                       f"{float(res_a.price):.6f} (z={z:.2f}, se "
                       f"{float(res_a.std_error):.2e})")

    one = BasketOption(s=[100.0], v=[0.2], w=[1.0], corr=[[1.0]], d=[0.0],
                       k=100.0, r=0.048790, t=1.0)
    res = mctpu_torch.price_basket(one, 1 << 24, SEED)
    z = within_sigma(res.price, bs, res.std_error, "basket a=1")
    phase("main-path", f"basket a=1 2^24: {float(res.price):.6f} (BS, "
                       f"z={z:.2f})")
    basket_cells = {}
    for label, bopt, n in (("K2", BasketOption.default_reference(3), 1 << 24),
                           ("K3", BasketOption.equicorrelated(100), 1 << 22)):
        res = mctpu_torch.price_basket(bopt, n, SEED)
        plan, ops = engine.basket_setup(bopt, n, cfg)
        plain = kbasket.plain_partials(ops, SEED, 0, plan, plan.num_blocks)
        want = mcest.estimate(*mcest.combine_block_partials(plain),
                              plan.total_units,
                              discount=math.exp(-bopt.r * bopt.t)).price
        check(bool(torch.isfinite(res.price))
              and res.n_paths == plan.total_paths,
              f"basket {label}: bad result")
        check(abs(float(res.price) - float(want)) <= RTOL * abs(float(want)),
              f"basket {label}: price {float(res.price):.7f} vs plain "
              f"{float(want):.7f}")
        basket_cells[label] = (bopt, n)
        phase("main-path", f"basket a={bopt.n_assets} 2^{n.bit_length() - 1}"
                           f" ({label}): {float(res.price):.6f} ± "
                           f"{float(res.ci):.6f}, equals plain "
                           f"{float(want):.6f}")

    for n_grid in (50, 500):
        spec = CvaSpec(0.03, 0.6, VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0),
                       n_grid)
        want = float(mcmath.cva_closed_form(0.03, 0.6, 100.0, 100.0, 0.05, 0.2,
                                            1.0, n_grid))
        c0 = float(mcmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
        tj = torch.arange(1, n_grid + 1, dtype=torch.float64) / n_grid
        ee_want = c0 * torch.exp(0.05 * tj)  # E[ee_j] = e^{r t_j} C(S0, T)
        for prec in (Precision.F32_KAHAN, Precision.F32_DS):
            res = mctpu_torch.price_cva(spec, 1 << 20, SEED,
                                        engine.EngineConfig(precision=prec))
            z = within_sigma(res.cva, want, res.std_error,
                             f"CVA n_grid={n_grid} {prec.value}")
            ee = res.expected_exposure
            check(ee.shape == (n_grid,) and bool(torch.isfinite(ee).all()),
                  "CVA profile shape")
            dev_ee = float((ee / ee_want - 1).abs().max())
            check(dev_ee < 0.01, f"EE profile off its martingale value by "
                                 f"{dev_ee:.3%}")
            phase("main-path", f"CVA n_grid={n_grid} {prec.value} 2^20: "
                               f"{float(res.cva):.6f} (closed form "
                               f"{want:.6f}, z={z:.2f}; EE within "
                               f"{dev_ee:.2%})")
    torch.cuda.synchronize()
    phase("main-path", f"done in {time.perf_counter() - t_main:.1f} s")

    # ---- 5. launch counters ----------------------------------------------
    launches = {k: v for c in counters for k, v in c.items()}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    phase("launches", json.dumps(launches))

    # ---- 6. times at the phase-4 shapes ----------------------------------
    def median_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    kernels = []

    def estimates(outs, plan, disc):
        """The price (and, for CVA, the EE profile) the engine forms from
        these partials."""
        sums = mcest.combine_block_partials(outs[0])
        vals = [mcest.estimate(*sums, plan.total_units,
                               discount=disc).price.reshape(1)]
        if len(outs) > 1:
            vals.append(pairwise_tree_sum(outs[1].double(), 0).cpu()
                        / plan.total_units)
        return torch.cat(vals)

    def timed(kname, source, replaces, plan, steps, disc, kernel, plain):
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            close_rtol(g, w, kname)
        # max_abs_err: kernel vs plain in the estimates, in price units.
        err = float((estimates(got, plan, disc)
                     - estimates(want, plan, disc)).abs().max())
        ms, plain_ms = median_ms(kernel), median_ms(plain)
        rate = plan.total_paths * steps / (ms * 1e-3)
        unit = "path-steps/s" if steps > 1 else "paths/s"
        phase("times", f"{kname}: kernel {ms:.3f} ms ({rate:.4g} {unit}), "
                       f"plain {plain_ms:.3f} ms, {plan.num_blocks} blocks x "
                       f"{plan.iters} iters x rows {plan.rows}; "
                       f"[{smi}]")
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    plan, par = engine.vanilla_setup(opt, n_van, cfg)
    timed("vanilla", "mctpu_torch/csrc/vanilla.cu",
          "mctpu/kernels/vanilla.py:107", plan, 1, math.exp(-opt.r * opt.t),
          lambda: kvanilla.partials(par, SEED, 0, plan, plan.num_blocks,
                                    False),
          lambda: kvanilla.plain_partials(par, SEED, 0, plan,
                                          plan.num_blocks, False))
    for kname, label, replaces in (
            ("basket_am", "K2", "mctpu/kernels/basket.py:353"),
            ("basket_packed", "K3", "mctpu/kernels/basket.py:311")):
        bopt, n = basket_cells[label]
        plan, ops = engine.basket_setup(bopt, n, cfg)
        timed(kname, "mctpu_torch/csrc/basket.cu", replaces, plan, 1,
              math.exp(-bopt.r * bopt.t),
              lambda: kbasket.partials(ops, SEED, 0, plan, plan.num_blocks),
              lambda: kbasket.plain_partials(ops, SEED, 0, plan,
                                             plan.num_blocks))
    port = CvaPortfolioSpec.from_single(
        CvaSpec(0.03, 0.6, VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0), 500))
    plan, ops = engine.cva_setup(port, 1 << 20, cfg)
    timed("cva", "mctpu_torch/csrc/cva.cu", "mctpu/kernels/cva.py:409", plan,
          500, 1.0,
          lambda: kcva.partials(ops, SEED, 0, plan, plan.num_blocks, False),
          lambda: kcva.plain_partials(ops, SEED, 0, plan, plan.num_blocks,
                                      False))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
