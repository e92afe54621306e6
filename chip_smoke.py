#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (one line each; any failure raises, so the exit code is non-zero):

1. device — the card's name and power limit (nvidia-smi);
2. build — the eight kernels from ``mctpu_torch/csrc`` with nvcc (sm_90a),
   one nvcc per source, all started together;
3. kernel vs plain — each kernel against its plain PyTorch version on the
   card at a medium plan (64 blocks, rows 32, 2 iterations): equal at
   rtol 2e-5 (the Greek kernels' (sum x, sum x^2) pairs by the scaled
   bound rtol * (|sum x| + sqrt(n * sum x^2)), n the units per block,
   because a Greek's block sum can nearly cancel; rtol 1e-4 under
   wrong-way risk), two launches bitwise equal, block offsets bitwise;
4. main paths, each with the launch counters set to 0 just before it and
   read just after: the pricing path (``mctpu_torch.price_*`` with the
   default EngineConfig at real sizes, each within 4 standard errors of
   its closed form, or equal to the plain version at the same plan) and
   the Greeks path (``mctpu_torch.greeks`` at real sizes: vanilla against
   Black-Scholes Greeks, basket against common-random-number bumps of
   ``price_basket``, CVA against finite differences of its closed form and
   CRN bumps under wrong-way risk; each Greeks price equal to its
   pricer's at the same seed);
5. launch counters — every kernel of each path launched during its run;
6. times — each kernel and its plain version at its phase-4 shape, median
   of 5 synchronized runs (3 for the slower plain versions, said so in
   the line).

The last two lines of output are a JSON line of per-kernel results and the
line ``{"ok": true, "device": {...}}``.  Imports nothing of jax or mctpu.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RTOL = 2e-5  # kernel vs plain: same draws, other summation orders and FMAs
RTOL_WWR = 1e-4  # the WWR hazard's y < 0.01 series switch can flip on an ulp
N_SIGMA = 4.0
SEED = 20240607
PRICE_KERNELS = ("vanilla", "basket_am", "basket_packed", "cva")
GREEK_KERNELS = ("greeks_vanilla", "greeks_basket_am", "greeks_basket_packed",
                 "cva_greeks")


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


def close_pairs(got, want, units: int, rtol: float, what: str) -> float:
    """Assert the (sum x, sum x^2) pairs along axis 1 of ``got`` match
    ``want``: rtol * (|want sum x| + sqrt(units * want sum x^2)) on sum x,
    rtol * want sum x^2 on sum x^2.  Returns the largest error / bound."""
    got, want = got.double(), want.double()
    s, s2 = want[:, 0::2], want[:, 1::2].abs()
    bound = torch.empty_like(want)
    bound[:, 0::2] = rtol * (s.abs() + torch.sqrt(units * s2))
    bound[:, 1::2] = rtol * s2
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    check(bool((err <= bound).all()),
          f"{what}: kernel vs plain beyond the scaled bound (rtol {rtol}): "
          f"max abs err {float(err.max()):.3e}")
    return float((err / bound.clamp(min=1e-300)).max())


def within_sigma(value, want, se, what: str) -> float:
    z = abs(float(value) - float(want)) / float(se)
    check(z < N_SIGMA, f"{what}: {float(value):.6f} vs {float(want):.6f} "
                       f"is {z:.2f} standard errors away")
    return z


def crn_gate(got, se, fd, what: str) -> float:
    """Assert ``got`` is within 5 standard errors plus 0.5% of a common-
    random-number finite difference ``fd`` (O(h^2) bias); returns the
    distance in standard errors."""
    got, se = float(got), float(se)
    check(abs(got - fd) < 5 * se + 5e-3 * abs(fd),
          f"{what}: {got:.6f} vs CRN bump {fd:.6f} (se {se:.2e})")
    return abs(got - fd) / se


def greeks_path(mt, mcmath) -> None:
    """The Greeks path at real sizes through ``mctpu_torch.greeks`` with
    the default EngineConfig, each output against its oracle."""
    from mctpu_torch.types import (BasketOption, CvaPortfolioSpec, CvaSpec,
                                   VanillaOption)

    # Vanilla (K6): Black-Scholes Greeks; the put's by put-call parity.
    n = 1 << 28
    fields = ("price", "delta", "vega", "rho", "theta", "gamma", "vanna",
              "volga")
    cf = {k: float(v) for k, v in
          mcmath.bs_greeks(100.0, 100.0, 0.048790, 0.2, 1.0).items()}
    disc = math.exp(-0.048790)
    parity = {"delta": cf["delta"] - 1.0, "vega": cf["vega"],
              "rho": cf["rho"] - 100.0 * disc,
              "theta": cf["theta"] - 0.048790 * 100.0 * disc,
              "gamma": cf["gamma"], "vanna": cf["vanna"],
              "volga": cf["volga"]}
    for kind, want, names in (("call", cf, fields),
                              ("put", parity, fields[1:])):
        opt = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
        g = mt.greeks(opt, n, SEED)
        zs = {f: within_sigma(getattr(g, f).price, want[f],
                              getattr(g, f).std_error, f"vanilla {kind} {f}")
              for f in names}
        p = float(mt.price_vanilla(opt, n, SEED).price)
        check(abs(float(g.price.price) - p) <= RTOL * abs(p),
              f"vanilla {kind}: Greeks price {float(g.price.price):.7f} vs "
              f"price_vanilla {p:.7f}")
        phase("greeks-path", f"vanilla {kind} 2^28 (K6): z "
              + ", ".join(f"{f}={z:.2f}" for f, z in zs.items())
              + f"; price equals price_vanilla ({p:.6f})")

    def basket_fd(bopt, n, field, i, h):
        def price(x):
            vals = np.asarray(getattr(bopt, field), float).copy()
            vals[i] = x
            o = dataclasses.replace(bopt, **{field: vals})
            return float(mt.price_basket(o, n, SEED).price)

        x0 = float(np.asarray(getattr(bopt, field))[i])
        return (price(x0 + h) - price(x0 - h)) / (2 * h)

    # Basket (K7, K8): delta and vega against CRN bumps of price_basket.
    for label, bopt, n, assets in (
            ("K7 default_reference(3) 2^24", BasketOption.default_reference(3),
             1 << 24, (0, 1, 2)),
            ("K8 equicorrelated(100) 2^22", BasketOption.equicorrelated(100),
             1 << 22, (0,))):
        g = mt.greeks(bopt, n, SEED)
        p = float(mt.price_basket(bopt, n, SEED).price)
        check(abs(float(g.price.price) - p) <= RTOL * abs(p),
              f"basket {label}: Greeks price {float(g.price.price):.7f} vs "
              f"price_basket {p:.7f}")
        zs = []
        for i in assets:
            zs.append(crn_gate(g.delta.price[i], g.delta.std_error[i],
                               basket_fd(bopt, n, "s", i, 0.1),
                               f"basket {label} delta_{i}"))
            if bopt.n_assets <= 8:
                zs.append(crn_gate(g.vega.price[i], g.vega.std_error[i],
                                   basket_fd(bopt, n, "v", i, 1e-3),
                                   f"basket {label} vega_{i}"))
        if bopt.n_assets == 3:
            check(g.gamma is None, "default_reference(3) has no Stein tilt: "
                                   "gamma must be None")
        else:
            check(bool(torch.isfinite(g.gamma.price).all()),
                  f"basket {label}: non-finite gamma")
        phase("greeks-path", f"basket {label}: price equals price_basket "
                             f"({p:.6f}); delta/vega vs CRN bumps, max "
                             f"|z| {max(zs):.2f}; gamma "
                             f"{'None' if g.gamma is None else 'finite'}")

    # Basket gamma (K7): CRN central difference of delta_0.
    b3 = BasketOption.equicorrelated(3)
    n3, h = 1 << 24, 0.5
    g = mt.greeks(b3, n3, SEED)
    up, dn = (mt.greeks(dataclasses.replace(
        b3, s=np.asarray(b3.s, float) + sgn * h * np.eye(3)[0]), n3, SEED)
        for sgn in (1.0, -1.0))
    fd = (float(up.delta.price[0]) - float(dn.delta.price[0])) / (2 * h)
    z = crn_gate(g.gamma.price[0], g.gamma.std_error[0], fd,
                 "basket equicorrelated(3) gamma_0")
    phase("greeks-path", f"basket equicorrelated(3) 2^24 (K7): gamma_0 "
                         f"{float(g.gamma.price[0]):.6f} vs CRN delta FD "
                         f"{fd:.6f} (|z|={z:.2f})")

    # CVA (K5): finite differences of the closed form.
    cva_fields = ("cva", "credit_delta", "delta", "vega", "gamma",
                  "credit_gamma", "cross_gamma")
    for n_grid in (50, 500):
        def cf(lam=0.03, s=100.0, v=0.2):
            return float(mcmath.cva_closed_form(lam, 0.6, s, 100.0, 0.05, v,
                                                1.0, n_grid))

        h, hs, hl = 1e-4, 1e-2, 1e-3
        want = {
            "cva": cf(),
            "credit_delta": (cf(lam=0.03 + h) - cf(lam=0.03 - h)) / (2 * h),
            "delta": (cf(s=100 + 1e-2) - cf(s=100 - 1e-2)) / 2e-2,
            "vega": (cf(v=0.2 + h) - cf(v=0.2 - h)) / (2 * h),
            "gamma": (cf(s=100 + hs) - 2 * cf() + cf(s=100 - hs)) / hs ** 2,
            "credit_gamma": (cf(lam=0.03 + hl) - 2 * cf()
                             + cf(lam=0.03 - hl)) / hl ** 2,
            "cross_gamma": (cf(lam=0.03 + hl, s=100 + hs)
                            - cf(lam=0.03 + hl, s=100 - hs)
                            - cf(lam=0.03 - hl, s=100 + hs)
                            + cf(lam=0.03 - hl, s=100 - hs)) / (4 * hs * hl),
        }
        spec = CvaSpec(0.03, 0.6, VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0),
                       n_grid)
        g = mt.greeks(spec, 1 << 20, SEED)
        zs = {f: within_sigma(getattr(g, f).price, want[f],
                              getattr(g, f).std_error, f"CVA-{n_grid} {f}")
              for f in cva_fields}
        # The Greeks walk adds the drift to the log-spot apart from the
        # diffusion (mctpu's expression order): a constant add rounds the
        # same way on every path, up to half an ulp of log s ~ 4.6 per step
        # (2.4e-7), times an elasticity of the CVA to the spot below 6.
        p = float(mt.price_cva(spec, 1 << 20, SEED).cva)
        crn_rtol = 6 * 2.4e-7 * n_grid
        check(abs(float(g.cva.price) - p) <= crn_rtol * abs(p),
              f"CVA-{n_grid}: Greeks cva {float(g.cva.price):.7f} vs "
              f"price_cva {p:.7f} (rtol {crn_rtol:.1e})")
        phase("greeks-path", f"CVA n_grid={n_grid} 2^20 (K5): z "
              + ", ".join(f"{f}={z:.2f}" for f, z in zs.items())
              + f"; cva {float(g.cva.price):.6f} vs price_cva {p:.6f}, rel "
              f"{abs(float(g.cva.price) / p - 1):.1e}")

    # CVA under wrong-way risk: CRN bumps of price_cva_portfolio.
    port = CvaPortfolioSpec.from_single(
        CvaSpec(0.03, 0.6, VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0), 50),
        wwr_b=0.5)
    g = mt.greeks(port, 1 << 20, SEED)

    def crn(**bump):
        pb = dataclasses.replace(port, **bump)
        return float(mt.price_cva_portfolio(pb, 1 << 20, SEED).cva)

    h = 1e-3
    fd = {"cva": crn(),
          "credit_delta": (crn(intensity=0.03 + h) - crn(intensity=0.03 - h))
          / (2 * h),
          "delta": (crn(s=100 * (1 + h)) - crn(s=100 * (1 - h)))
          / (2 * 100 * h),
          "vega": (crn(v=0.2 + h) - crn(v=0.2 - h)) / (2 * h)}
    zs = {f: crn_gate(getattr(g, f).price, getattr(g, f).std_error, want,
                      f"CVA WWR {f}") for f, want in fd.items()}
    phase("greeks-path", "CVA WWR b=0.5 n_grid=50 2^20 (K5) vs CRN bumps: "
          + ", ".join(f"{f} |z|={z:.2f}" for f, z in zs.items()))


def main() -> int:

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
    from mctpu_torch.kernels import greeks as kgreeks
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

    def contract(label, fn, plain, units=None, rtol=RTOL):
        """``units`` per block given: the Greek partials' scaled bound."""
        outs = [fn(0, nb), fn(0, nb), fn(2, nb - 2), plain(0, nb)]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        torch.cuda.synchronize()
        worst = 0.0
        for got, again, tail, want in zip(*outs):
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
            check(torch.equal(got, again), f"{label}: launches differ")
            check(torch.equal(got[2:], tail), f"{label}: block offset")
            if units is None:
                close_rtol(got, want, label)
                rel = ((got.double() - want.double()).abs()
                       / want.double().abs().clamp(min=1e-30)).max()
                worst = max(worst, float(rel))
            else:
                worst = max(worst, close_pairs(got, want, units, rtol, label))
        what = "max rel err" if units is None else "max err / scaled bound"
        phase("kernel-vs-plain", f"{label}: ok, {what} {worst:.2e}")

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

    def units(plan):
        return plan.iters * plan.units_per_iter

    for label, kind, anti in (("K6 call", "call", False),
                              ("K6 put", "put", False),
                              ("K6 call antithetic", "call", True)):
        o = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
        par = kgreeks.params(o, dev)
        plan = kgreeks.make_plan(nb * iters * 2 * rows * 128, nb, rows, anti)
        put = kind == "put"
        contract(label,
                 lambda off, n: kgreeks.partials(par, SEED, off, plan, n, put),
                 lambda off, n: kgreeks.plain_partials(par, SEED, off, plan,
                                                       n, put),
                 units=units(plan))
    one = BasketOption(s=[100.0], v=[0.2], w=[1.0], corr=[[1.0]], d=[0.0],
                       k=100.0, r=0.048790, t=1.0)
    for label, bopt in (("K7 default_reference(3)",
                         BasketOption.default_reference(3)),
                        ("K7 equicorrelated(3)", BasketOption.equicorrelated(3)),
                        ("K7 a=1", one),
                        ("K8 default_reference(10)",
                         BasketOption.default_reference(10)),
                        ("K8 equicorrelated(16)",
                         BasketOption.equicorrelated(16)),
                        ("K8 equicorrelated(100)",
                         BasketOption.equicorrelated(100))):
        a = bopt.n_assets
        chol = mcmath.cholesky_lower(bopt.corr)
        tilt = kgreeks.tilt_direction(chol)[:2]
        plan = kbasket.make_plan(1, nb, rows, False, n_assets=a)
        plan = kbasket.make_plan(nb * iters * plan.paths_per_iter, nb, rows,
                                 False, n_assets=a)
        if kbasket.use_asset_major(a):
            ops = kgreeks.am_operands(bopt, chol, tilt, dev)
            fn, plain = kgreeks.am_partials, kgreeks.am_plain_partials
        else:
            ops = kgreeks.packed_operands(bopt, chol, tilt, dev)
            fn, plain = kgreeks.packed_partials, kgreeks.packed_plain_partials
        contract(label, lambda off, n: fn(ops, SEED, off, plan, n),
                 lambda off, n: plain(ops, SEED, off, plan, n),
                 units=units(plan))
    for label, port, anti in (
            ("K5 n_grid=50", CvaPortfolioSpec.from_single(spec50), False),
            ("K5 WWR b=0.5", CvaPortfolioSpec.from_single(spec50, wwr_b=0.5),
             False),
            ("K5 netted 2-option", CvaPortfolioSpec(
                0.03, 0.6, 100.0, 0.05, 0.2, 1.0, [95.0, 110.0], [1.0, -0.5],
                0.0, 50), False),
            ("K5 antithetic", CvaPortfolioSpec.from_single(spec50), True)):
        ops = kcva.greek_operands(port, dev)
        wwr = float(port.wwr_b) != 0.0
        plan = kcva.make_plan(nb * iters * rows * 128, nb, rows, anti)
        contract(label,
                 lambda off, n: kcva.greek_partials(ops, SEED, off, plan, n,
                                                    wwr),
                 lambda off, n: kcva.greek_plain_partials(ops, SEED, off,
                                                          plan, n, wwr),
                 units=units(plan), rtol=RTOL_WWR if wwr else RTOL)

    # ---- 4a. the pricing path at real size ------------------------------
    counters = (kvanilla.LAUNCHES, kbasket.LAUNCHES, kcva.LAUNCHES,
                kgreeks.LAUNCHES)

    def reset_counts():
        for c in counters:
            for k in c:
                c[k] = 0

    def read_counts(names):
        return {k: v for c in counters for k, v in c.items() if k in names}

    reset_counts()
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
    launches = read_counts(PRICE_KERNELS)
    phase("main-path", f"done in {time.perf_counter() - t_main:.1f} s")

    # ---- 4b. the Greeks path at real size -------------------------------
    reset_counts()
    t_greeks = time.perf_counter()
    greeks_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(GREEK_KERNELS))
    phase("greeks-path", f"done in {time.perf_counter() - t_greeks:.1f} s")

    # ---- 5. launch counters ----------------------------------------------
    check(all(launches.get(k, 0) > 0 for k in PRICE_KERNELS + GREEK_KERNELS),
          f"a kernel of a main path never launched: {launches}")
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

    def greek_estimates(outs, plan, disc, fold=None):
        """Every output's mean (price and each Greek) the engine forms
        from these Greek partials; ``fold = (c, a_tile, a)`` folds K8's
        slot vectors onto the assets."""
        vals = []
        for out in outs:
            total = pairwise_tree_sum(out.double(), 0).cpu()
            if total.ndim == 2:  # K8 slot vectors (6, width)
                c, a_tile, a = fold
                total = pairwise_tree_sum(total.reshape(6, c, a_tile), 1)
                total = total[:, :a]
            vals.append((disc * total[0::2] / plan.total_units).reshape(-1))
        return torch.cat(vals)

    def timed(kname, source, replaces, plan, steps, disc, kernel, plain,
              units=None, fold=None, plain_reps=5, rtol=RTOL):
        """``units`` per block given: Greek partials (scaled pair bound,
        every output's estimate in max_abs_err)."""
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if units is None:
                close_rtol(g, w, kname)
            else:
                close_pairs(g, w, units, rtol, kname)
        # max_abs_err: kernel vs plain in the estimates, in price units.
        if units is None:
            err = float((estimates(got, plan, disc)
                         - estimates(want, plan, disc)).abs().max())
        else:
            err = float((greek_estimates(got, plan, disc, fold)
                         - greek_estimates(want, plan, disc, fold))
                        .abs().max())
        ms, plain_ms = median_ms(kernel), median_ms(plain, plain_reps)
        rate = plan.total_paths * steps / (ms * 1e-3)
        unit = "path-steps/s" if steps > 1 else "paths/s"
        phase("times", f"{kname}: kernel {ms:.3f} ms ({rate:.4g} {unit}), "
                       f"plain {plain_ms:.3f} ms (median of {plain_reps}), "
                       f"{plan.num_blocks} blocks x {plan.iters} iters x rows "
                       f"{plan.rows}; max_abs_err {err:.3e}; [{smi}]")
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

    def gunits(plan):
        return plan.iters * plan.units_per_iter

    plan, par = engine.greeks_vanilla_setup(opt, n_van, cfg)
    timed("greeks_vanilla", "mctpu_torch/csrc/greeks.cu",
          "mctpu/kernels/greeks.py:189", plan, 1, math.exp(-opt.r * opt.t),
          lambda: kgreeks.partials(par, SEED, 0, plan, plan.num_blocks,
                                   False),
          lambda: kgreeks.plain_partials(par, SEED, 0, plan, plan.num_blocks,
                                         False),
          units=gunits(plan), plain_reps=3)
    for kname, label, replaces in (
            ("greeks_basket_am", "K2", "mctpu/kernels/greeks.py:448"),
            ("greeks_basket_packed", "K3", "mctpu/kernels/greeks.py:673")):
        bopt, n = basket_cells[label]
        plan, ops, _ = engine.greeks_basket_setup(bopt, n, cfg)
        a = bopt.n_assets
        a_tile, c, _ = kbasket.pack_factor(a)
        if kbasket.use_asset_major(a):
            fn, plain = kgreeks.am_partials, kgreeks.am_plain_partials
        else:
            fn, plain = kgreeks.packed_partials, kgreeks.packed_plain_partials
        timed(kname, "mctpu_torch/csrc/greeks.cu", replaces, plan, 1,
              math.exp(-bopt.r * bopt.t),
              lambda: fn(ops, SEED, 0, plan, plan.num_blocks),
              lambda: plain(ops, SEED, 0, plan, plan.num_blocks),
              units=gunits(plan), fold=(c, a_tile, a), plain_reps=3)
    plan, ops = engine.greeks_cva_setup(port, 1 << 20, cfg)
    timed("cva_greeks", "mctpu_torch/csrc/cva_greeks.cu",
          "mctpu/kernels/cva.py:742", plan, 500, 1.0,
          lambda: kcva.greek_partials(ops, SEED, 0, plan, plan.num_blocks,
                                      False),
          lambda: kcva.greek_plain_partials(ops, SEED, 0, plan,
                                            plan.num_blocks, False),
          units=gunits(plan), plain_reps=3)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
