#!/usr/bin/env python3
"""Time the port's entry points per call on one GPU: wall, device and kernel.

Run from the repository root on a machine with a CUDA device and ``nvcc``:

    python3 tools/profile_calls.py [--root DIR] [label-substring ...]

(with substrings, only the calls whose label holds one of them; with
``--root``, another checkout's ``mctpu_torch`` runs these calls, an
earlier version say, and its kernel ms counts every kernel of the call
but PyTorch's own, since its kernels may bear other names).

For each call at the main-path shapes that ``chip_smoke.py`` drives (the
default ``EngineConfig``), after one warm-up call:

* wall ms — median of 7 calls, host clock around the call and a
  ``torch.cuda.synchronize()``;
* device ms — sum of the durations of every device-side event
  (kernels, copies, fills) that ``torch.profiler`` records in one call;
* kernel ms — the same for the call's own CUDA kernels alone (both
  launches of a control-variate call, K48's split kernel and fold in
  each; an MLMC call's level-0 kernel and its level kernel; an RQMC
  call's net kernel and its chunk carry; the
  runtime-m xVA's and xVA Greeks', the CVA's and the CVA Greeks' slice
  kernels and their folds; the netting-set CVA's, the xVA's and the xVA
  Greeks' split kernel and its fold at m <= 8; the packed basket price's
  and the packed basket Greeks' split kernels and their folds; the
  barrier walk's, the lookback's, the Asian Greeks', the Heston walk's,
  the Heston and Asian MLMC levels', the variance swap's, the Heston
  variance swap Greeks', the 3-asset basket walks' and the basket-barrier
  Greeks' split kernel and its fold (K12, K15, K10, K27, K29, K11, K19,
  K20's Heston leg, K30, K34); the RQMC basket's net kernel, tiled or
  not (K54); the RQMC
  Asian's split net, its fold and the chunk carry (K55); 0 for a
  call with no kernel of its own, the rule fit and the Heston American);
* busy — device ms over that call's wall ms;
* launches — the port's kernel launches in one call (every module's
  ``LAUNCHES`` counters).

Prints the card's name and power limit, one line per call, and a JSON
list of the rows last.  Imports neither jax nor mctpu.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 20240607
PROFILE_TRIES = 3  # profiles of one call before an empty trace is an error
ANY_PORT_KERNEL = "any kernel of the port"  # --root's kernel column


def calls(mt):
    """``(label, kernel, fn)``: each entry point at its main-path shape;
    ``kernel`` is the name of the CUDA kernel it launches (a tuple of
    names for a call that launches two)."""
    import numpy as np

    from mctpu_torch.types import (AmericanOption, AsianOption, BarrierBook,
                                   BarrierOption,
                                   BasketAsianOption, BasketBarrierOption,
                                   BasketOption, CliquetOption,
                                   CvaMultiSpec, CvaSpec, HestonOption,
                                   LookbackOption,
                                   RainbowOption, VanillaBook, VanillaOption,
                                   XvaSpec)

    van = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
    b3, b100 = (BasketOption.default_reference(3),
                BasketOption.equicorrelated(100))
    cva = {g: CvaSpec(0.03, 0.6, VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0),
                      g) for g in (50, 500)}
    ari = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=50)
    geo = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=50,
                      average="geometric")
    uo = BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, barrier=130.0, n_obs=50)
    lb = LookbackOption(100.0, 0.05, 0.2, 1.0, n_obs=50)
    cq = CliquetOption(100.0, 0.03, 0.2, 1.0, n_periods=12, cap=0.05,
                       floor=-0.02)
    n22, n24 = 1 << 22, 1 << 24
    ks = np.linspace(50.0, 150.0, 64)
    book = VanillaBook.serving(64)
    vs = VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    bbook = BarrierBook.serving(32)
    hopt = HestonOption(100.0, 100.0, 0.05, 1.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    hvs = HestonOption(100.0, 100.0, 0.03, 1.0, 0.09, 2.0, 0.04, 0.3, -0.6)
    ba3 = BasketAsianOption(b3, n_obs=50)
    bb3 = BasketBarrierOption(b3, 130.0, n_obs=50)
    ba16 = BasketAsianOption(BasketOption.equicorrelated(16), n_obs=50)
    bb16 = BasketBarrierOption(ba16.basket, 130.0, n_obs=50)
    eq3 = BasketOption.equicorrelated(3, 0.3)
    ga3 = BasketAsianOption(eq3, n_obs=16)
    gb3 = BasketBarrierOption(eq3, 130.0, n_obs=50)
    ga16 = BasketAsianOption(BasketOption.equicorrelated(16, 0.3), n_obs=12)

    gb16 = BasketBarrierOption(BasketOption.equicorrelated(16, 0.3), 130.0,
                               n_obs=50)

    def netting_set(m, n_grid, s=100.0, v=0.2, rho=0.5, r=0.05, w=None):
        corr = np.full((m, m), rho) + (1.0 - rho) * np.eye(m)
        return CvaMultiSpec(0.03, 0.6, np.broadcast_to(s, (m,)).copy(),
                            np.broadcast_to(v, (m,)).copy(), corr, r, 1.0,
                            np.full(m, 100.0),
                            np.full(m, 1.0 / m) if w is None else w, n_grid)

    # The JAX exotic CLI's netting set (--product cva-multi) at 3 and 16
    # underlyings; the JAX Greeks CLI's.
    cm3, cm16 = netting_set(3, 50), netting_set(16, 50)
    i3 = np.arange(3)
    cmg = netting_set(3, 12, s=100.0 * (1.0 - 0.05 * i3),
                      v=0.2 * (1.0 + 0.25 * i3), rho=0.3, r=0.04879,
                      w=np.ones(3))
    i16 = np.arange(16)
    cmg16 = netting_set(16, 12, s=100.0 * (1.0 - 0.05 * i16),
                        v=0.2 * (1.0 + 0.25 * i16), rho=0.3, r=0.04879,
                        w=np.ones(16))
    # The JAX CLIs' --product xva: the exotic CLI's netting set at 3 and 16
    # underlyings, the Greeks CLI's at 3 and 16, with own intensity 0.02,
    # own lgd 0.5 and funding spread 0.01.
    xva3, xva16, xvag, xvag16 = (XvaSpec(net, 0.02, 0.5, 0.01)
                                 for net in (cm3, cm16, cmg, cmg16))

    rainbow = RainbowOption.equicorrelated
    rb3 = rainbow([100.0] * 3, [0.2, 0.3, 0.2], 0.3, 100.0, 0.05)
    rb16 = rainbow([100.0] * 16, [0.25] * 16, 0.3, 110.0, 0.05)
    rbg = rainbow([100.0, 95.0, 90.0], [0.2, 0.25, 0.3], 0.5, 100.0, 0.04879)
    cv_van = VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    amer = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=50)
    amer_h = HestonOption(100.0, 100.0, 0.05, 1.0, 0.04, 1.5, 0.04, 0.5, -0.7)
    # The JAX exotic CLI's MLMC products at their defaults (eps = 0.02, the
    # up-and-out at H = 130 with max_levels = 8), on its 512 x 256 config
    # and on mctpu's MLMC default of 8 x 8.
    geo4 = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=4,
                       average="geometric")
    uo8 = BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, barrier=130.0,
                        n_obs=8)
    # The split walks' kernels (K10, K11, K12, K15, K19, K20's Heston leg,
    # K27, K29, K30, K34: a walk per path element, then the fold in the
    # unsplit order).
    split = ("walk_split_kernel", "walk_fold_kernel")
    mlmc_calls = []
    for tag, cfg in (("512 x 256", mt.EngineConfig()),
                     ("8 x 8", mt.EngineConfig(num_blocks=8, rows=8))):
        mlmc_calls += [
            (f"price_heston_mlmc eps=0.02, {tag}", split,
             lambda c=cfg: mt.mlmc.price_heston_mlmc(hopt, 0.02, SEED, c)),
            (f"price_asian_mlmc geometric eps=0.02, {tag}",
             ("asian_kernel",) + split,
             lambda c=cfg: mt.mlmc.price_asian_mlmc(geo4, 0.02, SEED, c)),
            (f"price_barrier_mlmc H=130 eps=0.02, {tag}",
             split + ("barrier_level_kernel",),
             lambda c=cfg: mt.mlmc.price_barrier_mlmc(uo8, 0.02, SEED, c,
                                                      max_levels=8))]
    # The JAX CLIs' RQMC calls at their defaults: the exotic CLI's
    # --product rqmc (n = 131072 a replicate, the Asian at max(n // 50,
    # 4096) points and 50 dates, arithmetic; the basket at --assets 3, and
    # the rqmc path's 100), the Greeks CLI's --rqmc (2^20 // 16 points); 16
    # replicates on 512 x 256; and the Asian at phase 6's shapes, 50 dates
    # arithmetic at 2^18 points a replicate and 252 geometric at 2^16.
    # Each call launches its net kernel (the Asian: its split net and
    # fold) and the chunk carry.
    rq = ("chunk_carry_kernel",)
    rq_asian = ("rqmc_asian_split_kernel", "rqmc_asian_fold_kernel") + rq
    rq_basket = ("rqmc_basket_tiled_kernel", "rqmc_basket_kernel") + rq
    geo252 = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=252,
                         average="geometric")
    rqmc_calls = [
        ("price_vanilla_rqmc n=131072 x 16", ("rqmc_vanilla_kernel",) + rq,
         lambda: mt.price_vanilla_rqmc(cv_van, 131072, SEED)),
        ("greeks_vanilla_rqmc 65536 x 16", ("rqmc_greeks_kernel",) + rq,
         lambda: mt.qmc_engine.greeks_vanilla_rqmc(van, 65536, SEED)),
        ("price_basket_rqmc a=3, n=131072 x 16", rq_basket,
         lambda: mt.price_basket_rqmc(eq3, 131072, SEED)),
        ("price_basket_rqmc a=100, n=131072 x 16", rq_basket,
         lambda: mt.price_basket_rqmc(BasketOption.equicorrelated(100, 0.3),
                                      131072, SEED)),
        ("price_asian_rqmc arithmetic, n_obs=50, 4096 x 16", rq_asian,
         lambda: mt.price_asian_rqmc(ari, 4096, SEED)),
        ("price_asian_rqmc arithmetic, n_obs=50, 2^18 x 16", rq_asian,
         lambda: mt.price_asian_rqmc(ari, 1 << 18, SEED)),
        ("price_asian_rqmc geometric, n_obs=252, 2^16 x 16", rq_asian,
         lambda: mt.price_asian_rqmc(geo252, 1 << 16, SEED)),
    ]
    return [
        ("price_vanilla 2^28", "vanilla_kernel",
         lambda: mt.price_vanilla(van, 1 << 28, SEED)),
        ("price_basket a=3, 2^24", "basket_am_kernel",
         lambda: mt.price_basket(b3, n24, SEED)),
        ("price_basket a=100, 2^22",
         ("basket_tiled_kernel", "basket_fold_kernel"),
         lambda: mt.price_basket(b100, n22, SEED)),
        ("price_cva n_grid=50, 2^20",
         ("cva_slice_kernel", "cva_fold_kernel"),
         lambda: mt.price_cva(cva[50], 1 << 20, SEED)),
        ("price_cva n_grid=500, 2^20",
         ("cva_slice_kernel", "cva_fold_kernel"),
         lambda: mt.price_cva(cva[500], 1 << 20, SEED)),
        ("greeks_vanilla 2^28", "greeks_vanilla_kernel",
         lambda: mt.greeks(van, 1 << 28, SEED)),
        ("greeks_basket a=3, 2^24", "greeks_am_kernel",
         lambda: mt.greeks(b3, n24, SEED)),
        ("greeks_basket a=100, 2^22",
         ("greeks_tiled_kernel", "greeks_packed_fold_kernel"),
         lambda: mt.greeks(b100, n22, SEED)),
        ("greeks_cva n_grid=50, 2^20",
         ("cva_greeks_slice_kernel", "cva_greeks_fold_kernel"),
         lambda: mt.greeks(cva[50], 1 << 20, SEED)),
        ("greeks_cva n_grid=500, 2^20",
         ("cva_greeks_slice_kernel", "cva_greeks_fold_kernel"),
         lambda: mt.greeks(cva[500], 1 << 20, SEED)),
        ("price_asian arithmetic, n_obs=50, 2^22", "asian_kernel",
         lambda: mt.price_asian(ari, n22, SEED)),
        ("price_asian geometric, n_obs=50, 2^22", "asian_kernel",
         lambda: mt.price_asian(geo, n22, SEED)),
        ("greeks_asian arithmetic, 2^22", split,
         lambda: mt.greeks(ari, n22, SEED)),
        ("price_barrier up-and-out, 2^22", split,
         lambda: mt.price_barrier(uo, n22, SEED)),
        ("greeks_barrier up-and-out, 2^22", "barrier_greeks_kernel",
         lambda: mt.greeks(uo, n22, SEED)),
        ("price_lookback floating call, n_obs=50, 2^22", split,
         lambda: mt.price_lookback(lb, n22, SEED)),
        ("greeks_lookback floating call, 2^22", "lookback_greeks_kernel",
         lambda: mt.greeks(lb, n22, SEED)),
        ("price_cliquet n=12, 2^24", "cliquet_kernel",
         lambda: mt.price_cliquet(cq, n24, SEED)),
        ("greeks_cliquet n=12, 2^24", "cliquet_greeks_kernel",
         lambda: mt.greeks(cq, n24, SEED)),
        ("price_vanilla_ladder 64 strikes, 2^24", "ladder_kernel",
         lambda: mt.price_vanilla_ladder(van, ks, n24, SEED)),
        ("greeks_vanilla_ladder 64 strikes, 2^24", "ladder_greeks_kernel",
         lambda: mt.greeks_vanilla_ladder(van, ks, n24, SEED)),
        ("price_book 64 instruments, 2^24", "book_kernel",
         lambda: mt.price_book(book, n24, SEED)),
        ("greeks_book 64 instruments, 2^24", "book_greeks_kernel",
         lambda: mt.greeks_book(book, n24, SEED)),
        ("fair_variance_strike n_obs=252, 2^22", split,
         lambda: mt.fair_variance_strike(vs, n22, SEED, n_obs=252)),
        ("greeks_varswap n_obs=252, 2^22", "varswap_greeks_kernel",
         lambda: mt.greeks_varswap(vs, n22, SEED, n_obs=252)),
        ("price_barrier_book 32 instruments, n_obs=50, 2^22", "bb_kernel",
         lambda: mt.price_barrier_book(bbook, n22, SEED)),
        ("greeks_barrier_book 32 instruments, 2^22", "bb_greeks_kernel",
         lambda: mt.greeks_barrier_book(bbook, n22, SEED)),
        ("price_heston Euler, n_steps=100, 2^22", split,
         lambda: mt.price_heston(hopt, n22, SEED)),
        ("price_heston QE, n_steps=100, 2^22", split,
         lambda: mt.price_heston(hopt, n22, SEED, scheme="qe")),
        ("greeks_heston n_steps=100, 2^22", "heston_greeks_kernel",
         lambda: mt.greeks_heston(hopt, n22, SEED)),
        ("fair_variance_strike Heston, n_obs=252, 2^22", split,
         lambda: mt.fair_variance_strike(hvs, n22, SEED, n_obs=252)),
        ("greeks_varswap Heston, n_obs=252, 2^22", split,
         lambda: mt.greeks_varswap(hvs, n22, SEED, n_obs=252)),
        ("price_basket_asian a=3, n_obs=50, 2^22", split,
         lambda: mt.price_basket_asian(ba3, n22, SEED)),
        ("price_basket_barrier a=3 up-and-out, n_obs=50, 2^22", split,
         lambda: mt.price_basket_barrier(bb3, n22, SEED)),
        ("price_basket_asian a=16, n_obs=50, 2^22", "mw_walk_reg_kernel",
         lambda: mt.price_basket_asian(ba16, n22, SEED)),
        ("price_basket_barrier a=16 up-and-out, n_obs=50, 2^22",
         "mw_walk_reg_kernel",
         lambda: mt.price_basket_barrier(bb16, n22, SEED)),
        ("greeks_basket_asian a=3, n_obs=16, 2^24", "mw_greeks_am_kernel",
         lambda: mt.greeks(ga3, n24, SEED)),
        ("greeks_basket_barrier a=3, n_obs=50, 2^23", split,
         lambda: mt.greeks(gb3, 1 << 23, SEED)),
        ("greeks_basket_asian a=16, n_obs=12, 2^22",
         "mw_greeks_reg_kernel", lambda: mt.greeks(ga16, n22, SEED)),
        ("price_rainbow max of 3, 2^24", "rainbow_am_kernel",
         lambda: mt.price_rainbow(rb3, n24, SEED)),
        ("price_rainbow max of 16, 2^22", "rainbow_packed_kernel",
         lambda: mt.price_rainbow(rb16, n22, SEED)),
        ("greeks_rainbow max of 3, 2^24", "rainbow_greeks_kernel",
         lambda: mt.greeks(rbg, n24, SEED)),
        ("greeks_basket_barrier a=16, n_obs=50, 2^22",
         "mw_bar_greeks_reg_kernel", lambda: mt.greeks(gb16, n22, SEED)),
        ("price_cva_multi m=3, n_grid=50, 2^20",
         ("am_split_kernel", "am_fold_kernel"),
         lambda: mt.price_cva_multi(cm3, 1 << 20, SEED)),
        ("price_cva_multi m=16, n_grid=50, 2^20", "cva_multi_reg_kernel",
         lambda: mt.price_cva_multi(cm16, 1 << 20, SEED)),
        ("greeks_cva_multi m=3, n_grid=12, 2^20",
         "cva_multi_greeks_am_kernel",
         lambda: mt.greeks(cmg, 1 << 20, SEED)),
        ("greeks_cva_multi m=16, n_grid=12, 2^20",
         "cva_multi_greeks_reg_kernel",
         lambda: mt.greeks(cmg16, 1 << 20, SEED)),
        ("price_xva m=3, n_grid=50, 2^20",
         ("am_split_kernel", "am_fold_kernel"),
         lambda: mt.price_xva(xva3, 1 << 20, SEED)),
        ("price_xva m=16, n_grid=50, 2^20",
         ("xva_slice_kernel", "xva_fold_kernel"),
         lambda: mt.price_xva(xva16, 1 << 20, SEED)),
        ("greeks_xva m=3, n_grid=12, 2^20",
         ("am_split_kernel", "am_fold_kernel"),
         lambda: mt.greeks_xva(xvag, 1 << 20, SEED)),
        ("greeks_xva m=16, n_grid=12, 2^20",
         ("xva_greek_slice_kernel", "xva_greek_fold_kernel"),
         lambda: mt.greeks_xva(xvag16, 1 << 20, SEED)),
        # The control variates at the JAX exotic CLI's --product cv shapes:
        # two launches a call (the pilot's 8 blocks, then the main run).
        ("price_vanilla_cv 2^28", "vanilla_cv_kernel",
         lambda: mt.variance.price_vanilla_cv(cv_van, 1 << 28, SEED)),
        ("price_asian_cv n_obs=50, 2^22", "asian_cv_kernel",
         lambda: mt.variance.price_asian_cv(ari, n22, SEED)),
        ("price_basket_cv a=3, 2^24", "basket_cv_am_kernel",
         lambda: mt.variance.price_basket_cv(eq3, n24, SEED)),
        ("price_basket_cv a=100, 2^22",
         ("basket_cv_tiled_kernel", "basket_cv_fold_kernel"),
         lambda: mt.variance.price_basket_cv(
             BasketOption.equicorrelated(100, 0.3), n22, SEED)),
        # The American path at the JAX CLIs' shapes: the exotic CLI's
        # importance-sampled call (K = 200) and American put (50 dates), its
        # rule fit alone (2^15 pilot paths), the dual bracket, the Heston
        # American (plain torch, no kernel of its own), the Greeks CLI's
        # American put (12 dates).
        ("price_vanilla_is K=200, 2^28", "vanilla_is_kernel",
         lambda: mt.variance.price_vanilla_is(
             VanillaOption(100.0, 200.0, 0.05, 0.2, 1.0), 1 << 28, SEED)),
        ("fit_exercise_rule put n_steps=50, 2^15 pilot", None,
         lambda: mt.lsm.fit_exercise_rule(100.0, 100.0, 0.05, 0.2, 1.0, SEED,
                                          1 << 15, 50, "put")),
        ("price_american put n_steps=50, 2^22", "lsm_kernel",
         lambda: mt.price_american(amer, n22, SEED,
                                   config=mt.EngineConfig())),
        ("price_american_bounds put n_steps=50, 2^16, n_sub=64",
         "lsm_kernel",
         lambda: mt.price_american_bounds(amer, 1 << 16, SEED,
                                          config=mt.EngineConfig())),
        ("price_american_heston QE n_steps=50, 2^17", None,
         lambda: mt.price_american_heston(amer_h, 1 << 17, SEED)),
        ("greeks_american put n_steps=12, 2^20", "lsm_kernel",
         lambda: mt.greeks_american(
             AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=12),
             1 << 20, SEED)),
    ] + mlmc_calls + rqmc_calls


def is_kernel(name: str, kernel) -> bool:
    """``name`` (demangled or mangled) is the kernel ``kernel`` itself (or
    one of a tuple of kernels), not one whose name ends in it; no name for
    a call without a kernel."""
    if kernel is None:
        return False
    if kernel == ANY_PORT_KERNEL:
        return not (name.startswith(("Memcpy", "Memset")) or "at::" in name)
    if isinstance(kernel, tuple):
        return any(is_kernel(name, k) for k in kernel)
    return any(mark in name for mark in (
        f"::{kernel}<", f"::{kernel}(", f"{len(kernel)}{kernel}I",
        f"{len(kernel)}{kernel}E"))


def launch_count() -> int:
    """Every kernel launch the port's wrappers have counted so far (the
    ``LAUNCHES`` of each ``mctpu_torch.kernels`` module, all imported with
    the package)."""
    return sum(sum(getattr(mod, "LAUNCHES", {}).values())
               for name, mod in list(sys.modules.items())
               if name.startswith("mctpu_torch.kernels."))


def profile(fn, kernel):
    """``(device ms, kernel ms)`` of one call under torch.profiler.  Now and
    then the profiler keeps none of a call's device events; such a call is
    profiled again, up to PROFILE_TRIES times in all.  ``kernel=None``
    (a call with no kernel of its own) needs device events only."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.time_range.elapsed_us() for e in dev)
        kernel_us = sum(e.time_range.elapsed_us() for e in dev
                        if is_kernel(e.name, kernel))
        if kernel_us > 0 or (kernel is None and device_us > 0):
            return device_us / 1e3, kernel_us / 1e3
    raise RuntimeError(f"the profiler saw no {kernel} launch in "
                       f"{PROFILE_TRIES} "
                       f"tries; device events: "
                       f"{sorted({e.name for e in dev})[:8]}")


def wall_ms(fn, reps: int = 7) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=None)
    ap.add_argument("labels", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_calls: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str((args.root or ROOT).resolve()))
    import mctpu_torch as mt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    wanted = args.labels
    for label, kernel, fn in calls(mt):
        if wanted and not any(w in label for w in wanted):
            continue
        if args.root is not None and kernel is not None:
            kernel = ANY_PORT_KERNEL
        before = launch_count()
        fn()  # warm-up: builds the kernels on the first call
        launches = launch_count() - before
        wall = wall_ms(fn)
        device, kern = profile(fn, kernel)
        rows.append({"call": label, "kernel": kernel, "wall_ms": wall,
                     "device_ms": device, "kernel_ms": kern,
                     "busy": device / wall, "launches": launches,
                     "root": str(args.root or ROOT), "card": smi})
        print(f"{label}: wall {wall:.3f} ms, device {device:.3f} ms, "
              f"kernel {kern:.3f} ms, busy {device / wall:.0%}, "
              f"{launches} launches", flush=True)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
