#!/usr/bin/env python3
"""Time the redesigned kernels -- K30 (the asset-major basket walk), K12
(the barrier walk), K8 (the packed basket Greeks), K43 (the
netting-set xVA), K48 (the packed basket control variate), K3 (the
packed basket price), K33 (the packed basket-Asian Greeks), K39 (the
packed netting-set CVA), K35 (the packed basket-barrier LR Greeks), K4
(the CVA exposure walk), K5 (its Greeks), K31 (the packed multi-asset
walk), K40 (the netting-set CVA), K43's runtime-m xVA kernel, K29 (the
Heston MLMC level), K44 (the xVA Greeks), K10 (the Asian Greeks walk),
K27 (the Heston walk), K11 (the Asian MLMC level), K41 (the packed
netting-set CVA Greeks), K19 (the variance swap, both legs), K55 (the
RQMC Asian), K15 (the lookback), K54 (the RQMC basket), K20's Heston leg
(the variance swap's Greeks) and K34 (the basket-barrier LR Greeks) --
at ``chip_smoke.py``'s
phase 6 shapes on one GPU, against another checkout in the same process.

Run from the repository root on a machine with a CUDA device and ``nvcc``:

    python3 tools/time_redesign.py [--root DIR] [--reps 7] [--only TEXT ...]

``--root`` names another checkout (an unpacked earlier version, say):
its ``mctpu_torch`` is imported beside this one's, both libraries are
built (in parallel), and every case runs the two in turns, P V V P (P
the other checkout, V this one), so that both are timed in one process
on one card. Without ``--root`` only this checkout runs; ``--only``
(repeatable) keeps the cases whose name contains one of its texts. The
cases, on the default ``EngineConfig``'s layout: K30 on the JAX exotic
CLI's basket (``default_reference(3)``) at 50 dates and 2^22 paths, the
Asian, the up-and-out at H = 130 and the down-and-out at H = 90, the Asian
and the up-and-out antithetic, the up-and-out with its scratch capped at
2^20 floats, and the Asian and the up-and-out on ``equicorrelated(8,
0.3)``; K12 on the exotic path's up-and-out call (S = K = 100, r = 0.05, v
= 0.2, T = 1, H = 130, 50 dates, 2^22 paths), the down-and-out at H = 80,
the up-and-out antithetic and with its scratch capped at 2^20 floats (a
version without the cap runs whole), and the up-and-out at 8 dates and
2^20 paths on the MLMC level plan of ``mctpu``'s 8 x 8 MLMC default
(``mlmc._level_plan``), plain and antithetic; K8 on
``equicorrelated(100)`` at 2^22 paths, plain and antithetic, and on
``equicorrelated(16)``; K43 on the JAX exotic CLI's ``--product xva``
set (its ``--product cva-multi`` set, own intensity 0.02, own lgd 0.5,
funding spread 0.01) at 3 underlyings, plain and antithetic, and at 8,
50 nodes, 2^20 paths; K48 on ``equicorrelated(100, 0.3)`` at 2^22 paths,
its main run (512 x 16 x 256) and its pilot's plan (8 x 102 x 256),
plain and antithetic, and the main run at 32 assets; K3 on
``equicorrelated(100)`` at 2^22, plain and antithetic, and on
``equicorrelated(16)``; K33 on ``equicorrelated(16, 0.3)`` at 12 dates
(the JAX Greeks CLI's ``--assets 16``) and 2^22 paths, plain and
antithetic, and at 32 assets; K39 on the JAX exotic CLI's ``--product
cva-multi`` set at ``--assets 16``, plain and antithetic, and at 32, 50
nodes, 2^20 paths; K35 on ``equicorrelated(16, 0.3)``, up-and-out at H =
130, 50 dates, 2^22 paths, plain and antithetic, and at 32 (2^22) and
100 assets (2^20); K4 on the call CVA (S = K = 100, r = 0.05, v = 0.2, T
= 1, lambda 0.03, lgd 0.6, F32_KAHAN) at 500 and 50 nodes, at 500 under
wrong-way risk b = 0.8 and under F32_DS, 2^20 paths; K5 on the same CVA
at 500 and 50 nodes, at 500 under wrong-way risk b = 0.5 and antithetic,
2^20 paths; K31 on ``equicorrelated(16)`` at 50 dates and 2^22 paths,
the arithmetic Asian and the up-and-out at H = 130, and the Asian at 32
assets (2^22) and at 100 (2^20); K40 on the JAX exotic CLI's ``--product
cva-multi`` set at 3 underlyings, plain and antithetic, and at 8, 50
nodes, 2^20 paths; K43's runtime-m kernel on the JAX exotic CLI's
``--product xva`` set at 16 underlyings, 50 nodes, 2^20 paths; K29 on the
JAX exotic CLI's ``--product mlmc`` option at level 4 (128 fine steps),
2^22 paths on the default level plan and 2^20 on the level plan of
``mctpu``'s 8 x 8 MLMC default, plain and antithetic; K44 on the JAX
Greeks CLI's ``--product xva`` set, 12 nodes, 2^20 paths, its ``am``
kernel at 3 underlyings and its runtime-m kernel at 16, and on the
exotic CLI's set with the same bank side at 32, plain and antithetic;
K10 (the Asian Greeks) on the exotic path's arithmetic Asian call at 50
dates, 2^22 paths, F32_KAHAN and F32, geometric, antithetic, and 2^20 on
the 8 x 8 MLMC level plan, plain and antithetic; K27 (the Heston walk) on
K29's option at 100 steps, 2^22 paths, Euler (F32_KAHAN and F32) and QE,
each antithetic, and Euler at 8 steps (level 0 of the 8 x 8 MLMC
default), 2^20 on its level plan, plain and antithetic; K11 (the Asian
MLMC level) on the JAX exotic CLI's ``--product mlmc-asian`` option at
level 4 of n0 = 4 (64 dates), 2^22 paths on the default level plan,
arithmetic (F32_KAHAN and F32) and geometric, each antithetic, and 2^20
on the level plan of the 8 x 8 MLMC default, arithmetic plain and
antithetic and geometric; K41 (the packed netting-set CVA Greeks) on the
JAX Greeks CLI's ``--product cva-multi`` set at ``--assets 16`` and on
the exotic CLI's set at 32, 12 nodes, 2^20 paths, plain and antithetic;
K19 on phase 6's variance swaps at 252 dates and 2^22 paths, the Heston
leg plain and antithetic, F32_KAHAN and F32, and with its scratch capped
at 2^20 floats, the GBM leg plain and antithetic; K55 on phase 6's RQMC
Asians, 16 replicates: 50 dates arithmetic at 2^18 points (16 x 13 x
163), also with its scratch capped at 2^20 floats, 252 geometric at 2^16
(16 x 16 x 32), 12 dates at 2^18 and 300 at 2^16; and the bit-equality
sweeps ``K55 bits`` (1, 3, 6, 7, 12, 13, 50, 64, 65, 252, 255, 300 and
2048 dates, both averages, 3 chunks of rows 8, 24, 32 or 163; capped at
1 float and at half at 50 and 252) and ``K19 bits`` (13 and 252 dates,
64 x 2 x 32, both legs, plain and antithetic, F32_KAHAN and F32; the
Heston leg at 252 capped at 1 float and at half); K20's Heston leg on
phase 6's Heston variance swap at 252 dates, 2^22 paths, plain and
antithetic, F32_KAHAN and F32, and scratch capped at 2^20 floats; K34 on
``equicorrelated(a, 0.3)`` at 50 dates: a = 3 at 2^23 paths up-and-out
at H = 130 plain, antithetic and F32, down-and-out at H = 90 plain and
antithetic, scratch capped; a = 1 and 8 plain and antithetic, 4 and 5
antithetic, 6 plain and antithetic at 2^22; and the sweeps ``K34 bits``
(1-8 assets, 1, 13 and 50 dates, up and down, plain and antithetic,
F32_KAHAN and F32, 64 x 2 x 32; capped at 1 float and at half at 3 and 8
assets) and ``K20H bits`` (1, 13 and 252 dates, likewise; capped at 252).
Each time
is the median of ``--reps`` launches timed by CUDA events after one
warm-up launch (the event time holds the host's time before a call's
first launch; the host's time in the call, its launches enqueued, is
printed beside it). K30's and K12's (their block sums), K8's (its six sums
and (6, width) slot vectors), K43's
(its eight sums and both profiles), K48's (its five moment sums), K3's,
K33's (its four sums and (4, width) lane rows), K39's, K35's, K31's and
K40's outputs (K39's and K40's sums and EE
profile), K29's, K44's ``am``, K10's, K27's, K11's, K41's (its four
sums and (4, width) lane rows), K19's, K55's (its quads), K15's, K54's,
K20's and K34's (its four sums and (4, a) asset rows) outputs must
equal the other
checkout's bit for bit (same walk, passes and order of sums), and K44's
runtime-m (sum, sum^2) pairs must agree with it by ``chip_smoke.py``'s
scaled pair bound at rtol 2e-5 (its slices reorder the block sums); each
such case prints the comparison and the tool exits 1 if one differs.
Prints the card's name and power limit, one line per case and version,
and a JSON line of them last.
Imports neither jax nor mctpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import inspect
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 20240607
MODULES = ("mctpu_torch._build", "mctpu_torch.engine",
           "mctpu_torch.kernels.multi_walk", "mctpu_torch.kernels.cva_multi",
           "mctpu_torch.kernels.cva", "mctpu_torch.types",
           "mctpu_torch.variance", "mctpu_torch.kernels.varred",
           "mctpu_torch.kernels.basket", "mctpu_torch.kernels.greeks",
           "mctpu_torch.kernels.barrier", "mctpu_torch.mlmc",
           "mctpu_torch.kernels.heston", "mctpu_torch.kernels.asian",
           "mctpu_torch.kernels.varswap", "mctpu_torch.kernels.rqmc",
           "mctpu_torch.qmc_engine", "mctpu_torch.kernels.lookback",
           "mctpu_torch.math")
# The kernel-vs-kernel tolerance of the cases whose outputs may move in the
# last bits (chip_smoke.py's RTOL), by the Greek pairs' scaled bound.
RTOL = 2e-5


def _drop_port_modules() -> None:
    for name in [k for k in sys.modules
                 if k == "mctpu_torch" or k.startswith("mctpu_torch.")]:
        del sys.modules[name]


def load(root: Path) -> SimpleNamespace:
    """``root``'s ``mctpu_torch`` modules, imported afresh and then taken
    out of ``sys.modules``, so that another checkout's load next to it
    imports its own (the modules bind their imports at import time)."""
    _drop_port_modules()
    sys.path.insert(0, str(root))
    try:
        mods = [importlib.import_module(name) for name in MODULES]
    finally:
        sys.path.remove(str(root))
        _drop_port_modules()
    (build, engine, kmw, kcm, kcva, types, variance, kvr, kbasket,
     kgreeks, kbarrier, mlmc, kheston, kasian, kvarswap, krqmc,
     qmc_engine, klookback, mcmath) = mods
    return SimpleNamespace(root=root, build=build, engine=engine, kmw=kmw,
                           kcm=kcm, kcva=kcva, types=types, variance=variance,
                           kvr=kvr, kbasket=kbasket, kgreeks=kgreeks,
                           kbarrier=kbarrier, mlmc=mlmc, kheston=kheston,
                           kasian=kasian, kvarswap=kvarswap, krqmc=krqmc,
                           qmc_engine=qmc_engine, klookback=klookback,
                           mcmath=mcmath)


def kernel_ms(fn, reps: int):
    """``(event ms, host ms)``: medians over ``reps`` calls after a warm-up
    of the CUDA-event time of a call and of the host's time in it (its
    launches enqueued, before the synchronize)."""
    fn()
    times, host = [], []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        t = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t) * 1e3)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), statistics.median(host)


def netting_set(t, m: int, n_grid: int):
    """``chip_smoke.cva_multi_spec``: the JAX exotic CLI's ``--product
    cva-multi`` set of ``m`` calls (s = k = 100, v = 0.2, correlation 0.5,
    w = 1/m, lambda 0.03, lgd 0.6, r 0.05, T 1)."""
    corr = np.full((m, m), 0.5) + 0.5 * np.eye(m)
    full = np.full(m, 100.0)
    return t.CvaMultiSpec(0.03, 0.6, full, np.full(m, 0.2), corr, 0.05, 1.0,
                          full, np.full(m, 1.0 / m), n_grid)


def greeks_set(t, m: int):
    """``chip_smoke.xva_spec(cva_greeks_cli_spec(m))``: the JAX Greeks
    CLI's xVA set (``--product xva``) of ``m`` calls, correlation 0.3 + 0.7
    I, s = 100 (1 - 0.05 i), v = 0.2 (1 + 0.25 i), r = 0.04879, k = 100, w
    = 1, 12 nodes; own intensity 0.02, own lgd 0.5, funding spread 0.01."""
    i = np.arange(m)
    net = dataclasses.replace(
        netting_set(t, m, 12), s=100.0 * (1.0 - 0.05 * i),
        v=0.2 * (1.0 + 0.25 * i), r=0.04879,
        corr=np.full((m, m), 0.3) + 0.7 * np.eye(m), weights=np.ones(m))
    return t.XvaSpec(net, own_intensity=0.02, own_lgd=0.5,
                     funding_spread=0.01)


def greek_pairs(out):
    """K44's ``((B, 14), (B, 4, m))`` as ``(B, 14 + 4m)`` (sum, sum^2)
    pairs."""
    scal, vec = out
    return torch.cat([scal] + [vec[:, :, i] for i in range(vec.shape[2])],
                     1)


def cases(v: SimpleNamespace):
    """``[(name, launch, compare)]`` of one version, built from its own
    API; ``compare``: True, its outputs must equal the other version's bit
    for bit; a number, its (sum, sum^2) pairs must agree with the other's
    by the scaled bound at RTOL over that many units a block; False, no
    comparison."""
    t, engine, kmw, kcm, kcva = v.types, v.engine, v.kmw, v.kcm, v.kcva
    cfg = engine.EngineConfig()
    out = []
    # A case's "cap" runs this version's split walk with its scratch capped
    # at 2^20 floats (the blocks in groups); a version without the argument
    # runs whole.
    def cap_of(fn, capped):
        takes = "scratch_cap" in inspect.signature(fn).parameters
        return {"scratch_cap": 1 << 20} if capped and takes else {}

    for a, barrier, up, anti, capped in ((3, False, True, False, False),
                                         (3, True, True, False, False),
                                         (3, True, False, False, False),
                                         (3, False, True, True, False),
                                         (3, True, True, True, False),
                                         (3, True, True, False, True),
                                         (8, False, True, False, False),
                                         (8, True, True, False, False)):
        bk = (t.BasketOption.default_reference(3) if a == 3
              else t.BasketOption.equicorrelated(a, 0.3))
        c = dataclasses.replace(cfg, antithetic=anti)
        h = 130.0 if up else 90.0
        kind = "up-and-out" if up else "down-and-out"
        if barrier:
            opt = t.BasketBarrierOption(bk, h, n_obs=50, kind=kind)
            plan, ops = engine.basket_barrier_setup(opt, 1 << 22, c)
        else:
            plan, ops = engine.basket_asian_setup(
                t.BasketAsianOption(bk, n_obs=50), 1 << 22, c)
        product = "barrier" if barrier else "asian"
        name = (f"K30 {f'{kind} H={h:g}' if barrier else 'asian'} a={a} "
                f"50 dates 2^22{' antithetic' if anti else ''}"
                f"{' scratch cap 2^20' if capped else ''}")
        out.append((name, lambda o=ops, p=plan, pr=product, u=up,
                    kw=cap_of(kmw.partials, capped):
                    kmw.partials(*o, SEED, 0, p, p.num_blocks, pr, 50, u,
                                 **kw), True))
    mlmc_cfg = engine.EngineConfig(num_blocks=8, rows=8)
    for h, up, anti, n, n_obs, mlmc_plan, capped in (
            (130.0, True, False, 1 << 22, 50, False, False),
            (80.0, False, False, 1 << 22, 50, False, False),
            (130.0, True, True, 1 << 22, 50, False, False),
            (130.0, True, False, 1 << 22, 50, False, True),
            (130.0, True, False, 1 << 20, 8, True, False),
            (130.0, True, True, 1 << 20, 8, True, False)):
        opt = t.BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, h, n_obs=n_obs,
                              kind="up-and-out" if up else "down-and-out")
        c = dataclasses.replace(mlmc_cfg if mlmc_plan else cfg,
                                antithetic=anti)
        if mlmc_plan:
            plan = v.mlmc._level_plan(n, c)
            par = v.kbarrier.params(opt, c.torch_device())
        else:
            plan, par = engine.barrier_setup(opt, n, c)
        name = (f"K12 {'up' if up else 'down'}-and-out H={h:g} {n_obs} dates "
                f"2^{n.bit_length() - 1}"
                f"{' MLMC 8 x 8 plan ' if mlmc_plan else ' '}"
                f"{plan.num_blocks}x{plan.iters}x{plan.rows}"
                f"{' antithetic' if anti else ''}"
                f"{' scratch cap 2^20' if capped else ''}")
        out.append((name, lambda o=par, p=plan, nn=n_obs, u=up,
                    kw=cap_of(v.kbarrier.partials, capped):
                    v.kbarrier.partials(o, SEED, 0, p, p.num_blocks, nn, u,
                                        **kw), True))
    for a, anti in ((100, False), (100, True), (16, False)):
        plan, ops, _ = engine.greeks_basket_setup(
            t.BasketOption.equicorrelated(a), 1 << 22,
            dataclasses.replace(cfg, antithetic=anti))
        out.append((f"K8 a={a} 2^22{' antithetic' if anti else ''}",
                    lambda o=ops, p=plan: v.kgreeks.packed_partials(
                        o, SEED, 0, p, p.num_blocks), True))
    for m, anti in ((3, False), (3, True), (8, False)):
        xs = t.XvaSpec(netting_set(t, m, 50), own_intensity=0.02,
                       own_lgd=0.5, funding_spread=0.01)
        plan, ops = engine.price_xva_setup(
            xs, 1 << 20, dataclasses.replace(cfg, antithetic=anti))
        out.append((f"K43 am m={m} 50 nodes{' antithetic' if anti else ''} "
                    "2^20", lambda o=ops, p=plan: kcm.xva_partials(
                        o, SEED, 0, p, p.num_blocks), True))
    for a, anti, pilot in ((100, False, False), (100, True, False),
                           (100, False, True), (100, True, True),
                           (32, False, False)):
        cvs = v.variance.cv_setup(t.BasketOption.equicorrelated(a, 0.3),
                                  1 << 22,
                                  dataclasses.replace(cfg, antithetic=anti))
        plan = (v.variance._pilot_plan(cvs.plan, 0.1) if pilot
                else cvs.plan)
        ops = cvs.operands(v.kvr.center32(cvs.center))
        out.append((f"K48 a={a} {'pilot' if pilot else 'main'} "
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows} 2^22"
                    f"{' antithetic' if anti else ''}",
                    lambda s=cvs, o=ops, p=plan: s.partials(
                        o, SEED, 0, p, p.num_blocks), True))
    for a, anti in ((100, False), (100, True), (16, False)):
        plan, ops = engine.basket_setup(
            t.BasketOption.equicorrelated(a), 1 << 22,
            dataclasses.replace(cfg, antithetic=anti))
        out.append((f"K3 a={a} 2^22{' antithetic' if anti else ''}",
                    lambda o=ops, p=plan: v.kbasket.partials(
                        o, SEED, 0, p, p.num_blocks), True))
    for a, anti in ((16, False), (16, True), (32, False)):
        opt = t.BasketAsianOption(t.BasketOption.equicorrelated(a, 0.3),
                                  n_obs=12)
        plan, ops = engine.greeks_basket_asian_setup(
            opt, 1 << 22, dataclasses.replace(cfg, antithetic=anti))
        out.append((f"K33 a={a} 12 dates 2^22{' antithetic' if anti else ''}",
                    lambda o=ops, p=plan: kmw.am_greek_partials(
                        *o, SEED, 0, p, p.num_blocks, 12), True))
    for m, anti in ((16, False), (16, True), (32, False)):
        plan, ops = engine.price_cva_multi_setup(
            netting_set(t, m, 50), 1 << 20,
            dataclasses.replace(cfg, antithetic=anti))
        out.append((f"K39 m={m} 50 nodes{' antithetic' if anti else ''} 2^20",
                    lambda o=ops, p=plan: kcm.partials(
                        o, SEED, 0, p, p.num_blocks), True))
    for a, n, anti in ((16, 1 << 22, False), (16, 1 << 22, True),
                       (32, 1 << 22, False), (100, 1 << 20, False)):
        opt = t.BasketBarrierOption(t.BasketOption.equicorrelated(a, 0.3),
                                    130.0, n_obs=50)
        c = dataclasses.replace(cfg, antithetic=anti)
        plan, ops = engine.greeks_basket_barrier_setup(opt, n, c)
        out.append((f"K35 a={a} H=130 50 dates 2^{n.bit_length() - 1}"
                    f"{' antithetic' if anti else ''}",
                    lambda o=ops, p=plan: kmw.bar_greek_partials(
                        *o, SEED, 0, p, p.num_blocks, 50, True), True))
    port = t.CvaPortfolioSpec.from_single(
        t.CvaSpec(0.03, 0.6, t.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0),
                  500))
    for g, wwr_b, prec in ((500, 0.0, t.Precision.F32_KAHAN),
                           (50, 0.0, t.Precision.F32_KAHAN),
                           (500, 0.8, t.Precision.F32_KAHAN),
                           (500, 0.0, t.Precision.F32_DS)):
        pt = dataclasses.replace(port, n_grid=g, wwr_b=wwr_b)
        plan, ops = engine.cva_setup(
            pt, 1 << 20, dataclasses.replace(cfg, precision=prec))
        out.append((f"K4 n_grid={g} {prec.value}"
                    f"{f' WWR b={wwr_b:g}' if wwr_b else ''} 2^20",
                    lambda o=ops, p=plan, w=bool(wwr_b): kcva.partials(
                        o, SEED, 0, p, p.num_blocks, w), False))
    for g, wwr_b, anti in ((500, 0.0, False), (50, 0.0, False),
                           (500, 0.5, False), (500, 0.0, True)):
        pt = dataclasses.replace(port, n_grid=g, wwr_b=wwr_b)
        plan, ops = engine.greeks_cva_setup(
            pt, 1 << 20, dataclasses.replace(cfg, antithetic=anti))
        out.append((f"K5 n_grid={g}{f' WWR b={wwr_b:g}' if wwr_b else ''}"
                    f"{' antithetic' if anti else ''} 2^20",
                    lambda o=ops, p=plan, w=bool(wwr_b): kcva.greek_partials(
                        o, SEED, 0, p, p.num_blocks, w), False))
    for a, n, barrier in ((16, 1 << 22, False), (16, 1 << 22, True),
                          (32, 1 << 22, False), (100, 1 << 20, False)):
        bk = t.BasketOption.equicorrelated(a)
        if barrier:
            opt = t.BasketBarrierOption(bk, 130.0, n_obs=50)
            plan, ops = engine.basket_barrier_setup(opt, n, cfg)
        else:
            opt = t.BasketAsianOption(bk, n_obs=50)
            plan, ops = engine.basket_asian_setup(opt, n, cfg)
        product = "barrier" if barrier else "asian"
        name = (f"K31 {'knock-out H=130' if barrier else 'asian'} a={a} "
                f"50 dates 2^{n.bit_length() - 1}")
        out.append((name, lambda o=ops, p=plan, pr=product:
                    kmw.partials(*o, SEED, 0, p, p.num_blocks, pr, 50, True),
                    True))
    for m, anti in ((3, False), (3, True), (8, False)):
        plan, ops = engine.price_cva_multi_setup(
            netting_set(t, m, 50), 1 << 20,
            dataclasses.replace(cfg, antithetic=anti))
        out.append((f"K40 m={m} 50 nodes{' antithetic' if anti else ''} 2^20",
                    lambda o=ops, p=plan: kcm.partials(
                        o, SEED, 0, p, p.num_blocks), True))
    xs = t.XvaSpec(netting_set(t, 16, 50), own_intensity=0.02, own_lgd=0.5,
                   funding_spread=0.01)
    plan, ops = engine.price_xva_setup(xs, 1 << 20, cfg)
    out.append(("K43 runtime-m m=16 50 nodes 2^20",
                lambda o=ops, p=plan: kcm.xva_partials(
                    o, SEED, 0, p, p.num_blocks), False))
    # K29 on the JAX exotic CLI's --product mlmc option (S = K = 100, r =
    # 0.05, T = 1, v0 = theta = 0.04, kappa = 2, xi = 0.3, rho = -0.7) at
    # level 4 of n0 = 8 (128 fine steps), 2^22 paths on the level plan of
    # the default EngineConfig (phase 6's), plain and antithetic, and 2^20
    # on the level plan of mctpu's 8 x 8 MLMC default, plain and
    # antithetic.
    hopt = t.HestonOption(s=100.0, k=100.0, r=0.05, t=1.0, v0=0.04,
                          kappa=2.0, theta=0.04, xi=0.3, rho=-0.7)
    for n, mlmc_plan, anti in ((1 << 22, False, False),
                               (1 << 22, False, True),
                               (1 << 20, True, False),
                               (1 << 20, True, True)):
        c = dataclasses.replace(mlmc_cfg if mlmc_plan else cfg,
                                antithetic=anti)
        plan = v.mlmc._level_plan(n, c)
        lp = v.kheston.level_params(hopt, 128, c.torch_device())
        out.append((f"K29 level 4 (128 steps) 2^{n.bit_length() - 1}"
                    f"{' MLMC 8 x 8 plan ' if mlmc_plan else ' '}"
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows}"
                    f"{' antithetic' if anti else ''}",
                    lambda o=lp, p=plan: v.kheston.level_partials(
                        o, SEED, 0, p, p.num_blocks, 128), True))
    # K44 on the JAX Greeks CLI's xVA set, 12 nodes, 2^20 paths: its am
    # kernel at 3 underlyings (bit for bit), its runtime-m kernel at 16
    # (within RTOL: the slices reorder the block sums), plain and
    # antithetic; at 32 on the exotic CLI's set with the same bank side
    # (the Greeks CLI's spots 100 (1 - 0.05 i) turn negative past 20).
    for m, anti in ((3, False), (3, True), (16, False), (16, True),
                    (32, False), (32, True)):
        xs = (greeks_set(t, m) if m <= 16 else t.XvaSpec(
            netting_set(t, m, 12), own_intensity=0.02, own_lgd=0.5,
            funding_spread=0.01))
        plan, ops = engine.greeks_xva_setup(
            xs, 1 << 20, dataclasses.replace(cfg, antithetic=anti))
        kind = "am" if m <= 8 else "runtime-m"
        out.append((f"K44 {kind} m={m} 12 nodes"
                    f"{' antithetic' if anti else ''} 2^20",
                    lambda o=ops, p=plan: greek_pairs(kcm.xva_greek_partials(
                        o, SEED, 0, p, p.num_blocks)),
                    True if m <= 8 else plan.iters * plan.units_per_iter))
    # K10 on the exotic path's arithmetic Asian call (S = K = 100, r = 0.05,
    # v = 0.2, T = 1, 50 dates), 2^22 paths on phase 6's plan: F32_KAHAN and
    # F32, the geometric average, antithetic (F32_KAHAN and F32); and 2^20
    # on the level plan of mctpu's 8 x 8 MLMC default, plain and antithetic.
    f32 = t.Precision.F32
    for avg, anti, prec, n, mlmc_plan in (
            ("arithmetic", False, None, 1 << 22, False),
            ("arithmetic", False, f32, 1 << 22, False),
            ("geometric", False, None, 1 << 22, False),
            ("arithmetic", True, None, 1 << 22, False),
            ("arithmetic", True, f32, 1 << 22, False),
            ("arithmetic", False, None, 1 << 20, True),
            ("arithmetic", True, None, 1 << 20, True)):
        opt = t.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=50,
                            average=avg)
        c = dataclasses.replace(mlmc_cfg if mlmc_plan else cfg,
                                antithetic=anti,
                                precision=prec or cfg.precision)
        plan = (v.mlmc._level_plan(n, c) if mlmc_plan
                else engine.greeks_asian_setup(opt, n, c)[0])
        gp = v.kasian.greek_params(opt, c.torch_device())
        out.append((f"K10 {avg} 50 dates 2^{n.bit_length() - 1}"
                    f"{' MLMC 8 x 8 plan ' if mlmc_plan else ' '}"
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows}"
                    f"{' antithetic' if anti else ''}"
                    f"{' F32' if prec else ''}",
                    lambda o=gp, p=plan, g=avg == "geometric":
                    v.kasian.greek_partials(o, SEED, 0, p, p.num_blocks, 50,
                                            g), True))
    # K27 on K29's option at 100 steps, 2^22 paths on phase 6's plan: Euler
    # (F32_KAHAN and F32) and QE, each antithetic; and Euler at 8 steps,
    # level 0 of mctpu's 8 x 8 MLMC default, 2^20 on its level plan, plain
    # and antithetic.
    for scheme, anti, prec, n, mlmc_plan in (
            ("euler", False, None, 1 << 22, False),
            ("euler", False, f32, 1 << 22, False),
            ("qe", False, None, 1 << 22, False),
            ("euler", True, None, 1 << 22, False),
            ("qe", True, f32, 1 << 22, False),
            ("euler", False, None, 1 << 20, True),
            ("euler", True, None, 1 << 20, True)):
        steps = 8 if mlmc_plan else 100
        c = dataclasses.replace(mlmc_cfg if mlmc_plan else cfg,
                                antithetic=anti,
                                precision=prec or cfg.precision)
        plan = (v.mlmc._level_plan(n, c) if mlmc_plan
                else engine.heston_setup(hopt, n, c, steps, scheme)[0])
        par = v.kheston.params(hopt, steps, scheme == "qe", c.torch_device())
        out.append((f"K27 {'QE' if scheme == 'qe' else 'Euler'} {steps} "
                    f"steps 2^{n.bit_length() - 1}"
                    f"{' MLMC 8 x 8 level 0 ' if mlmc_plan else ' '}"
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows}"
                    f"{' antithetic' if anti else ''}"
                    f"{' F32' if prec else ''}",
                    lambda o=par, p=plan, s=steps, q=scheme == "qe":
                    v.kheston.partials(o, SEED, 0, p, p.num_blocks, s, q),
                    True))
    # K11 on the JAX exotic CLI's --product mlmc-asian option (S = K = 100,
    # r = 0.05, v = 0.2, T = 1) at level 4 of n0 = 4 (64 dates): 2^22 paths
    # on the level plan of the default EngineConfig (phase 6's),
    # arithmetic (F32_KAHAN and F32) and geometric, each antithetic; and
    # 2^20 on the level plan of mctpu's 8 x 8 MLMC default, arithmetic
    # plain and antithetic and geometric.
    for avg, anti, prec, n, mlmc_plan in (
            ("arithmetic", False, None, 1 << 22, False),
            ("arithmetic", False, f32, 1 << 22, False),
            ("geometric", False, None, 1 << 22, False),
            ("arithmetic", True, None, 1 << 22, False),
            ("arithmetic", True, f32, 1 << 22, False),
            ("geometric", True, None, 1 << 22, False),
            ("arithmetic", False, None, 1 << 20, True),
            ("arithmetic", True, None, 1 << 20, True),
            ("geometric", False, None, 1 << 20, True)):
        c = dataclasses.replace(mlmc_cfg if mlmc_plan else cfg,
                                antithetic=anti,
                                precision=prec or cfg.precision)
        plan = v.mlmc._level_plan(n, c)
        lp = v.kasian.level_params(
            t.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=4), 64,
            c.torch_device())
        out.append((f"K11 {avg} level 4 (64 dates) 2^{n.bit_length() - 1}"
                    f"{' MLMC 8 x 8 plan ' if mlmc_plan else ' '}"
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows}"
                    f"{' antithetic' if anti else ''}"
                    f"{' F32' if prec else ''}",
                    lambda o=lp, p=plan, g=avg == "geometric":
                    v.kasian.level_partials(o, SEED, 0, p, p.num_blocks, 64,
                                            g), True))
    # K41 on the JAX Greeks CLI's --product cva-multi set at --assets 16
    # (12 nodes), and at 32 on the exotic CLI's set with 12 nodes (the
    # Greeks CLI's spots turn negative past 20), 2^20 paths, plain and
    # antithetic.
    for m, anti in ((16, False), (16, True), (32, False), (32, True)):
        spec = (greeks_set(t, m).netting if m <= 16
                else netting_set(t, m, 12))
        plan, ops = engine.greeks_cva_multi_setup(
            spec, 1 << 20, dataclasses.replace(cfg, antithetic=anti))
        out.append((f"K41 m={m} 12 nodes{' antithetic' if anti else ''} "
                    "2^20", lambda o=ops, p=plan: kcm.greek_partials(
                        o, SEED, 0, p, p.num_blocks), True))
    # K19 on phase 6's variance swaps at 252 dates, 2^22 paths: the Heston
    # leg (v0 = 0.09, kappa 2, theta 0.04, xi 0.3, rho -0.6, r 0.03, T 1)
    # plain and antithetic, F32_KAHAN and F32, and with its scratch capped
    # at 2^20 floats; the GBM leg (S = K = 100, r = 0.05, v = 0.2, T = 1)
    # plain and antithetic.
    vs_heston = t.HestonOption(100.0, 100.0, 0.03, 1.0, 0.09, 2.0, 0.04, 0.3,
                               -0.6)
    vs_gbm = t.VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    for leg, anti, prec, capped in (("Heston", False, None, False),
                                    ("Heston", False, f32, False),
                                    ("Heston", True, None, False),
                                    ("Heston", True, f32, False),
                                    ("Heston", False, None, True),
                                    ("GBM", False, None, False),
                                    ("GBM", True, None, False)):
        c = dataclasses.replace(cfg, antithetic=anti,
                                precision=prec or cfg.precision)
        plan, par = engine.varswap_setup(
            vs_heston if leg == "Heston" else vs_gbm, 1 << 22, c, 252)
        out.append((f"K19 {leg} 252 dates 2^22 "
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows}"
                    f"{' antithetic' if anti else ''}"
                    f"{' F32' if prec else ''}"
                    f"{' scratch capped' if capped else ''}",
                    lambda o=par, p=plan, k=cap_of(v.kvarswap.partials,
                                                   capped):
                    v.kvarswap.partials(o, SEED, 0, p, p.num_blocks, 252,
                                        **k), True))
    # K20's Heston leg on phase 6's variance swap (K19's Heston option) at
    # 252 dates, 2^22 paths: plain and antithetic, F32_KAHAN and F32, and
    # with its scratch capped at 2^20 floats.
    for anti, prec, capped in ((False, None, False), (True, None, False),
                               (False, f32, False), (True, f32, False),
                               (False, None, True)):
        c = dataclasses.replace(cfg, antithetic=anti,
                                precision=prec or cfg.precision)
        plan, gp = engine.greeks_varswap_setup(vs_heston, 1 << 22, c, 252)
        out.append((f"K20H 252 dates 2^22 "
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows}"
                    f"{' antithetic' if anti else ''}"
                    f"{' F32' if prec else ''}"
                    f"{' scratch capped' if capped else ''}",
                    lambda o=gp, p=plan, k=cap_of(v.kvarswap.greek_partials,
                                                  capped):
                    v.kvarswap.greek_partials(o, SEED, 0, p, p.num_blocks,
                                              252, **k), True))
    # K34 on phase 6's basket-barrier Greeks, equicorrelated(a, 0.3) at 50
    # dates: a = 3 at 2^23 paths (256 x 1 x 256) up-and-out at H = 130,
    # plain and antithetic, F32, down-and-out at H = 90, and with its
    # scratch capped at 2^20 floats; a = 1 and 8 up-and-out at 2^22, plain
    # and antithetic, and 4-6 (either side of the (sign, path) items).
    for a, n, up, anti, prec, capped in (
            (3, 1 << 23, True, False, None, False),
            (3, 1 << 23, True, True, None, False),
            (3, 1 << 23, True, False, f32, False),
            (3, 1 << 23, False, False, None, False),
            (3, 1 << 23, False, True, None, False),
            (3, 1 << 23, True, False, None, True),
            (1, 1 << 22, True, False, None, False),
            (1, 1 << 22, True, True, None, False),
            (4, 1 << 22, True, True, None, False),
            (5, 1 << 22, True, True, None, False),
            (6, 1 << 22, True, False, None, False),
            (6, 1 << 22, True, True, None, False),
            (8, 1 << 22, True, False, None, False),
            (8, 1 << 22, True, True, None, False)):
        h = 130.0 if up else 90.0
        bopt = t.BasketBarrierOption(
            t.BasketOption.equicorrelated(a, 0.3), h, n_obs=50,
            kind="up-and-out" if up else "down-and-out")
        c = dataclasses.replace(cfg, antithetic=anti,
                                precision=prec or cfg.precision)
        plan, ops = engine.greeks_basket_barrier_setup(bopt, n, c)
        out.append((f"K34 a={a} {'up' if up else 'down'} H={h:g} 50 dates "
                    f"2^{n.bit_length() - 1} "
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows}"
                    f"{' antithetic' if anti else ''}"
                    f"{' F32' if prec else ''}"
                    f"{' scratch capped' if capped else ''}",
                    lambda o=ops, p=plan, u=up, k=cap_of(
                        kmw.am_bar_greek_partials, capped):
                    kmw.am_bar_greek_partials(*o, SEED, 0, p, p.num_blocks,
                                              50, u, **k), True))
    # K55 on phase 6's RQMC Asians (S = K = 100, r = 0.05, v = 0.2, T = 1),
    # 16 replicates on the layout asian_rqmc_setup gives: 50 dates
    # arithmetic at 2^18 points a replicate (16 x 13 x 163) and with its
    # scratch capped at 2^20 floats, 252 geometric at 2^16 (16 x 16 x 32),
    # and 12 dates arithmetic at 2^18 and 300 dates arithmetic at 2^16.
    rkey = v.qmc_engine.rqmc_key(SEED)
    for m, avg, n, capped in ((50, "arithmetic", 1 << 18, False),
                              (50, "arithmetic", 1 << 18, True),
                              (252, "geometric", 1 << 16, False),
                              (12, "arithmetic", 1 << 18, False),
                              (300, "arithmetic", 1 << 16, False)):
        aopt = t.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=m,
                             average=avg)
        plan, rops = v.qmc_engine.asian_rqmc_setup(aopt, n, cfg, 16)
        out.append((f"K55 {avg} {m} dates 16 x 2^{n.bit_length() - 1} "
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows}"
                    f"{' scratch capped' if capped else ''}",
                    lambda o=rops, p=plan, g=avg == "geometric",
                    k=cap_of(v.krqmc.asian_partials, capped):
                    v.krqmc.asian_partials(o, rkey, 0, p, 16, g, **k),
                    True))
    # K15 on phase 6's lookbacks (S = 100, r = 0.05, v = 0.2, T = 1, 50
    # dates; the fixed strikes at k = 100), 2^22 paths on phase 6's plan:
    # the floating call F32_KAHAN and F32, the floating put, the fixed call
    # and put, antithetic (the floating call F32_KAHAN and F32, the fixed
    # put), the floating call with its scratch capped at 2^20 floats; and
    # 2^20 on the level plan of mctpu's 8 x 8 MLMC default, plain and
    # antithetic.
    lb_fl = t.LookbackOption(100.0, 0.05, 0.2, 1.0, n_obs=50)
    for kind, payoff, anti, prec, n, mlmc_plan, capped in (
            ("floating", "call", False, None, 1 << 22, False, False),
            ("floating", "call", False, f32, 1 << 22, False, False),
            ("floating", "put", False, None, 1 << 22, False, False),
            ("fixed", "call", False, None, 1 << 22, False, False),
            ("fixed", "put", False, None, 1 << 22, False, False),
            ("floating", "call", True, None, 1 << 22, False, False),
            ("floating", "call", True, f32, 1 << 22, False, False),
            ("fixed", "put", True, None, 1 << 22, False, False),
            ("floating", "call", False, None, 1 << 22, False, True),
            ("floating", "call", False, None, 1 << 20, True, False),
            ("floating", "call", True, None, 1 << 20, True, False)):
        lopt = dataclasses.replace(lb_fl, kind=kind, payoff=payoff,
                                   k=100.0 if kind == "fixed" else 0.0)
        c = dataclasses.replace(mlmc_cfg if mlmc_plan else cfg,
                                antithetic=anti,
                                precision=prec or cfg.precision)
        plan = (v.mlmc._level_plan(n, c) if mlmc_plan
                else engine.lookback_setup(lopt, n, c)[0])
        par = v.klookback.params(lopt, c.torch_device())
        out.append((f"K15 {kind} {payoff} 50 dates 2^{n.bit_length() - 1}"
                    f"{' MLMC 8 x 8 plan ' if mlmc_plan else ' '}"
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows}"
                    f"{' antithetic' if anti else ''}"
                    f"{' F32' if prec else ''}"
                    f"{' scratch cap 2^20' if capped else ''}",
                    lambda o=par, p=plan, m=v.klookback.mode_of(lopt),
                    k=cap_of(v.klookback.partials, capped):
                    v.klookback.partials(o, SEED, 0, p, p.num_blocks, 50, m,
                                         **k), True))
    # K54 on phase 6's RQMC baskets, equicorrelated(a, 0.3), 16 replicates
    # on the layout basket_rqmc_setup gives: 2^20 points a replicate at 3
    # to 16 assets (c = 32, 8), 2^18 past them (c = 4 at 17-32, 2 at 48
    # and 64, 1 past 64); and 2^18 at 3 and 100 assets on chunks of 37 rows
    # (chunk bases off the 32-point groups, rounds of two groups).
    for a, n, brows in ((3, 1 << 20, None), (12, 1 << 20, None),
                        (13, 1 << 20, None), (16, 1 << 20, None),
                        (17, 1 << 18, None), (20, 1 << 18, None),
                        (24, 1 << 18, None), (28, 1 << 18, None),
                        (32, 1 << 18, None), (48, 1 << 18, None),
                        (64, 1 << 18, None), (65, 1 << 18, None),
                        (100, 1 << 18, None), (128, 1 << 18, None),
                        (129, 1 << 18, None), (200, 1 << 18, None),
                        (256, 1 << 18, None), (300, 1 << 18, None),
                        (336, 1 << 18, None), (3, 1 << 18, 37),
                        (100, 1 << 18, 37)):
        bopt = t.BasketOption.equicorrelated(a, 0.3)
        plan, bops = v.qmc_engine.basket_rqmc_setup(bopt, n, cfg, 16)
        if brows is not None:
            c = v.kbasket.pack_factor(a)[1]
            plan = v.qmc_engine.rqmc_plan(n, 16, brows,
                                          pts_per_chunk=brows * c)
        out.append((f"K54 a={a} 16 x 2^{n.bit_length() - 1} "
                    f"{plan.num_blocks}x{plan.iters}x{plan.rows}",
                    lambda o=bops, p=plan: v.krqmc.basket_partials(
                        o, rkey, 0, p, 16), True))
    # The bit-equality sweeps, small shapes: K55 at 1, 3, 6, 7, 12, 13, 50,
    # 64, 65, 252, 255, 300 and 2048 dates (every residue of the dates mod
    # 8, each W instance's ends), both averages, on 3 chunks of rows 8, 24,
    # 32 or 163, 16 replicates, and at 50 and 252 dates with the scratch
    # capped at 1 float and at half; K19 at 13 and
    # 252 dates, 2 iterations on 64 x 2 x 32, each leg plain and
    # antithetic, F32_KAHAN and F32, and the Heston leg at 252 with its
    # scratch capped at 1 float and at half.
    def caps(entry, *plan_args):
        """``{}`` and this version's caps of 1 float and half the scratch
        (none where its wrapper takes no cap)."""
        lib = v.build.library()
        if not hasattr(lib, entry):
            return [{}, {}, {}]
        half = getattr(lib, entry)(*plan_args, 0) // 2
        return [{}, {"scratch_cap": 1}, {"scratch_cap": half}]

    for m, rows in ((1, 8), (3, 8), (6, 24), (7, 24), (12, 8), (12, 24),
                    (13, 8), (50, 163), (50, 32), (64, 8), (65, 24),
                    (252, 32), (252, 8), (255, 8), (300, 8), (300, 24),
                    (2048, 8)):
        plan = v.qmc_engine.rqmc_plan(3 * rows * 128, 16, rows)
        for avg in ("arithmetic", "geometric"):
            aopt = t.AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=m,
                                 average=avg)
            rops = v.krqmc.asian_operands(aopt, cfg.torch_device())
            capped = (caps("mctpu_rqmc_asian_scratch_floats", 16,
                           plan.paths_per_iter, plan.iters)
                      if (m, rows) in ((50, 163), (252, 32)) else [{}])
            for k in capped:
                out.append((f"K55 bits {avg} {m} dates rows {rows} 16x3"
                            f"{' cap ' + str(k['scratch_cap']) if k else ''}",
                            lambda o=rops, p=plan, g=avg == "geometric",
                            k=k: v.krqmc.asian_partials(o, rkey, 0, p, 16,
                                                        g, **k), True))
    for leg, n_obs in (("GBM", 13), ("GBM", 252), ("Heston", 13),
                       ("Heston", 252)):
        for anti, kahan in ((False, True), (False, False), (True, True),
                            (True, False)):
            plan = v.kvarswap.make_plan(64 * 2 * 32 * 128 * (2 if anti else 1),
                                        64, 32, anti, kahan)
            par = (v.kvarswap.heston_params(vs_heston, n_obs,
                                            cfg.torch_device())
                   if leg == "Heston" else
                   v.kvarswap.params(vs_gbm, n_obs, cfg.torch_device()))
            capped = (caps("mctpu_varswap_scratch_floats", 64, plan.rows,
                           plan.iters)
                      if (leg, n_obs, anti) == ("Heston", 252, False)
                      else [{}])
            for k in capped:
                out.append((f"K19 bits {leg} {n_obs} dates 64x2x32"
                            f"{' antithetic' if anti else ''}"
                            f"{'' if kahan else ' F32'}"
                            f"{' cap ' + str(k['scratch_cap']) if k else ''}",
                            lambda o=par, p=plan, n=n_obs, k=k:
                            v.kvarswap.partials(o, SEED, 0, p, 64, n, **k),
                            True))
    # K15 at 13 and 50 dates, 2 iterations on 64 x 2 x 32, every mode
    # (the fixed strikes at 105 and 95), plain and antithetic, F32_KAHAN and
    # F32, and the floating call at 50 dates with its scratch capped at 1
    # float and at half.
    for n_obs in (13, 50):
        for kind, payoff in (("floating", "call"), ("floating", "put"),
                             ("fixed", "call"), ("fixed", "put")):
            lopt = t.LookbackOption(
                100.0, 0.05, 0.2, 1.0, n_obs=n_obs, kind=kind, payoff=payoff,
                k={"call": 105.0, "put": 95.0}[payoff] if kind == "fixed"
                else 0.0)
            par = v.klookback.params(lopt, cfg.torch_device())
            mode = v.klookback.mode_of(lopt)
            for anti, kahan in ((False, True), (False, False), (True, True),
                                (True, False)):
                plan = v.klookback.make_plan(
                    64 * 2 * 32 * 128 * (2 if anti else 1), 64, 32, anti,
                    kahan)
                capped = (caps("mctpu_lookback_scratch_floats", 64, plan.rows,
                               plan.iters)
                          if (n_obs, mode, anti, kahan) == (50, 0, False,
                                                            True)
                          else [{}])
                for k in capped:
                    tag = f" cap {k['scratch_cap']}" if k else ""
                    out.append((f"K15 bits {kind} {payoff} {n_obs} dates "
                                f"64x2x32{' antithetic' if anti else ''}"
                                f"{'' if kahan else ' F32'}{tag}",
                                lambda o=par, p=plan, n=n_obs, m=mode, k=k:
                                v.klookback.partials(o, SEED, 0, p, 64, n, m,
                                                     **k), True))
    # K54 at 1-336 assets (each side of 32, 64, 128 and 256: the instances'
    # ends) on 3 chunks of rows 1, 3, 37 and 163 (c points a row), 16
    # replicates: chunk bases off the 32-point groups, rounds of one to four
    # groups.
    for a in (1, 3, 12, 32, 33, 64, 65, 100, 128, 129, 256, 257, 300, 336):
        bopt = t.BasketOption.equicorrelated(a, 0.3)
        c = v.kbasket.pack_factor(a)[1]
        bops = v.krqmc.basket_operands(
            bopt, v.mcmath.cholesky_lower(bopt.corr), cfg.torch_device())
        for brows in (1, 3, 37, 163):
            plan = v.qmc_engine.rqmc_plan(3 * brows * c, 16, brows,
                                          pts_per_chunk=brows * c)
            out.append((f"K54 bits a={a} rows {brows} 16x3",
                        lambda o=bops, p=plan: v.krqmc.basket_partials(
                            o, rkey, 0, p, 16), True))
    # K34 at 1-8 assets (equicorrelated(a, 0.3)), 1, 13 and 50 dates, up-
    # and-out at H = 104 and down-and-out at H = 96, 2 iterations on 64 x 2
    # x 32, plain and antithetic, F32_KAHAN and F32, and at 3 and 8 assets,
    # 50 dates, with the scratch capped at 1 float and at half (plain
    # F32_KAHAN up, antithetic F32 down); K20's Heston leg at 1, 13 and 252
    # dates likewise, capped at 252.
    for a in range(1, 9):
        bk = t.BasketOption.equicorrelated(a, 0.3)
        chol = v.mcmath.cholesky_lower(bk.corr)
        for n_obs in (1, 13, 50):
            for up, h in ((True, 104.0), (False, 96.0)):
                ops = tuple(x.to(cfg.torch_device())
                            for x in kmw.am_bar_greek_ops(bk, chol, n_obs, h))
                for anti, kahan in ((False, True), (False, False),
                                    (True, True), (True, False)):
                    plan = kmw.make_plan(
                        64 * 2 * 32 * 128 * (2 if anti else 1), 64, 32, anti,
                        kahan, n_assets=a)
                    capped = (caps("mctpu_multi_walk_bar_greeks_am_"
                                   "scratch_floats", a, 64, plan.rows,
                                   plan.iters)
                              if a in (3, 8) and n_obs == 50
                              and (anti, kahan, up) in ((False, True, True),
                                                        (True, False, False))
                              else [{}])
                    for k in capped:
                        tag = f" cap {k['scratch_cap']}" if k else ""
                        out.append((f"K34 bits a={a} {n_obs} dates "
                                    f"{'up' if up else 'down'} 64x2x32"
                                    f"{' antithetic' if anti else ''}"
                                    f"{'' if kahan else ' F32'}{tag}",
                                    lambda o=ops, p=plan, n=n_obs, u=up, k=k:
                                    kmw.am_bar_greek_partials(
                                        *o, SEED, 0, p, 64, n, u, **k), True))
    for n_obs in (1, 13, 252):
        gp = v.kvarswap.heston_greek_params(vs_heston, n_obs,
                                            cfg.torch_device())
        for anti, kahan in ((False, True), (False, False), (True, True),
                            (True, False)):
            plan = v.kvarswap.make_plan(64 * 2 * 32 * 128 * (2 if anti else 1),
                                        64, 32, anti, kahan)
            capped = (caps("mctpu_varswap_greeks_scratch_floats", 64,
                           plan.rows, plan.iters)
                      if n_obs == 252 and kahan else [{}])
            for k in capped:
                out.append((f"K20H bits {n_obs} dates 64x2x32"
                            f"{' antithetic' if anti else ''}"
                            f"{'' if kahan else ' F32'}"
                            f"{' cap ' + str(k['scratch_cap']) if k else ''}",
                            lambda o=gp, p=plan, n=n_obs, k=k:
                            v.kvarswap.greek_partials(o, SEED, 0, p, 64, n,
                                                      **k), True))
    return out


def same_bits(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def pairs_close(got, want, units: int) -> float:
    """The largest error over its bound of (sum x, sum x^2) pairs along
    axis 1: RTOL (|want sum x| + sqrt(units want sum x^2)) on sum x, RTOL
    want sum x^2 on sum x^2 (chip_smoke.close_pairs); above 1 they differ."""
    got, want = got.double(), want.double()
    s, s2 = want[:, 0::2], want[:, 1::2].abs()
    bound = torch.empty_like(want)
    bound[:, 0::2] = RTOL * (s.abs() + torch.sqrt(units * s2))
    bound[:, 1::2] = RTOL * s2
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(((got - want).abs() / bound.clamp(min=1e-300)).max())


def build_all(versions) -> None:
    """Each version's kernel library, built in parallel threads."""
    errors = []

    def run(v):
        try:
            v.build.library()
        except Exception as exc:  # re-raised below, in the main thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(v,)) for v in versions]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--only", action="append", default=[],
                    help="run only the cases whose name contains this "
                         "(repeatable: any of them)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    this = load(ROOT)
    other = load(args.root.resolve()) if args.root is not None else None
    build_all([v for v in (other, this) if v is not None])

    def kept(version):
        return [c for c in cases(version)
                if not args.only or any(o in c[0] for o in args.only)]
    mine = kept(this)
    theirs = kept(other) if other is not None else None
    out, differ = [], []
    for k, (name, fn, compare) in enumerate(mine):
        if theirs is None:
            order = (("V", fn),)
        else:
            order = (("P", theirs[k][1]), ("V", fn), ("V", fn),
                     ("P", theirs[k][1]))
        times, hosts = [], []
        for tag, f in order:
            ms, host = kernel_ms(f, args.reps)
            times.append(ms)
            hosts.append(host)
            out.append({"case": name, "version": tag, "ms": ms,
                        "host_ms": host,
                        "root": str(other.root if tag == "P" else ROOT),
                        "card": smi})
        line = (f"{name}: " + " ".join(f"{tag} {ms:.4f}" for (tag, _), ms
                                       in zip(order, times))
                + " ms (host " + " ".join(f"{h:.4f}" for h in hosts) + ")")
        if compare is True and theirs is not None:
            equal = same_bits(fn(), theirs[k][1]())
            out[-1]["bitwise_equal"] = equal
            line += ("; outputs equal the other checkout's bit for bit: "
                     f"{equal}")
            if not equal:
                differ.append(name)
        elif compare and theirs is not None:
            worst = pairs_close(fn(), theirs[k][1](), compare)
            out[-1]["max_err_over_bound"] = worst
            line += (f"; outputs within rtol {RTOL} of the other "
                     f"checkout's (scaled pair bound): max err / bound "
                     f"{worst:.3e}")
            if not worst <= 1.0:
                differ.append(name)
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    if differ:
        print("outputs differ: " + ", ".join(differ), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
