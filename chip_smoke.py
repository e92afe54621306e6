#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (one line each; any failure raises, so the exit code is non-zero):

1. device — the card's name and power limit (nvidia-smi);
2. build — the fifty-five kernels from ``mctpu_torch/csrc`` with nvcc
   (sm_90a), one nvcc per source, all started together, and the
   runtime-m xVA kernels;
3. kernel vs plain — each kernel against its plain PyTorch version on the
   card at a medium plan (64 blocks, rows 32, 2 iterations; the Asian,
   barrier, lookback and cliquet walks at an odd step count of 13; the
   ladder and the book at 1, 5 and 64 strikes or instruments; the
   variance swap at 1, 13 and 252 dates; the barrier book at 1, 5 and 32
   instruments and 1, 7 and 50 dates; the Heston walks, Euler, QE and
   Greeks, at 13 and 100 steps, and the variance swap's Heston leg at 13
   and 252 dates; the multi-asset walks and their asset-major Greeks at 1,
   3 and 8 assets and the packed walk and its Greeks at 9, 16, 17, 32 and
   100, at 13 dates; the split walks K12, K15 (every lookback mode) and
   K30 (a = 3, the Asian and the knock-out) at 50 dates, K10 (both
   averages) at 13 dates, K27 (Euler
   and QE) at 8 steps (level 0 of ``mctpu``'s MLMC default), K19 (GBM at
   13 dates, Heston at 13 and 252) and K29 at level 4 on the MLMC 8 x 8
   plan with 32 iterations, plain and antithetic, and with their scratch
   capped at 1 float and at half the one-group size, bit-equal to the
   one-group launch; the
   rainbow and its Greeks at 1, 3 and 8 assets and the packed
   rainbow at 9, 16 and 100, max and min; the netting-set CVA and its
   Greeks at 1, 2 (mixed-sign), 3 and 8 underlyings and the packed
   netting set and its Greeks at 9, 16, 17, 32 and 100, at 13 nodes (the
   packed netting set's register instances also at rows 35 and 69, a
   pass with lanes past the rows); the xVA and
   its Greeks at 1, 2, 3 and 8 and the runtime-m kernels at 9, 16, 17 and
   100 and forced at 3 against the M = 3 kernels, K44 also at 4-7, with
   its scratch capped (bit-equal to one group) and its runtime-m kernel at
   13 rows (a short last slice); the control variates K45-K48
   at the vanilla call at and deep in the money, the Asian at 13 and 50
   dates, baskets of 1, 3 and 8 and packed of 9, 16, 17, 32 and 100
   assets, K48 also on the pilot's plan of the 100-asset call (8 blocks x
   102 iterations, and 51 antithetic), antithetic and Kahan each on and
   off; the importance-sampled call K49
   at K = 100 and 200, untilted and at the optimal tilt; the American walk
   K50 and its Greeks K51 on a put and a call at 1, 13 and 50 dates under
   a pilot-fitted rule, K51's price sums equal to K50's bit for bit; the
   MLMC level kernels K29 (Heston Euler), K11 (Asian, both averages) and
   K14 (knock-out, up and down) at levels 1 and 4, their level sums by the
   Greek kernels' scaled bound, because a payoff difference's block sum can
   cancel; antithetic and Kahan each on and off; the RQMC nets K52 and
   K53 call and put, K54 at 3, 12, 100 and 300 assets and at 65 and 128
   on 37-point chunks (bases off the 32-point groups) and K55 at 1, 12,
   50, 252 and 300 dates, geometric and arithmetic, on a power-of-two chunk
   and on rows 24 and 163, 16 replicates, their unfolded quads compared
   folded, s + c and s2 + c2; K55's split net also with its scratch
   capped at 1 float and at half, bit-equal to one group): equal
   at rtol 2e-5 (the Greek kernels' (sum x, sum x^2) pairs by the scaled
   bound rtol * (|sum x| + sqrt(n * sum x^2)), n the units per block,
   because a Greek's block sum can nearly cancel; rtol 1e-4 under
   wrong-way risk; the control variates' centered sum d and sum cc by the
   same bound and sum d cc within rtol * sqrt(sum d^2 * sum cc^2)),
   two launches bitwise equal, block offsets bitwise;
4. main paths, each with the launch counters set to 0 just before it and
   read just after: the pricing path (``mctpu_torch.price_*`` with the
   default EngineConfig at real sizes, each within 4 standard errors of
   its closed form, or equal to the plain version at the same plan), the
   Greeks path (``mctpu_torch.greeks`` at real sizes: vanilla against
   Black-Scholes Greeks, basket against common-random-number bumps of
   ``price_basket``, CVA against finite differences of its closed form and
   CRN bumps under wrong-way risk; each Greeks price equal to its
   pricer's at the same seed) and the exotic path (Asian and knock-out
   barrier calls at n_obs=50 and 2^22 paths: prices against the geometric
   closed form, Black-Scholes limits and the BGK-corrected barrier
   formula; Greeks against autograd of the geometric closed form and CRN
   bumps of the pricers) and the lookback/cliquet path (lookbacks at
   n_obs=50 and 2^22 paths against a float64 NumPy oracle, the
   Goldman-Sosin-Gatto bound and Black-Scholes; their Greeks against the
   homogeneity identity and CRN bumps; cliquets at 2^24 paths against the
   exact closed form, their Greeks against its autograd) and the book path
   (a 64-strike ladder and the 64-instrument serving book at 2^24 paths,
   prices and all six Greeks against Black-Scholes at 4.5 standard errors,
   the reference's small gates at 4; the one-strike ladder and the
   one-instrument book against ``price_vanilla``; a market tick through
   the same library) and the variance-swap path (the fair strike at 252,
   52 and 12 dates and 2^22 paths, and its vega, rho and theta, against
   the exact discrete oracle and its derivatives) and the barrier-book
   path (the 32-instrument serving book at 2^22 paths: calls against
   ``price_barrier``, puts against a float64 oracle, the Greeks against
   ``greeks_barrier`` and a CRN bump, the one-instrument tie with
   ``price_barrier``, a tick that flips a direction) and the Heston path
   (``price_heston`` Euler and QE and ``mctpu_torch.greeks`` at 100 steps
   and 2^22 paths against Black-Scholes at zero vol-of-vol, the
   characteristic-function price and its finite differences and CRN
   bumps; QE at 16 steps; the Heston variance swap at 252 dates against
   its continuous-time fair strike and that form's gradient) and the
   multi-asset walk path (basket-Asian and basket-barrier calls on the JAX
   CLIs' default basket at 50 dates and 2^22 paths, and at 16 and 100
   assets, against a float64 oracle, the terminal basket and the
   single-asset walks; their asset-major Greeks on ``equicorrelated(3,
   0.3)`` against CRN bumps, the terminal basket Greeks and the
   single-asset Greeks, each Greeks price equal to its pricer's bit for
   bit; a rank-deficient correlation refused; the packed basket-Asian
   Greeks on ``equicorrelated(16, 0.3)`` at 12 dates against CRN bumps,
   its price equal to the pricer's at 16 dates; the packed basket-barrier
   Greeks at 9 and 16 assets against CRN bumps, the price equal to the
   pricer's) and the rainbow path
   (``price_rainbow`` at 1, 2, 3, 16 and 100 assets against Black-Scholes,
   the Stulz closed form, the k = 0 identity and a float64 oracle;
   ``greeks_rainbow`` against autograd of the Stulz form, CRN bumps and
   the k = 0 identities, its price equal to the pricer's bit for bit) and
   the netting-set CVA path (``price_cva_multi`` on the JAX exotic CLI's
   netting set at 3 and 16 underlyings and 2^20 paths against the closed
   form, its EE profile node by node against ``e^{r t_j} sum_m w_m C0_m``,
   the mixed-sign sets against the float64 oracle, one underlying against
   ``price_cva``; ``greeks_cva_multi`` on the JAX Greeks CLI's set against
   autograd of the closed form, on the mixed-sign set against CRN bumps,
   its CVA equal to the pricer's bit for bit, and at 9 and 16 underlyings
   (K41) against autograd of the closed form, its CVA within 1e-5 of the
   pricer's) and the xVA path (``price_xva`` on the JAX exotic CLI's set
   at 3 and 16 underlyings and 2^20 paths against the closed form, its EPE
   profile node by node, the all-short set's DVA and FBA, the mixed-sign
   sets at 2 and 9 against the float64 oracle, the tie to
   ``price_cva_multi`` without own default or funding, one run at 100
   underlyings; ``greeks_xva`` on the JAX Greeks CLI's set at 3 and 16
   against autograd of the closed form and on a mixed pair against CRN
   bumps of ``price_xva``) and the control-variate path
   (``mctpu_torch.variance`` at the JAX exotic CLI's ``--product cv``
   shapes: the call at 2^28 against Black-Scholes with its standard error
   1.8x below ``price_vanilla``'s, antithetic, and deep in the money
   100x below; the arithmetic Asian at 50 dates and 2^22 against
   ``price_asian`` on another seed, 8x below; baskets of 3 (2^24) and 100
   (2^22) assets and one with a Brownian offset against ``price_basket``,
   1.8x below) and the American path (``lsm.price_american`` on the JAX
   exotic CLI's put, 50 dates, 2^22 paths, engine tier (K50) against
   CRR-2000 within 4 standard errors + 0.02, CRR-1000 as a lower bound and
   the float64 oracle tier; the call at 20 dates against Black-Scholes,
   one date against the European put; ``price_american_bounds`` at 2^16
   and 64 inner samples bracketing CRR-4000; ``greeks_american`` (K51) on
   the Greeks CLI's put, 12 dates, 2^20, against central differences of
   the 12-date Bermudan lattice, its price equal to the pricer's bit for
   bit; ``price_american_heston`` QE at 50 steps, 2^17, against the
   characteristic-function European put and the CRR-50 limit; and
   ``variance.price_vanilla_is`` (K49) at K = 200, 2^28, against
   Black-Scholes with its standard error 10x below ``price_vanilla``'s,
   and three tilts at K = 150) and the MLMC path (``mctpu_torch.mlmc`` at
   the JAX exotic CLI's ``--product mlmc``, ``mlmc-asian`` and
   ``mlmc-barrier`` on its 512 x 256 config at eps = 0.02: the Heston
   Euler price within 3 eps of the characteristic-function price, the
   geometric Asian within 4 standard errors of its closed form at the
   finest level's dates, the up-and-out call above the continuous closed
   form and within eps + the remaining-bias estimate + 3 standard errors
   of it; Heston and the Asian at eps = 0.005; the Heston gate of
   ``tests/test_mlmc.py`` on ``mctpu``'s 8 x 8 default at eps = 0.05; the
   geometric level means against closed-form differences and the barrier
   level means below 0; each call's level table, wall ms, path-steps per
   second and launches) and the RQMC path (``mctpu_torch.qmc_engine`` at
   the JAX CLIs' RQMC calls, 16 replicates of n = 131072 points on the
   512 x 256 config: the vanilla call within 4 standard errors of
   Black-Scholes with its CI 5x below ``price_vanilla``'s at the same
   paths, the put by parity; the Asian at 50 dates, geometric against its
   closed form, arithmetic between it and the vanilla, and at 252 dates;
   baskets of 3 and 100 assets against ``price_basket``; the vanilla Greek
   surface, call and put at 2^13 and 2^20 points, against ``bs_greeks``;
   each call's wall ms, points per second and launches);
5. launch counters — every kernel of each path launched during its run;
6. times — each kernel and its plain version at its phase-4 shape, median
   of 5 synchronized runs (3 for the slower plain versions, said so in
   the line), beside the least time the card could take for the same
   work (``bound_ms``: instruction counts over the peak rate of their
   class, see ``PEAK_OPS``); a split kernel's time holds all its
   launches, the slice or split kernel and its fold (K4, K5, K40, K43 and
   its runtime-m kernel, K8 and K48, the split walks, K55's split net and
   its fold and the chunk carry); K48 also on its
   pilot's plan, a line of its own (``basket_cv_packed_pilot``, the
   kernel's launches beside it), and K27 Euler at level 0 of the MLMC 8 x
   8 default (8 steps, 8 x 128 x 8), a line that is printed only; K43's
   CVA sums and EPE profile at no own default and no funding
   equal to K40's bit for bit at the timed shape, plain and antithetic.

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
EXOTIC_KERNELS = ("asian", "asian_greeks", "barrier", "barrier_greeks")
LOOKBACK_KERNELS = ("lookback", "lookback_greeks")
CLIQUET_KERNELS = ("cliquet", "cliquet_greeks")
BOOK_KERNELS = ("ladder", "ladder_greeks", "book", "book_greeks")
VARSWAP_KERNELS = ("varswap", "varswap_greeks")
BARRIER_BOOK_KERNELS = ("barrier_book", "barrier_book_greeks")
# K30 and K31 under each product, K32, K33, K34 and K35.
MULTI_WALK_KERNELS = ("basket_asian_am", "basket_barrier_am",
                      "basket_asian_packed", "basket_barrier_packed",
                      "basket_asian_greeks_am", "basket_asian_greeks_packed",
                      "basket_barrier_greeks_am",
                      "basket_barrier_greeks_packed")
# K36, K37, K38.
RAINBOW_KERNELS = ("rainbow_am", "rainbow_packed", "rainbow_greeks")
# K40, K39, K42, K41.
CVA_MULTI_KERNELS = ("cva_multi_am", "cva_multi_packed",
                     "cva_multi_greeks_am", "cva_multi_greeks_packed")
# K43 and K44, up to 8 underlyings and their runtime-m kernels beyond.
XVA_KERNELS = ("xva_am", "xva_wide", "xva_greeks_am", "xva_greeks_wide")
# K45, K46, K47, K48.
CV_KERNELS = ("vanilla_cv", "asian_cv", "basket_cv_am", "basket_cv_packed")
# K49 (importance sampling), K50 and K51 (the American walk and its Greeks).
AMERICAN_KERNELS = ("vanilla_is", "lsm", "lsm_greeks")
# K29, K11 and K14 (the MLMC level kernels).
MLMC_KERNELS = ("heston_level", "asian_level", "barrier_level")
# K52, K53, K54 and K55 (the RQMC nets).
RQMC_KERNELS = ("rqmc_vanilla", "rqmc_greeks", "rqmc_basket", "rqmc_asian")
# K27 (Euler, QE), K28 and the Heston legs of K19 and K20.
HESTON_KERNELS = ("heston", "heston_qe", "heston_greeks", "varswap_heston",
                  "varswap_heston_greeks")
# The Euler scheme's bias at 100 steps beside the gates' standard errors,
# measured by tools/heston_euler_bias.py (float64, 2^22 paths): price
# within 0.01 of the characteristic-function price, delta, vega and rho
# within 0.5% of its central differences.
EULER_PRICE_ALLOWANCE = 0.01
EULER_GREEK_ALLOWANCE = 5e-3

# ---- the bound of phase 6 ---------------------------------------------------
# Peak instruction rates of one H100 SXM at 700 W: 132 SMs at the clock its
# published 67 TFLOP/s float32 implies (an FFMA counts two flops), with the
# rates per clock per SM of the CUDA C++ Programming Guide's arithmetic-
# instruction throughput table for compute capability 9.0: float32 add,
# multiply, FMA, compare and min/max 128; 32-bit integer multiply-add,
# logic and shift 64; the special-function unit (rcp, rsqrt, lg2, ex2) 16.
PEAK_OPS = {"int32": 67e12 / 4, "f32": 67e12 / 2, "sfu": 67e12 / 16}
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
# Instructions (int32, f32, sfu) of one unit of work, the least the
# arithmetic needs: a Philox-4x32-10 block is 10 rounds of two 32x32->64
# multiplies and two 3-input XORs (the round keys hoisted); a Box-Muller
# pair is logf and sqrtf on the SFU, the sin/cos polynomials and the bit
# moves; expf, an IEEE divide and an IEEE sqrtf are one SFU instruction and
# their float32 range reduction or refinement.  Every other multiply, add,
# compare or select counts one float32 instruction.
UNIT_OPS = {"philox": (40, 0, 0), "box_muller": (8, 16, 2),
            "expf": (0, 3, 1), "div": (0, 4, 1), "sqrt": (0, 4, 1),
            "f32": (0, 1, 0)}


def work(draws=0.0, expf=0.0, div=0.0, f32=0.0, sqrt=0.0):
    """``(int32, f32, sfu)`` instruction counts of a run that computes
    ``draws`` normals (a Philox block and a Box-Muller pair per two),
    ``expf`` exponentials, ``div`` IEEE divides, ``sqrt`` IEEE square roots
    and ``f32`` further float32 operations."""
    counts = {"philox": draws / 2, "box_muller": draws / 2, "expf": expf,
              "div": div, "sqrt": sqrt, "f32": f32}
    return tuple(sum(n * UNIT_OPS[u][c] for u, n in counts.items())
                 for c in range(3))


# The walk kernels (K4, K5, K9, K10, K12, K13, K15-K20) beyond their draws,
# counted from their sources: (expf per step, expf per path, IEEE divides
# per step, per path, float32 operations per step, per path, and per
# estimator unit for its sums: Acc2's compensated pair, or BlockAccN's
# plain (x, x^2) adds).  K4 and K5 reprice one option with two Hastings
# CDFs (an expf, a divide and a 5-term polynomial each) per node.
WALK_OPS = {
    "cva": (3, 0, 2, 0, 46, 0, 0),
    "cva_greeks": (3, 0, 2, 0, 100, 0, 21),
    "asian": (1, 0, 0, 1, 5, 2, 11),
    "asian_greeks": (1, 0, 0, 3, 16, 30, 15),
    "barrier": (0, 1, 0, 0, 6, 2, 11),
    "barrier_greeks": (0, 1, 0, 0, 10, 10, 12),
    "lookback": (0, 2, 0, 0, 5, 3, 11),
    "lookback_greeks": (0, 2, 0, 1, 14, 12, 12),
    "cliquet": (1, 0, 0, 0, 7, 0, 11),
    "cliquet_greeks": (1, 0, 0, 0, 19, 6, 12),
    "varswap": (0, 0, 0, 0, 4, 1, 11),
    "varswap_greeks": (0, 0, 0, 0, 5, 9, 12),
    "heston": (0, 1, 0, 0, 17, 3, 11),
    "heston_qe": (0, 1, 3, 0, 29, 3, 11),
    "heston_greeks": (0, 1, 1, 0, 50, 13, 21),
    "varswap_heston": (0, 0, 0, 0, 20, 1, 11),
    "varswap_heston_greeks": (0, 0, 1, 0, 67, 6, 18),
    "asian_cv": (1, 1, 0, 0, 6, 6, 11),
    # K50: the step (4), payoff (2), moneyness, Horner and compares (12),
    # cashflow (3) and alive flag (1); K51 adds the indicator, the pathwise
    # weight and the three tangents (14).  BlockAccN's adds per output.
    "lsm": (1, 0, 0, 0, 22, 0, 3),
    "lsm_greeks": (1, 0, 0, 0, 36, 0, 12),
    # The MLMC levels, per fine step or date of their fine leg: K29 takes
    # K27's Euler step (17) a fine step and, per two, a coarse step (17)
    # and the coarse normals' two adds and two multiplies; two payoffs
    # (7, two expf).  K11 takes two log-spot steps (8), the two fine and one
    # coarse sum adds (3) a coarse step, and two averages' divides and
    # payoffs (5); K14 two log-spot steps (8) and three flag updates (9) a
    # coarse step, the flags' difference and the payoff (4).
    "heston_level": (0, 2, 0, 0, 27.5, 7, 11),
    "asian_level": (1, 0, 0, 2, 5.5, 5, 11),
    "barrier_level": (0, 1, 0, 0, 8.5, 4, 11),
}
# The Heston walks (K27, K28, K19/K20's Heston leg) draw a whole Box-Muller
# pair every step (mct::walk_steps) and take IEEE square roots: sqrtf per
# step.  QE's counts are its quadratic branch, which the data takes unless
# v falls to about 6e-4 (psi > 1.5): the cheaper branch in float32, the
# same in SFU (its two divides and two roots against the exponential
# branch's Hastings expf and divide, a divide and a logf); the int32 class
# bounds either way.
WALK_SQRT = {"heston": 1, "heston_qe": 3, "heston_greeks": 1,
             "varswap_heston": 1, "varswap_heston_greeks": 1,
             "heston_level": 1.5}


def walk_work(kname: str, plan, steps: int):
    """Instruction counts of a walk kernel's run: every path draws a
    Philox block and a Box-Muller pair per two steps (an odd count draws a
    whole pair for its last step), or per step for a Heston walk."""
    e_s, e_p, d_s, d_p, f_s, f_p, f_u = WALK_OPS[kname]
    p, u = plan.total_paths, plan.total_units
    pairs = steps if kname in WALK_SQRT else -(-steps // 2)
    return work(draws=p * 2 * pairs, expf=p * (e_s * steps + e_p),
                div=p * (d_s * steps + d_p),
                f32=p * (f_s * steps + f_p) + u * f_u,
                sqrt=p * WALK_SQRT.get(kname, 0) * steps)


# The strike ladder and the vanilla book (K21-K24), counted from their
# sources: the strikes or instruments per CUDA block (a group redraws the
# simulation block's normals), and (float32 operations per path and
# strike/instrument: the payoff or the six integrands and their squares and
# adds; per path and group: the shared values; expf per path and group;
# expf per path and strike/instrument).
BOOK_GROUPS = {"ladder": 16, "ladder_greeks": 4, "book": 16,
               "book_greeks": 4}
BOOK_OPS = {"ladder": (4, 2, 1, 0), "ladder_greeks": (24, 4, 1, 0),
            "book": (7, 0, 0, 1), "book_greeks": (30, 0, 0, 1)}


def book_work(kname: str, plan, items: int, redraw: bool = True):
    """Instruction counts of a ladder or book kernel's run over ``items``
    strikes or instruments: each of its groups draws every path's normal,
    as the kernel does (with ``redraw=False``, one draw per path: the least
    the function needs, which ``bound_ms`` counts)."""
    f_i, f_g, e_g, e_i = BOOK_OPS[kname]
    groups = -(-items // BOOK_GROUPS[kname]) if redraw else 1
    p = plan.total_paths
    return work(draws=p * groups, expf=p * (e_g * groups + e_i * items),
                f32=p * (f_i * items + f_g * groups))


# The barrier book (K25, K26), counted from its source: float32 operations
# per path-step shared by the book (K26's z_1 select and its sum z and sum
# z^2), per instrument-step (the step's add, multiply and add, the
# compare's subtract, multiply and set, the alive mask's select) and per
# instrument and path (the payoff's subtract, multiply, max and select, in
# K26 the three scores, and the (x, x^2) sums); one expf per instrument and
# path.  Every path draws its walk once for the whole book.
BB_OPS = {"barrier_book": (0, 7, 7), "barrier_book_greeks": (4, 7, 26)}


def bb_work(kname: str, plan, items: int, steps: int):
    """Instruction counts of a barrier-book kernel's run over ``items``
    instruments and ``steps`` dates: one walk per path, as the kernel
    draws."""
    f_s, f_is, f_ip = BB_OPS[kname]
    p = plan.total_paths
    return work(draws=p * 2 * -(-steps // 2), expf=p * items,
                f32=p * (steps * (f_s + items * f_is) + items * f_ip))


# The multi-asset walks (K30-K35), counted from csrc/multi_walk.cu:
# float32 operations per asset and date beyond the correlation products (the
# signed normal, the log-spot step, the weighted spot and its sum; K32's and
# K33's three tangents, K34's and K35's score sums), per date (the monitor;
# K32's and K33's t_j sums), per asset and path and per path (the payoff
# and the Greeks; K33's and K35's lane values, their squares and their four
# halving-tree adds), the outputs per estimator unit (each a plain add of x
# and of x^2), the lower-triangular products per date (L z; K34 and K35
# also L^-1 z), each of
# a(a+1)/2 multiply-adds taken as a multiply and an add under -fmad=false,
# and the IEEE divides per path.  Every path draws a Philox block and a
# Box-Muller pair per asset and two dates, and takes an expf per asset and
# date.
MW_OPS = {"basket_asian_am": (6, 1, 0, 2, 1, 1, 1),
          "basket_barrier_am": (6, 3, 0, 3, 1, 1, 0),
          "basket_asian_packed": (6, 1, 0, 2, 1, 1, 1),
          "basket_barrier_packed": (6, 3, 0, 3, 1, 1, 0),
          "basket_asian_greeks_am": (12, 5, 5, 9, None, 1, 0),
          "basket_asian_greeks_packed": (12, 3, 11, 9, 2, 1, 0),
          "basket_barrier_greeks_am": (12, 3, 7, 6, None, 2, 0),
          "basket_barrier_greeks_packed": (11, 3, 13, 6, 2, 2, 0)}


def mw_work(kname: str, plan, a: int, steps: int):
    """Instruction counts of a multi-asset walk kernel's run over ``a``
    assets and ``steps`` dates (a Greek kernel has 2 + 2a outputs)."""
    f_as, f_s, f_ap, f_p, outs, prods, divs = MW_OPS[kname]
    outs = 2 + 2 * a if outs is None else outs
    p, u = plan.total_paths, plan.total_units
    per_date = a * f_as + f_s + prods * a * (a + 1)
    return work(draws=p * a * 2 * -(-steps // 2), expf=p * a * steps,
                div=p * divs,
                f32=p * (steps * per_date + a * f_ap + f_p) + u * 3 * outs)


# The rainbow kernels (K36-K38), counted from csrc/rainbow.cu: float32
# operations per asset and path beyond L z (the signed bt, the exponent, the
# spot, the arg-extreme's compare and select; K38's masked delta, vega and
# theta integrands), per path (the payoff; K38's indicator, theta and its
# IEEE divide by t) and per estimator unit (the (x, x^2) sums, K38's rho);
# L z per path is a(a+1)/2 multiplies and a(a-1)/2 adds in K36 and K38
# (each row from its first product), a(a+1) in K37 (each row from 0).  An
# expf per asset and path; a normal per asset and unit.
RB_OPS = {"rainbow_am": (6, 2, 3, 0), "rainbow_packed": (5, 2, 3, 0),
          "rainbow_greeks": (17, 7, None, 1)}


def rb_work(kname: str, plan, a: int):
    """Instruction counts of a rainbow kernel's run over ``a`` assets (K38
    sums 3 + 2a (x, x^2) outputs and rho's product per unit)."""
    f_a, f_p, f_u, divs = RB_OPS[kname]
    f_u = 1 + 3 * (3 + 2 * a) if f_u is None else f_u
    lz = a * (a + 1) if kname == "rainbow_packed" else a * a
    p, u = plan.total_paths, plan.total_units
    return work(draws=u * a, expf=p * a, div=p * divs,
                f32=p * (lz + f_a * a + f_p) + u * f_u)


# The netting-set CVA and xVA kernels (K39-K44), counted from
# csrc/cva_multi.cu: float32 operations per underlying and node beyond the
# correlation product (the log-spot step, d1 and d2, the two Hastings CDFs'
# polynomials at about 8 each, the leg's value and the net; the Greek
# kernels' tangent, integrands and their two accumulators, the density),
# per path and node (the positive part, the default leg's multiply-add and
# the profile's share of a warp's shuffle tree; K42's and K41's indicator
# and credit accumulator; K43's negative part and four legs, two profiles;
# K44's side-selected weight, four legs and three sensitivities), expf
# (logf counted with them) and IEEE divides per underlying and node (the
# spot and the two CDFs; 1 / sq, or K39's s / k and / sq and its logf),
# and the outputs per estimator unit (K43: 4; K42, K41: 2 + 2m; K44: 7 +
# 2m; each a plain add of x and of x^2).  L z per node is m^2 operations
# from the first product (K40, K42, K43, K44 and their runtime-m kernels),
# m(m + 1) from 0 (K39, K41).  Every path draws a normal per underlying
# and node, in pairs of nodes.
CVA_OPS = {"cva_multi_am": (35, 3, 3, 3, 1),
           "cva_multi_packed": (29, 3, 4, 4, 1),
           "cva_multi_greeks_am": (50, 6, 3, 3, None),
           "cva_multi_greeks_packed": (50, 6, 3, 3, None),
           "xva_am": (35, 12, 3, 3, 4),
           "xva_wide": (35, 12, 3, 3, 4),
           "xva_greeks_am": (50, 20, 3, 3, "xva"),
           "xva_greeks_wide": (50, 20, 3, 3, "xva")}


def cva_work(kname: str, plan, m: int, nodes: int):
    """Instruction counts of a netting-set CVA or xVA kernel's run over
    ``m`` underlyings and ``nodes`` exposure nodes."""
    f_un, f_n, e_un, d_un, outs = CVA_OPS[kname]
    if outs is None or outs == "xva":
        outs = (2 if outs is None else 7) + 2 * m
    from_zero = kname in ("cva_multi_packed", "cva_multi_greeks_packed")
    lz = m * (m + 1) if from_zero else m * m
    p, u = plan.total_paths, plan.total_units
    return work(draws=p * m * 2 * -(-nodes // 2), expf=p * m * nodes * e_un,
                div=p * m * nodes * d_un,
                f32=p * nodes * (m * f_un + f_n + lz) + u * 3 * outs)


# The control variates (K45-K48), counted from csrc/varred.cu: their
# parents' (K1, K9, K2, K3) draws, expf and payoffs, the control being the
# value the payoff forms (S_T, the basket) but for K46's geometric payoff
# (a log-sum add per date; an expf, a multiply, a subtract and a max per
# path, and no divide); a unit's five centered moments take 11 float32
# operations (cc, d, five adds, three products), as K1's compensated pair.
def cv_work(kname: str, plan, a: int = 1, steps: int = 1):
    """Instruction counts of a control-variate kernel's run over ``a``
    assets (K47, K48) or ``steps`` dates (K46)."""
    p, u = plan.total_paths, plan.total_units
    if kname == "asian_cv":
        return walk_work(kname, plan, steps)
    if kname == "vanilla_cv":
        return work(draws=p, expf=p, f32=6 * p + 11 * u)
    return work(draws=p * a, expf=p * a,
                f32=p * (a * (a + 1) / 2 + 4 * a + 3) + 11 * u)


# K49, counted from csrc/varred.cu: K1's draw per path, two expf (the spot
# and the likelihood ratio), 9 float32 operations per path (the tilt, the
# ratio's exponent, the spot, the weighted payoff) and Acc2's compensated
# pair per unit.
def is_work(plan):
    p, u = plan.total_paths, plan.total_units
    return work(draws=p, expf=2 * p, f32=9 * p + 11 * u)


# The RQMC nets (K52-K55), counted from csrc/rqmc.cu: per point and dim the
# Sobol coordinate's XOR and the uniform's shift and OR (int32), and the
# normal quantile's float32 operations (the clip's two, 2u - 1, 4u(1 - u),
# the compare w < 5, w - 2.5, the central 8-step Horner polynomial, the two
# products; 28 with the uniform's subtract) beside logf (counted as an
# expf); the tail polynomial (sqrtf, sqrt(w) - 3 and 8 steps: 17 and a
# sqrtf) only for the points with w >= 5, a share RQMC_TAIL of each dim's
# coordinates (the net stratifies every dim, so a run's count is this share
# to a point a stratum), however many warps the kernel runs it in.  Per
# point: K52's spot, payoff and sums (8, an expf); K53's spot, the seven
# integrands and the 16 sums (66, an expf and a divide); K54's L z (a(a +
# 1)/2 multiply-adds, each one FFMA), 5 a further and an expf per asset, the
# payoff and sums (5); K55's bridge step (5) and date's log-spot (3) per
# date, the tree's m - 1 adds, the average, payoff and sums (6), an expf
# per date (arithmetic) or one (geometric).
RQMC_TAIL = 1.0 - math.sqrt(1.0 - math.exp(-5.0))  # P(-log(4u(1 - u)) >= 5)


def rqmc_work(kname: str, plan, dims: int = 1, geometric: bool = False):
    p = plan.total_paths
    pd = p * dims
    int32 = 3 * pd
    f32 = (28 + 17 * RQMC_TAIL) * pd
    expf, div = pd, 0.0  # the logf of every point-dim
    if kname == "rqmc_vanilla":
        f32, expf = f32 + 8 * p, expf + p
    elif kname == "rqmc_greeks":
        f32, expf, div = f32 + 66 * p, expf + p, p
    elif kname == "rqmc_basket":
        f32 += p * (dims * (dims + 1) / 2 + 5 * dims + 5)
        expf += pd
    else:
        f32 += pd * 9 + 5 * p
        expf += p if geometric else pd
    ops = work(expf=expf, div=div, f32=f32, sqrt=RQMC_TAIL * pd)
    return (ops[0] + int32, ops[1], ops[2])


def bound(ops, nbytes):
    """``(bound_ms, bound_by, class)``: the larger of the instruction time
    of the slowest class and the byte time (each input read once, each
    output written once)."""
    times = {c: n / PEAK_OPS[c] for c, n in zip(PEAK_OPS, ops)}
    cls = max(times, key=times.get)
    t_bytes = nbytes / PEAK_BYTES
    if t_bytes > times[cls]:
        return t_bytes * 1e3, "bytes", "bytes"
    return times[cls] * 1e3, "operations", cls


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


def close_moments(got, want, units: int, rtol: float, what: str) -> float:
    """Assert the control variates' ``(sum d, sum d^2, sum cc, sum cc^2,
    sum d cc)`` rows match: the first four as (sum x, sum x^2) pairs by
    :func:`close_pairs`, ``sum d cc`` within ``rtol * sqrt(sum d^2 sum
    cc^2)``.  Returns the largest error / bound."""
    worst = close_pairs(got[:, :4], want[:, :4], units, rtol, what)
    got, want = got.double(), want.double()
    err = (got[:, 4] - want[:, 4]).abs()
    bound = rtol * torch.sqrt((want[:, 1] * want[:, 3]).abs())
    check(bool((err <= bound).all()),
          f"{what}: sum d cc beyond rtol {rtol} * sqrt(sum d^2 sum cc^2): "
          f"max abs err {float(err.max()):.3e}")
    return max(worst, float((err / bound.clamp(min=1e-300)).max()))


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


def walk_args(kmod, opt) -> tuple:
    """The trailing arguments of a single-asset walk kernel's wrappers:
    the step count and, but for the cliquet, the static variant."""
    name = type(opt).__name__
    if name == "CliquetOption":
        return (opt.n_periods,)
    if name == "LookbackOption":
        return opt.n_obs, kmod.mode_of(opt)
    if name == "AsianOption":
        return opt.n_obs, opt.average == "geometric"
    return opt.n_obs, opt.kind == "up-and-out"


def walk_launchers(kmod, opt, greek: bool, dev):
    """Bound ``(kernel, plain)`` callables ``(block_offset, n_blocks,
    plan)`` of a single-asset walk kernel (``kmod`` is
    ``mctpu_torch.kernels.asian``, ``.barrier``, ``.lookback`` or
    ``.cliquet``) on ``opt``: the Greeks kernel if ``greek``, on scalars
    formed on ``dev``."""
    args = walk_args(kmod, opt)
    if greek:
        par = kmod.greek_params(opt, dev)
        fn, plain = kmod.greek_partials, kmod.greek_plain_partials
    else:
        par = kmod.params(opt, dev)
        fn, plain = kmod.partials, kmod.plain_partials
    return tuple(
        (lambda off, n, plan, f=f: f(par, SEED, off, plan, n, *args))
        for f in (fn, plain))


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


def exotic_path(mt, mcmath) -> None:
    """The Asian and knock-out barrier path at full width (n_obs=50, 2^22
    paths, the default EngineConfig: 128 blocks x 256 rows x 1 iteration)
    through ``price_asian``, ``price_barrier`` and ``mctpu_torch.greeks``,
    each output against its oracle."""
    from mctpu_torch.types import AsianOption, BarrierOption

    n = 1 << 22
    s, k, r, v, t = 100.0, 100.0, 0.05, 0.2, 1.0
    bs = float(mcmath.bs_call(s, k, r, v, t))
    ari = AsianOption(s, k, r, v, t, n_obs=50)
    geo = dataclasses.replace(ari, average="geometric")
    uo = BarrierOption(s, k, r, v, t, barrier=130.0, n_obs=50)

    def same_price(got, want, rtol, what):
        got, want = float(got), float(want)
        check(abs(got - want) <= rtol * abs(want),
              f"{what}: Greeks price {got:.7f} vs pricer {want:.7f} "
              f"(rtol {rtol:.1e})")
        return abs(got / want - 1)

    # Prices (K9, K12).
    pg = mt.price_asian(geo, n, SEED)
    cf = float(mcmath.geometric_asian_call(s, k, r, v, t, 50))
    zg = within_sigma(pg.price, cf, pg.std_error, "Asian geometric")
    pa = mt.price_asian(ari, n, SEED)
    # AM >= GM path by path, so the arithmetic payoffs dominate.
    check(float(pa.price) >= float(pg.price),
          f"Asian arithmetic {float(pa.price):.6f} below geometric "
          f"{float(pg.price):.6f} at the same seed")
    p1 = mt.price_asian(dataclasses.replace(ari, n_obs=1), n, SEED)
    z1 = within_sigma(p1.price, bs, p1.std_error, "Asian n_obs=1")
    phase("exotic-path", f"Asian 2^22 n_obs=50 (K9): geometric "
                         f"{float(pg.price):.6f} (closed form {cf:.6f}, "
                         f"z={zg:.2f}); arithmetic {float(pa.price):.6f} >= "
                         f"geometric; n_obs=1 {float(p1.price):.6f} (BS, "
                         f"z={z1:.2f})")
    pb = mt.price_barrier(uo, n, SEED)
    b_eff = mcmath.barrier_continuity_correction(130.0, s, v, t, 50, up=True)
    want = float(mcmath.up_and_out_call(s, k, r, v, t, b_eff))
    se = float(pb.std_error)
    # BGK is O(1/sqrt(n_obs)) accurate: MC error plus 1% correction bias.
    check(abs(float(pb.price) - want) < 3 * se + 0.01 * want,
          f"up-and-out {float(pb.price):.6f} vs BGK {want:.6f} (se {se:.2e})")
    pd = mt.price_barrier(BarrierOption(s, k, r, v, t, barrier=1.0, n_obs=50,
                                        kind="down-and-out"), n, SEED)
    zd = within_sigma(pd.price, bs, pd.std_error, "down-and-out H=1")
    phase("exotic-path", f"barrier 2^22 n_obs=50 (K12): up-and-out H=130 "
                         f"{float(pb.price):.6f} (BGK {want:.6f}, "
                         f"{abs(float(pb.price) - want) / se:.2f} se); "
                         f"down-and-out H=1 {float(pd.price):.6f} (BS, "
                         f"z={zd:.2f})")

    # Asian Greeks (K10).  Geometric: autograd of the exact closed form.
    gg = mt.greeks(geo, n, SEED)
    sv, vv, rv = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
                  for x in (s, v, r))
    price = mcmath.geometric_asian_call(sv, k, rv, vv, t, 50)
    d_s, d_v, d_r = torch.autograd.grad(price, (sv, vv, rv),
                                        create_graph=True)
    (gam,) = torch.autograd.grad(d_s, sv)
    zs = {f: within_sigma(getattr(gg, f).price, float(w.detach()),
                          getattr(gg, f).std_error, f"Asian geometric {f}")
          for f, w in (("delta", d_s), ("vega", d_v), ("rho", d_r),
                       ("gamma", gam))}
    # The Greeks walk forms the average as acc * f32(1/n), the pricer as
    # acc / n: f32(1/50) is 2.2e-8 low, which the geometric average takes
    # on a log-average of size ln s0 before exp; hence 1e-6 * ln s0 there.
    rel_g = same_price(gg.price.price, pg.price, 1e-6 * math.log(s),
                       "Asian geometric")
    phase("exotic-path", "Asian geometric Greeks 2^22 (K10) vs autograd of "
          "the closed form: z " + ", ".join(f"{f}={z:.2f}"
                                           for f, z in zs.items())
          + f"; price vs price_asian rel {rel_g:.1e}")

    def crn_fd(value, x0, h, seeds=1):
        """Mean over ``seeds`` seeds of the CRN central difference of
        ``value(x, seed)`` at ``x0 +- h``, and its standard error (0 for
        one seed)."""
        fds = [(value(x0 + h, sd) - value(x0 - h, sd)) / (2 * h)
               for sd in range(SEED, SEED + seeds)]
        if seeds == 1:
            return fds[0], 0.0
        return statistics.mean(fds), statistics.stdev(fds) / math.sqrt(seeds)

    def bumped(pricer, opt, field, out=lambda res: res.price):
        return lambda x, sd: float(out(pricer(
            dataclasses.replace(opt, **{field: x}), n, sd)))

    def gates(res, fd, what):
        return {f: crn_gate(getattr(res, f).price,
                            math.hypot(float(getattr(res, f).std_error),
                                       se_fd), w, f"{what} {f}")
                for f, (w, se_fd) in fd.items()}

    # Arithmetic: CRN bumps of price_asian.  The float32 walk adds the
    # drift (~6e-4) to a log-spot near ln 100, which lies on the 2^-21
    # grid, so the sum rounds the drift to that grid and the price moves
    # with r in steps: at h=2e-3 the bump reads the drift's share of rho
    # 0.14% high (+0.04 here, every run), which the gate's 0.5% covers; the
    # pathwise rho follows a float64 walk.  Gamma: the CRN
    # difference of the Greeks' delta at s0 +- 1.  That delta jumps where a
    # path's average crosses the strike, so the difference has noise of
    # its own, about twice the Stein gamma's per path: it is averaged over
    # 16 seeds, and its standard error joins the gate's.
    ga = mt.greeks(ari, n, SEED)
    fd = {"delta": crn_fd(bumped(mt.price_asian, ari, "s"), s, 0.5),
          "vega": crn_fd(bumped(mt.price_asian, ari, "v"), v, 5e-3),
          "rho": crn_fd(bumped(mt.price_asian, ari, "r"), r, 2e-3),
          "gamma": crn_fd(bumped(mt.greeks, ari, "s",
                                 out=lambda g: g.delta.price), s, 1.0, 16)}
    zs = gates(ga, fd, "Asian arithmetic")
    rel_a = same_price(ga.price.price, pa.price, 1e-6, "Asian arithmetic")
    phase("exotic-path", "Asian arithmetic Greeks 2^22 (K10) vs CRN bumps: "
          + ", ".join(f"{f} |z|={z:.2f}" for f, z in zs.items())
          + f"; price vs price_asian rel {rel_a:.1e}")

    # Barrier Greeks (K13): CRN bumps of price_barrier.  A bump flips the
    # knock-out of the paths that graze the barrier, so the difference has
    # noise of its own, at rho some 25x the LR estimator's per path: each
    # is averaged over 16 seeds.
    gb = mt.greeks(uo, n, SEED)
    fd = {"delta": crn_fd(bumped(mt.price_barrier, uo, "s"), s, 0.5, 16),
          "vega": crn_fd(bumped(mt.price_barrier, uo, "v"), v, 5e-3, 16),
          "rho": crn_fd(bumped(mt.price_barrier, uo, "r"), r, 4e-3, 16)}
    zs = gates(gb, fd, "up-and-out")
    # The same per-path payoffs, summed in another order.
    rel_b = same_price(gb.price.price, pb.price, 1e-6, "up-and-out")
    phase("exotic-path", "up-and-out LR Greeks 2^22 (K13) vs CRN bumps: "
          + ", ".join(f"{f} |z|={z:.2f}" for f, z in zs.items())
          + f"; price vs price_barrier rel {rel_b:.1e}")


def lookback_oracle(opt, n_paths: int, seed: int):
    """``(price, std_error)`` of a lookback option from a float64 NumPy walk
    with its own generator (the JAX package's ``reference.price_lookback``,
    copied so that this script imports nothing of it)."""
    rng = np.random.default_rng(seed)
    s0, r, v, t = (float(x) for x in (opt.s, opt.r, opt.v, opt.t))
    k, g = float(opt.k), int(opt.n_obs)
    dt = t / g
    drift = (r - 0.5 * v * v) * dt
    vol = v * np.sqrt(dt)
    s = np.full(n_paths, s0)
    ext = np.full(n_paths, s0)
    use_min = (opt.kind == "floating") != (opt.payoff == "put")
    for _ in range(g):
        s = s * np.exp(drift + vol * rng.standard_normal(n_paths))
        ext = np.minimum(ext, s) if use_min else np.maximum(ext, s)
    if opt.kind == "floating":
        pay = (ext - s) if opt.payoff == "put" else (s - ext)
    elif opt.payoff == "put":
        pay = np.maximum(k - ext, 0.0)
    else:
        pay = np.maximum(ext - k, 0.0)
    disc = math.exp(-r * t)
    return disc * pay.mean(), disc * pay.std(ddof=1) / math.sqrt(n_paths)


def lookback_cliquet_path(mt, mcmath) -> None:
    """The lookback and cliquet path at full width through
    ``price_lookback``, ``price_cliquet`` and ``mctpu_torch.greeks`` with the
    default EngineConfig: lookbacks at n_obs=50 and 2^22 paths (128 blocks
    x 256 rows), cliquets at 12 periods and 2^24 paths (512 blocks x 256
    rows, the whole grid), each output against its oracle."""
    from mctpu_torch.types import CliquetOption, LookbackOption

    n = 1 << 22
    s, r, v, t = 100.0, 0.05, 0.2, 1.0
    fl = LookbackOption(s, r, v, t, n_obs=50)
    gsg = float(mcmath.lookback_floating_call(s, r, v, t))

    def same_price(got, want, what):
        got, want = float(got), float(want)
        check(abs(got - want) <= 1e-6 * abs(want),
              f"{what}: Greeks price {got:.7f} vs pricer {want:.7f}")
        return abs(got / want - 1)

    # Prices (K15) against the float64 oracle, its own 2^21 paths.
    zs = {}
    for label, opt in (("floating call", fl),
                       ("floating put", dataclasses.replace(fl,
                                                            payoff="put")),
                       ("fixed put k=100", dataclasses.replace(
                           fl, kind="fixed", payoff="put", k=100.0))):
        res = mt.price_lookback(opt, n, SEED)
        want, se_o = lookback_oracle(opt, 1 << 21, SEED)
        zs[label] = within_sigma(res.price, want,
                                 math.hypot(float(res.std_error), se_o),
                                 f"lookback {label} vs oracle")
        if opt is fl:
            pf = float(res.price)
    check(pf < gsg, f"floating call {pf:.6f} not below GSG {gsg:.6f}")
    sweep = [float(mt.price_lookback(dataclasses.replace(fl, n_obs=m), n,
                                     SEED).price) for m in (12, 50, 250)]
    check(sweep[0] < sweep[1] < sweep[2] < gsg,
          f"floating call over n_obs 12/50/250 {sweep} not rising below "
          f"GSG {gsg:.6f}")
    fc = mt.price_lookback(dataclasses.replace(fl, kind="fixed", k=100.0), n,
                           SEED)
    bs = float(mcmath.bs_call(s, 100.0, r, v, t))
    check(float(fc.price) > bs + 3 * float(fc.std_error),
          f"fixed call k=100 {float(fc.price):.6f} not above BS {bs:.6f} + "
          "3 se")
    phase("lookback-path", "lookback 2^22 n_obs=50 (K15) vs float64 oracle: "
          + ", ".join(f"{k} z={z:.2f}" for k, z in zs.items())
          + f"; floating call {pf:.6f} < GSG {gsg:.6f}; n_obs 12/50/250 "
          f"{sweep[0]:.4f} < {sweep[1]:.4f} < {sweep[2]:.4f}; fixed call "
          f"{float(fc.price):.6f} > BS {bs:.6f}")

    # Greeks (K16) at v=0.25: homogeneity, CRN equality with the pricer,
    # and CRN bumps of price_lookback (fixed strikes off the atom at s0).
    vg = 0.25
    for n_obs in (16, 50):
        base = LookbackOption(s, r, vg, t, n_obs=n_obs)
        g = mt.greeks(base, n, SEED)
        ratio = float(g.delta.price) / (float(g.price.price) / s)
        check(abs(ratio - 1) <= 1e-5,
              f"floating delta {float(g.delta.price):.7f} vs price / s0 at "
              f"n_obs={n_obs}")
        rel = same_price(g.price.price, mt.price_lookback(base, n,
                                                          SEED).price,
                         f"lookback n_obs={n_obs}")
        phase("lookback-path", f"floating call Greeks n_obs={n_obs} (K16): "
              f"delta / (price / s0) - 1 = {ratio - 1:.1e}; price vs "
              f"price_lookback rel {rel:.1e}")

    def fd(opt, field, h):
        def price(x):
            return float(mt.price_lookback(
                dataclasses.replace(opt, **{field: x}), n, SEED).price)

        x0 = getattr(opt, field)
        return (price(x0 + h) - price(x0 - h)) / (2 * h)

    modes = (("floating call", "floating", "call", 0.0),
             ("floating put", "floating", "put", 0.0),
             ("fixed call k=105", "fixed", "call", 105.0),
             ("fixed put k=95", "fixed", "put", 95.0))
    for label, kind, payoff, k in modes:
        opt = LookbackOption(s, r, vg, t, k=k, n_obs=16, kind=kind,
                             payoff=payoff)
        g = mt.greeks(opt, n, SEED)
        same_price(g.price.price, mt.price_lookback(opt, n, SEED).price,
                   f"lookback {label}")
        gz = {"rho": crn_gate(g.rho.price, g.rho.std_error,
                              fd(opt, "r", 1e-3), f"lookback {label} rho")}
        if kind == "fixed":
            for f, h in (("delta", ("s", 0.5)), ("vega", ("v", 5e-3))):
                gz[f] = crn_gate(getattr(g, f).price,
                                 getattr(g, f).std_error, fd(opt, *h),
                                 f"lookback {label} {f}")
        phase("lookback-path", f"{label} Greeks n_obs=16 2^22 (K16) vs CRN "
              "bumps: " + ", ".join(f"{f} |z|={z:.2f}"
                                    for f, z in gz.items()))

    # Cliquet prices (K17) against the exact closed form.
    nc = 1 << 24
    cq = CliquetOption(100.0, 0.03, 0.2, 1.0, n_periods=12, cap=0.05,
                       floor=-0.02)

    def closed(opt):
        return float(mcmath.cliquet_closed_form(opt.r, opt.v, opt.t,
                                                opt.n_periods, opt.cap,
                                                opt.floor))

    cf = closed(cq)
    pc = mt.price_cliquet(cq, nc, SEED)
    z0 = within_sigma(pc.price, cf, pc.std_error, "cliquet")
    pa = mt.price_cliquet(cq, nc, SEED, mt.EngineConfig(antithetic=True))
    za = within_sigma(pa.price, cf, pa.std_error, "cliquet antithetic")
    zs = []
    for n_p, cap, floor in ((1, 0.10, -0.10), (4, 0.03, 0.0),
                            (52, 0.02, -0.01)):
        o = dataclasses.replace(cq, n_periods=n_p, cap=cap, floor=floor)
        res = mt.price_cliquet(o, n, SEED)
        zs.append(within_sigma(res.price, closed(o), res.std_error,
                               f"cliquet n={n_p} cap={cap} floor={floor}"))
    tight = mt.price_cliquet(dataclasses.replace(cq, cap=0.02 + 1e-6,
                                                 floor=0.02), nc, SEED)
    pin = math.exp(-0.03) * 12 * 0.02
    check(abs(float(tight.price) / pin - 1) <= 1e-4,
          f"cliquet tight band {float(tight.price):.7f} vs {pin:.7f}")
    phase("cliquet-path", f"cliquet 2^24 n=12 (K17): {float(pc.price):.6f} "
          f"(closed form {cf:.6f}, z={z0:.2f}); antithetic z={za:.2f}; "
          f"sweep at 2^22 max |z| {max(zs):.2f}; tight band "
          f"{float(tight.price):.7f} vs e^-rT 12 floor {pin:.7f}")

    # Cliquet Greeks (K18) against autograd of the closed form.
    g = mt.greeks(cq, nc, SEED)
    xs = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
          for x in (cq.v, cq.r, cq.t)]
    vv, rr, tt = xs
    grads = torch.autograd.grad(mcmath.cliquet_closed_form(
        rr, vv, tt, 12, cq.cap, cq.floor), xs)
    zs = {f: within_sigma(getattr(g, f).price, float(w),
                          getattr(g, f).std_error, f"cliquet {f}")
          for f, w in zip(("vega", "rho", "theta"), grads)}
    for f in ("delta", "gamma"):
        res = getattr(g, f)
        check(float(res.price) == 0.0 and float(res.std_error) == 0.0,
              f"cliquet {f} is not an exact 0 +- 0")
    rel = same_price(g.price.price, pc.price, "cliquet")
    phase("cliquet-path", "cliquet Greeks 2^24 (K18) vs autograd of the "
          "closed form: z " + ", ".join(f"{f}={z:.2f}" for f, z in zs.items())
          + f"; delta and gamma exact 0 +- 0; price vs price_cliquet rel "
          f"{rel:.1e}")


def bs_book(mcmath, book):
    """``{field: (M,) float64}``: Black-Scholes price and Greeks of every
    instrument of ``book``, the puts' by put-call parity."""
    s, k, r, v, t = (torch.as_tensor(np.asarray(x, np.float64))
                     for x in (book.s, book.k, book.r, book.v, book.t))
    cf = mcmath.bs_greeks(s, k, r, v, t)
    put = torch.tensor([kd == "put" for kd in book.kinds])
    disc = torch.exp(-r * t)
    parity = {"price": cf["price"] - s + k * disc, "delta": cf["delta"] - 1,
              "rho": cf["rho"] - k * t * disc,
              "theta": cf["theta"] - r * k * disc}
    return {f: torch.where(put, parity[f], cf[f]) if f in parity else cf[f]
            for f in ("price", "delta", "vega", "rho", "theta", "gamma")}


def sigma_gate(res, want, n_sigma: float, what: str) -> float:
    """Assert every entry of the vector ``res`` lies within ``n_sigma``
    standard errors of ``want``; returns the largest distance."""
    got, se = res.price.double(), res.std_error.double().clamp(min=1e-12)
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: shape {tuple(got.shape)} or non-finite values")
    z = (got - want).abs() / se
    i = int(z.argmax())
    check(float(z[i]) < n_sigma,
          f"{what}[{i}]: {float(got[i]):.6f} vs {float(want[i]):.6f} is "
          f"{float(z[i]):.2f} standard errors away (gate {n_sigma})")
    return float(z[i])


def book_path(mt, mcmath) -> None:
    """The strike ladder and the vanilla book at full width (64 strikes, 64
    instruments, 2^24 paths, the default EngineConfig: 256 blocks x 256 rows
    x 1 iteration) through ``price_vanilla_ladder``,
    ``greeks_vanilla_ladder``, ``price_book`` and ``greeks_book``, each
    output against Black-Scholes, and the one-strike and one-instrument
    ties against ``price_vanilla`` (K1)."""
    from mctpu_torch import _build
    from mctpu_torch.types import VanillaBook, VanillaOption

    n = 1 << 24
    s, r, v, t = 100.0, 0.048790, 0.2, 1.0
    call = VanillaOption(s, 100.0, r, v, t)
    put = VanillaOption(s, 100.0, r, v, t, kind="put")
    ks = np.linspace(50.0, 150.0, 64)
    fields = ("price", "delta", "vega", "rho", "theta", "gamma")

    # Ladder (K21): 64 strikes at 4.5 sigma (64 tests); the reference's
    # own chip gate at its 5 strikes: 4 sigma and convex.
    lad = mt.price_vanilla_ladder(call, ks, n, SEED)
    z64 = sigma_gate(lad, mcmath.bs_call(s, torch.tensor(ks), r, v, t), 4.5,
                     "ladder 64 strikes")
    k5 = np.array([70.0, 85.0, 100.0, 115.0, 130.0])
    lad5 = mt.price_vanilla_ladder(call, k5, n, SEED)
    z5 = sigma_gate(lad5, mcmath.bs_call(s, torch.tensor(k5), r, v, t), 4.0,
                    "ladder 5 strikes")
    p = lad5.price.double()
    check(bool((p[:-2] - 2 * p[1:-1] + p[2:] >= -1e-6).all()),
          f"ladder 5 strikes not convex: {p.tolist()}")
    check(bool((lad.price.diff() < 0).all()), "ladder prices not falling")
    phase("book-path", f"ladder call 64 strikes 50..150 2^24 (K21): max |z| "
                       f"{z64:.2f} (gate 4.5), falling; 5 strikes 70..130 "
                       f"max |z| {z5:.2f} (gate 4), convex: {lad5!r}")

    # Ladder Greeks (K22): all six outputs at 4.5 sigma; the call delta
    # ladder falls; the reference's 5-strike gate at 4 sigma; a put ladder
    # against put-call parity.
    for label, opt, strikes, gate in (
            ("call 64 strikes", call, ks, 4.5),
            ("call 5 strikes 80..120", call,
             np.array([80.0, 90.0, 100.0, 110.0, 120.0]), 4.0),
            ("put 64 strikes", put, ks, 4.5)):
        g = mt.greeks_vanilla_ladder(opt, strikes, n, SEED)
        want = bs_book(mcmath, VanillaBook.from_options(
            [dataclasses.replace(opt, k=float(k)) for k in strikes]))
        zs = {f: sigma_gate(getattr(g, f), want[f], gate,
                            f"ladder Greeks {label} {f}") for f in fields}
        if opt.kind == "call":
            check(bool((g.delta.price.diff() < 0).all()),
                  f"ladder Greeks {label}: delta ladder not falling")
        phase("book-path", f"ladder Greeks {label} 2^24 (K22) vs BS"
              + (" (put by parity)" if opt.kind == "put" else "")
              + ": max |z| " + ", ".join(f"{f}={z:.2f}"
                                         for f, z in zs.items())
              + (f" (gate {gate}); delta ladder falling"
                 if opt.kind == "call" else f" (gate {gate})"))

    # Book (K23): the 64-instrument serving book at 4.5 sigma; the
    # reference's 4-instrument chip book at 4 sigma.
    book = VanillaBook.serving(64)
    res = mt.price_book(book, n, SEED)
    zb = sigma_gate(res, bs_book(mcmath, book)["price"], 4.5,
                    "book 64 instruments")
    ref4 = VanillaBook.from_options([
        VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0),
        VanillaOption(100.0, 120.0, 0.05, 0.3, 0.5),
        VanillaOption(95.0, 90.0, 0.03, 0.15, 2.0, kind="put"),
        VanillaOption(120.0, 100.0, 0.01, 0.25, 0.25, kind="put")])
    z4 = sigma_gate(mt.price_book(ref4, n, SEED),
                    bs_book(mcmath, ref4)["price"], 4.0, "book 4 instruments")
    phase("book-path", f"book 64 instruments 2^24 (K23) vs BS: max |z| "
                       f"{zb:.2f} (gate 4.5); reference 4-instrument book max "
                       f"|z| {z4:.2f} (gate 4)")

    # The ties: a one-instrument book (K23) and a one-strike ladder (K21)
    # against price_vanilla (K1) at the same seed.
    ties = {}
    for opt in (call, dataclasses.replace(put, k=95.0)):
        van = mt.price_vanilla(opt, n, SEED)
        for label, got in (
                ("K23 M=1", mt.price_book(VanillaBook.from_options([opt]), n,
                                          SEED)),
                ("K21 K=1", mt.price_vanilla_ladder(opt, [opt.k], n, SEED))):
            rel = max(abs(float(getattr(got, f)[0]) / float(getattr(van, f))
                          - 1) for f in ("sum_p", "sum_p2", "price"))
            bitwise = all(float(getattr(got, f)[0]) == float(getattr(van, f))
                          for f in ("sum_p", "sum_p2"))
            check(rel <= 2e-5, f"{label} {opt.kind} vs K1: relative "
                               f"difference {rel:.2e}")
            ties[f"{label} {opt.kind}"] = (rel, bitwise)
    phase("book-path", "ties vs price_vanilla (K1) at 2^24: " + ", ".join(
        f"{k} rel {rel:.2e} {'bitwise' if bw else 'not bitwise'}"
        for k, (rel, bw) in ties.items()))

    # Book Greeks (K24): all six outputs at 4.5 sigma; the reference's
    # 2-instrument gate at 4 sigma.
    g = mt.greeks_book(book, n, SEED)
    want = bs_book(mcmath, book)
    zs = {f: sigma_gate(getattr(g, f), want[f], 4.5, f"book Greeks {f}")
          for f in fields}
    two = VanillaBook.from_options([ref4.option(0), ref4.option(2)])
    want2 = bs_book(mcmath, two)
    g2 = mt.greeks_book(two, n, SEED)
    z2 = max(sigma_gate(getattr(g2, f), want2[f], 4.0,
                        f"book Greeks 2 instruments {f}") for f in fields)
    phase("book-path", "book Greeks 64 instruments 2^24 (K24) vs BS (puts "
          "by parity): max |z| " + ", ".join(f"{f}={z:.2f}"
                                             for f, z in zs.items())
          + f" (gate 4.5); reference 2-instrument book max |z| {z2:.2f}")

    # A market tick reprices through the same compiled library.
    lib, so = _build.library(), _build.build()
    tick = dataclasses.replace(book, s=np.asarray(book.s) * 1.01,
                               v=np.asarray(book.v) * 0.98)
    rt = mt.price_book(tick, n, SEED)
    zt = sigma_gate(rt, bs_book(mcmath, tick)["price"], 4.5, "ticked book")
    check(_build.library() is lib and _build.build() == so,
          "the tick rebuilt the kernel library")
    check(not torch.equal(rt.price, res.price), "the tick moved no price")
    phase("book-path", f"tick (s x 1.01, v x 0.98): repriced through the "
                       f"same library {so.name}, max |z| {zt:.2f}")


def varswap_path(mt) -> None:
    """The variance swap at full width (2^22 paths, the default
    EngineConfig: 128 blocks x 256 rows x 1 iteration) through
    ``fair_variance_strike`` and ``greeks_varswap``, against the exact
    discrete fair strike ``v^2 + mu^2 T / n`` (mu = r - v^2/2) and its
    derivatives: vega ``2 v - 2 v mu T / n``, rho ``2 mu T / n`` and theta
    (d/dT) ``mu^2 / n``."""
    from mctpu_torch.types import VanillaOption

    n = 1 << 22
    r, v, t = 0.05, 0.2, 1.0
    opt = VanillaOption(100.0, 100.0, r, v, t)
    mu = r - 0.5 * v * v
    strikes, zs = {}, {}
    for n_obs in (252, 52, 12):
        res = mt.fair_variance_strike(opt, n, SEED, n_obs=n_obs)
        want = v * v + mu * mu * t / n_obs
        zs[n_obs] = within_sigma(res.price, want, res.std_error,
                                 f"fair strike n_obs={n_obs}")
        strikes[n_obs] = res
    phase("varswap-path", "fair strike 2^22 (K19) vs v^2 + mu^2 T/n: "
          + ", ".join(f"n_obs={k} {float(res.price):.7f} (exact "
                      f"{v * v + mu * mu * t / k:.7f}, z={zs[k]:.2f})"
                      for k, res in strikes.items()))
    for n_obs in (16, 252):
        g = mt.greeks_varswap(opt, n, SEED, n_obs=n_obs)
        want = {"price": v * v + mu * mu * t / n_obs,
                "vega": 2 * v - 2 * v * mu * t / n_obs,
                "rho": 2 * mu * t / n_obs, "theta": mu * mu / n_obs}
        zs = {f: within_sigma(getattr(g, f).price, w, getattr(g, f).std_error,
                              f"varswap n_obs={n_obs} {f}")
              for f, w in want.items()}
        check(float(g.delta.price) == 0.0 and float(g.delta.std_error) == 0.0,
              f"varswap n_obs={n_obs}: delta is not an exact 0 +- 0")
        p = float(mt.fair_variance_strike(opt, n, SEED, n_obs=n_obs).price)
        rel = abs(float(g.price.price) / p - 1)
        # The same per-path realized variances, summed in another order.
        check(rel <= 1e-6, f"varswap n_obs={n_obs}: Greeks price "
                           f"{float(g.price.price):.8f} vs fair strike "
                           f"{p:.8f}")
        phase("varswap-path", f"Greeks n_obs={n_obs} 2^22 (K20) vs the "
              "oracle's derivatives: z " + ", ".join(
                  f"{f}={z:.2f}" for f, z in zs.items())
              + f"; delta exact 0 +- 0; price vs fair strike rel {rel:.1e}")


def barrier_oracle(book, i: int, n_paths: int, seed: int):
    """``(price, std_error)`` of instrument ``i`` of a barrier book from a
    float64 walk over ``torch.randn`` normals of its own generator on the
    card (the discrete walk of ``tests/test_book.py``'s NumPy oracle)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    s0, k, r, v, t, b = (float(np.asarray(x)[i]) for x in
                         (book.s, book.k, book.r, book.v, book.t,
                          book.barrier))
    g = book.n_obs
    dt = t / g
    z = torch.randn((g, n_paths), generator=gen, dtype=torch.float64,
                    device=dev)
    logs = math.log(s0) + torch.cumsum((r - 0.5 * v * v) * dt
                                       + v * math.sqrt(dt) * z, 0)
    up = book.directions[i] == "up-and-out"
    alive = ((logs < math.log(b)) if up else (logs > math.log(b))).all(0)
    st = torch.exp(logs[-1])
    pay = alive * torch.clamp(st - k if book.kinds[i] == "call" else k - st,
                              min=0.0)
    disc = math.exp(-r * t)
    return (disc * float(pay.mean()),
            disc * float(pay.std()) / math.sqrt(n_paths))


def barrier_book_path(mt) -> None:
    """The barrier book at full width (the 32-instrument serving book,
    n_obs=50, 2^22 paths, the default EngineConfig: 128 blocks x 256 rows
    x 1 iteration) through ``price_barrier_book`` and
    ``greeks_barrier_book``: each call against ``price_barrier`` and
    ``greeks_barrier`` of its own option on an independent seed, each put
    against a float64 oracle, a put's delta against a CRN bump; the
    one-instrument tie with ``price_barrier`` (K12); two identical
    instruments; a tick that flips a direction."""
    from mctpu_torch import _build
    from mctpu_torch.types import BarrierBook

    n = 1 << 22
    book = BarrierBook.serving(32)
    calls = [i for i, kd in enumerate(book.kinds) if kd == "call"]
    puts = [i for i, kd in enumerate(book.kinds) if kd == "put"]

    def against_singles(res, bk, single, seed0, what, fields=None):
        """Largest distance, in combined standard errors, of each call's
        estimate from ``single(option, n, seed)`` on its own seed: the
        price, or each of ``fields`` of a Greeks result."""
        worst = 0.0
        for i in calls:
            one = single(bk.option(i), n, seed0 + i)
            pairs = ([(f, getattr(res, f), getattr(one, f)) for f in fields]
                     if fields else [("price", res, one)])
            for f, got, ref in pairs:
                se = math.hypot(float(got.std_error[i]),
                                float(ref.std_error))
                z = abs(float(got.price[i]) - float(ref.price)) / se
                check(z < 4.5, f"{what} instrument {i} {f}: "
                               f"{float(got.price[i]):.6f} vs "
                               f"{float(ref.price):.6f}, {z:.2f} standard "
                               "errors (gate 4.5)")
                worst = max(worst, z)
        return worst

    # Prices (K25): calls against price_barrier (K12), puts against the
    # float64 oracle at 2^20 paths.
    res = mt.price_barrier_book(book, n, SEED)
    check(res.price.shape == (32,) and bool(torch.isfinite(res.price).all()),
          "barrier book: bad result")
    zc = against_singles(res, book, mt.price_barrier, SEED + 1,
                         "barrier book")
    zp = 0.0
    for i in puts:
        want, se_o = barrier_oracle(book, i, 1 << 20, SEED + 100 + i)
        se = math.hypot(float(res.std_error[i]), se_o)
        z = abs(float(res.price[i]) - want) / se
        check(z < 4.5, f"barrier book put {i}: {float(res.price[i]):.6f} vs "
                       f"oracle {want:.6f}, {z:.2f} standard errors")
        zp = max(zp, z)
    phase("barrier-book-path", f"serving book 32 instruments n_obs=50 2^22 "
          f"(K25): {len(calls)} up-and-out calls vs price_barrier (K12) "
          f"on their own seeds, max |z| {zc:.2f}; {len(puts)} down-and-out "
          f"puts vs a float64 oracle at 2^20, max |z| {zp:.2f} (gate 4.5): "
          f"{res!r}")

    # The ties: one instrument against K12 at the same seed; two identical
    # instruments give identical marks.
    uo = book.option(0)
    one = mt.price_barrier_book(BarrierBook.from_options([uo]), n, SEED)
    single = mt.price_barrier(uo, n, SEED)
    rel = max(abs(float(getattr(one, f)[0]) / float(getattr(single, f)) - 1)
              for f in ("sum_p", "sum_p2", "price"))
    bitwise = all(float(getattr(one, f)[0]) == float(getattr(single, f))
                  for f in ("sum_p", "sum_p2"))
    check(rel <= 2e-5, f"M=1 barrier book vs K12: relative difference "
                       f"{rel:.2e}")
    twin = BarrierBook.from_options([uo, uo])
    pt, gt = (mt.price_barrier_book(twin, n, SEED),
              mt.greeks_barrier_book(twin, n, SEED))
    for f, r in (("price", pt), ("greeks price", gt.price),
                 ("delta", gt.delta), ("vega", gt.vega), ("rho", gt.rho)):
        check(torch.equal(r.sum_p[0], r.sum_p[1])
              and torch.equal(r.sum_p2[0], r.sum_p2[1]),
              f"two identical instruments: {f} marks differ")
    phase("barrier-book-path", f"M=1 book vs price_barrier (K12) at 2^22: "
          f"rel {rel:.2e}, {'bitwise' if bitwise else 'not bitwise'}; two "
          "identical instruments: identical price, delta, vega and rho")

    # Greeks (K26): calls against greeks_barrier (K13) on their own seeds;
    # the first put's delta against a CRN bump of price_barrier_book.
    g = mt.greeks_barrier_book(book, n, SEED)
    check(g.theta is None and g.gamma is None, "barrier book: theta/gamma")
    zg = against_singles(g, book, mt.greeks_barrier, SEED + 1,
                         "barrier book Greeks",
                         fields=("price", "delta", "vega", "rho"))
    i = puts[0]

    def priced(x):
        s = np.asarray(book.s, float).copy()
        s[i] = x
        return float(mt.price_barrier_book(dataclasses.replace(book, s=s), n,
                                           SEED).price[i])

    fd = priced(100.5) - priced(99.5)
    got, se = float(g.delta.price[i]), float(g.delta.std_error[i])
    check(abs(got - fd) < 6 * se + 5e-3,
          f"barrier book put {i} delta {got:.6f} vs CRN bump {fd:.6f} (se "
          f"{se:.2e})")
    rel_p = float(((g.price.price / res.price) - 1).abs().max())
    check(rel_p <= 1e-6, f"Greeks prices vs price_barrier_book: rel {rel_p}")
    phase("barrier-book-path", f"Greeks 2^22 (K26) vs greeks_barrier (K13) "
          f"on the calls: max |z| {zg:.2f} (gate 4.5); put {i} delta "
          f"{got:.6f} vs CRN bump {fd:.6f} ({abs(got - fd) / se:.2f} se); "
          f"prices vs price_barrier_book rel {rel_p:.1e}")

    # A tick: spots up 1%, vols down 1%, and instrument 0 turned from
    # up-and-out at 130 to down-and-out at 80, through the same library.
    lib, so = _build.library(), _build.build()
    tick = dataclasses.replace(
        book, s=np.asarray(book.s) * 1.01, v=np.asarray(book.v) * 0.99,
        barrier=np.concatenate([[80.0], np.asarray(book.barrier)[1:]]),
        directions=("down-and-out",) + book.directions[1:])
    rt = mt.price_barrier_book(tick, n, SEED)
    zt = against_singles(rt, tick, mt.price_barrier, SEED + 1,
                         "ticked barrier book")
    check(_build.library() is lib and _build.build() == so,
          "the tick rebuilt the kernel library")
    check(not torch.equal(rt.price, res.price), "the tick moved no price")
    phase("barrier-book-path", f"tick (s x 1.01, v x 0.99, instrument 0 "
          f"down-and-out at 80): repriced through the same library "
          f"{so.name}, calls vs price_barrier max |z| {zt:.2f}")


# tests/test_heston.py's option and its Feller-violating QE option; the
# Greeks option of tests/test_greeks.py (2 kappa theta = 0.36 > xi^2); the
# variance swap's, Feller-satisfied (0.16 > 0.09) with v0 above theta;
# tests/test_mlmc.py's MLMC option.  The reference option is also the JAX
# exotic CLI's --product mlmc at its defaults.
HESTON_OPTS = {
    "opt": (100.0, 100.0, 0.05, 1.0, 0.04, 2.0, 0.04, 0.3, -0.7),
    "steep": (100.0, 100.0, 0.03, 1.0, 0.04, 1.5, 0.04, 0.5, -0.7),
    "gopt": (100.0, 100.0, 0.03, 1.0, 0.09, 2.0, 0.09, 0.4, -0.6),
    "vs": (100.0, 100.0, 0.03, 1.0, 0.09, 2.0, 0.04, 0.3, -0.6),
    "mlmc_test": (100.0, 100.0, 0.03, 1.0, 0.04, 1.5, 0.04, 0.4, -0.6),
}


def heston_path(mt, mcmath) -> None:
    """The Heston slice at full width (2^22 paths, the default EngineConfig:
    128 blocks x 256 rows x 1 iteration): ``price_heston`` (Euler and QE),
    ``mctpu_torch.greeks`` on a ``HestonOption`` and the Heston leg of
    ``fair_variance_strike`` and ``greeks_varswap``, each against its
    oracle."""
    from mctpu_torch.models.heston import cf_call_price
    from mctpu_torch.types import HestonOption

    n = 1 << 22
    opt, steep, gopt, vs = (HestonOption(*HESTON_OPTS[k])
                            for k in ("opt", "steep", "gopt", "vs"))

    # K27: Euler at zero vol-of-vol is the log-Euler walk of GBM, exact.
    flat = dataclasses.replace(opt, xi=0.0)
    res = mt.price_heston(flat, n, SEED)
    bs = float(mcmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    z_bs = within_sigma(res.price, bs, res.std_error, "Heston xi=0 vs BS")
    # Euler (with the scheme's measured bias allowed) and QE at 100 steps,
    # and QE at 16 steps on the Feller-violating option, against the CF.
    cf = cf_call_price(opt)
    eu = mt.price_heston(opt, n, SEED)
    gap = abs(float(eu.price) - cf)
    check(gap < N_SIGMA * float(eu.std_error) + EULER_PRICE_ALLOWANCE,
          f"Heston Euler {float(eu.price):.6f} vs CF {cf:.6f}")
    qe = mt.price_heston(opt, n, SEED, scheme="qe")
    z_qe = within_sigma(qe.price, cf, qe.std_error, "Heston QE vs CF")
    cf_s = cf_call_price(steep)
    qe16 = mt.price_heston(steep, n, SEED, n_steps=16, scheme="qe")
    z_qe16 = within_sigma(qe16.price, cf_s, qe16.std_error,
                          "Heston QE 16 steps vs CF")
    phase("heston-path", f"price 2^22 100 steps (K27): xi=0 Euler "
          f"{float(res.price):.6f} vs BS {bs:.6f} (z={z_bs:.2f}); Euler "
          f"{float(eu.price):.6f} vs CF {cf:.6f} "
          f"({gap / float(eu.std_error):.2f} se, allowance "
          f"{EULER_PRICE_ALLOWANCE}); QE {float(qe.price):.6f} "
          f"(z={z_qe:.2f}); QE 16 steps on the Feller-violating option "
          f"{float(qe16.price):.6f} vs CF {cf_s:.6f} (z={z_qe16:.2f})")

    # K28 through the dispatcher: delta, vega (d/dv0) and rho against
    # central differences of the CF price; dtheta, dkappa and dxi against
    # CRN bumps of price_heston (mctpu's gate: per path the bump is the
    # tangent to O(h)).
    g = mt.greeks(gopt, n, SEED)
    check(type(g).__name__ == "HestonGreeksResult", "greeks: not Heston")
    p = mt.price_heston(gopt, n, SEED)
    rel = abs(float(g.price.price) / float(p.price) - 1)
    # The tangent walk takes (dt / 2) vp where the pricer takes 0.5 vp
    # sqrt(dt)^2: the last ulps of x drift apart.
    check(rel <= 1e-4, f"Heston Greeks price vs price_heston: rel {rel:.2e}")
    msgs = []
    for f, field, h in (("delta", "s", 0.5), ("vega", "v0", 2e-3),
                        ("rho", "r", 2e-3)):
        x0 = getattr(gopt, field)
        fd = (cf_call_price(dataclasses.replace(gopt, **{field: x0 + h}))
              - cf_call_price(dataclasses.replace(gopt, **{field: x0 - h}))
              ) / (2 * h)
        got, se = float(getattr(g, f).price), float(getattr(g, f).std_error)
        check(abs(got - fd) < N_SIGMA * se + EULER_GREEK_ALLOWANCE * abs(fd),
              f"Heston {f} {got:.6f} vs CF difference {fd:.6f} (se "
              f"{se:.2e})")
        msgs.append(f"{f} {got:.5f} vs CF {fd:.5f} ({abs(got - fd) / se:.2f}"
                    " se)")
    for f, field, h in (("dtheta", "theta", 1e-4), ("dkappa", "kappa", 1e-2),
                        ("dxi", "xi", 1e-3)):
        x0 = getattr(gopt, field)
        fd = (float(mt.price_heston(dataclasses.replace(
                  gopt, **{field: x0 + h}), n, SEED).price)
              - float(mt.price_heston(dataclasses.replace(
                  gopt, **{field: x0 - h}), n, SEED).price)) / (2 * h)
        got, se = float(getattr(g, f).price), float(getattr(g, f).std_error)
        check(abs(got - fd) < 0.05 * se + 2e-3 * abs(fd) + 1e-4,
              f"Heston {f} {got:.6f} vs CRN bump {fd:.6f} (se {se:.2e})")
        msgs.append(f"{f} {got:.5f} vs CRN {fd:.5f}")
    phase("heston-path", "Greeks 2^22 100 steps (K28) through "
          f"mctpu_torch.greeks: price vs price_heston rel {rel:.1e}; "
          + "; ".join(msgs))

    # K19/K20, Heston leg: the fair strike at 252 dates against theta +
    # (v0 - theta) a, a = (1 - e^{-kappa T}) / (kappa T), and its gradient.
    kap, t, th, v0 = vs.kappa, vs.t, vs.theta, vs.v0
    a = (1 - math.exp(-kap * t)) / (kap * t)
    want = th + (v0 - th) * a
    fs = mt.fair_variance_strike(vs, n, SEED, n_obs=252)
    check(abs(float(fs.price) - want) < N_SIGMA * float(fs.std_error) + 5e-4,
          f"Heston fair strike {float(fs.price):.7f} vs {want:.7f}")
    gv = mt.greeks_varswap(vs, n, SEED, n_obs=252)
    e_kt = math.exp(-kap * t)
    grad = {"vega": a, "dtheta": 1 - a,
            "dkappa": (v0 - th) * (kap * t * e_kt - (1 - e_kt))
            / (kap * kap * t)}
    zs = {}
    for f, w in grad.items():
        got, se = float(getattr(gv, f).price), float(getattr(gv, f).std_error)
        check(abs(got - w) < N_SIGMA * se + 0.01 * abs(w),
              f"Heston varswap {f} {got:.6f} vs {w:.6f} (se {se:.2e})")
        zs[f] = abs(got - w) / se
    fd = (float(mt.fair_variance_strike(dataclasses.replace(vs, xi=0.301), n,
                                        SEED, n_obs=252).price)
          - float(mt.fair_variance_strike(dataclasses.replace(vs, xi=0.299),
                                          n, SEED, n_obs=252).price)) / 2e-3
    got, se = float(gv.dxi.price), float(gv.dxi.std_error)
    check(abs(got - fd) < 0.05 * se + 2e-3 * abs(fd) + 1e-4,
          f"Heston varswap dxi {got:.7f} vs CRN bump {fd:.7f}")
    check(float(gv.delta.price) == 0.0 and float(gv.delta.std_error) == 0.0,
          "Heston varswap: delta is not an exact 0 +- 0")
    rel_v = abs(float(gv.price.price) / float(fs.price) - 1)
    check(rel_v <= 1e-6, f"Heston varswap Greeks price vs fair strike: rel "
                         f"{rel_v:.2e}")
    phase("heston-path", f"variance swap 2^22 252 dates (K19, K20 Heston "
          f"legs): fair strike {float(fs.price):.7f} vs continuous "
          f"{want:.7f} "
          f"({abs(float(fs.price) - want) / float(fs.std_error):.2f} se, "
          "allowance 5e-4); gradient z " + ", ".join(
              f"{f}={z:.2f}" for f, z in zs.items())
          + f" (allowance 1%); dxi {got:.7f} vs CRN {fd:.7f}; delta exact "
          f"0 +- 0; price vs fair strike rel {rel_v:.1e}")


def multi_walk_path(mt) -> None:
    """The multi-asset walk slice at full width on the JAX CLIs' defaults
    (``--assets 3``; Greeks on ``equicorrelated(3, 0.3)``), the default
    EngineConfig: ``price_basket_asian`` and ``price_basket_barrier`` (K30,
    and K31 at 16 and 100 assets) against the float64 oracle and their
    limits, ``greeks_basket_asian`` (K32) and ``greeks_basket_barrier``
    (K34) against CRN bumps and the single-asset and terminal Greeks."""
    from mctpu_torch.models.basket import (basket_asian_oracle,
                                           basket_barrier_oracle)
    from mctpu_torch.types import (AsianOption, BarrierOption,
                                   BasketAsianOption, BasketBarrierOption,
                                   BasketOption)

    n, n_or = 1 << 22, 1 << 20
    b3 = BasketOption.default_reference(3)
    one = BasketOption(s=[100.0], v=[0.2], w=[1.0], corr=[[1.0]], d=[0.0],
                       k=100.0, r=0.05, t=1.0)

    def tie(res, price, se, what, n_sigma=N_SIGMA):
        """|res - price| within n_sigma combined standard errors."""
        z = abs(float(res.price) - price) / math.hypot(float(res.std_error),
                                                       se)
        check(z < n_sigma, f"{what}: {float(res.price):.6f} vs "
                           f"{price:.6f} ({z:.2f} combined se)")
        return z

    def vs_oracle(opt, n_paths, n_oracle):
        barrier = isinstance(opt, BasketBarrierOption)
        res = (mt.price_basket_barrier if barrier
               else mt.price_basket_asian)(opt, n_paths, SEED)
        oracle = (basket_barrier_oracle if barrier
                  else basket_asian_oracle)(opt, n_oracle, SEED, "cuda")
        return res, oracle, tie(res, *oracle, "oracle")

    # K30, basket-Asian: the oracle, the terminal basket at n_obs = 1 and
    # the single-asset Asian at a = 1.
    ba = BasketAsianOption(b3, n_obs=50)
    res, orc, z_a = vs_oracle(ba, n, n_or)
    r1 = mt.price_basket_asian(BasketAsianOption(b3, n_obs=1), n, SEED)
    pb = mt.price_basket(b3, n, SEED)
    z1 = tie(r1, float(pb.price), float(pb.std_error),
             "basket-Asian n_obs=1 vs price_basket")
    r_one = mt.price_basket_asian(BasketAsianOption(one, n_obs=50), n, SEED)
    pa = mt.price_asian(AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=50),
                        n, SEED)
    z_one = tie(r_one, float(pa.price), float(pa.std_error),
                "basket-Asian a=1 vs price_asian")
    phase("multi-walk-path", f"basket-Asian default_reference(3) 2^22 "
          f"n_obs=50 (K30): {float(res.price):.6f} vs float64 oracle "
          f"{orc[0]:.6f} at 2^20 (z={z_a:.2f}); n_obs=1 "
          f"{float(r1.price):.6f} vs price_basket {float(pb.price):.6f} "
          f"(z={z1:.2f}); a=1 {float(r_one.price):.6f} vs price_asian "
          f"{float(pa.price):.6f} (z={z_one:.2f})")

    # K30, knock-out: up at 130, down at 90, and a barrier out of reach.
    msgs = []
    for kind, h in (("up-and-out", 130.0), ("down-and-out", 90.0)):
        bo = BasketBarrierOption(b3, h, n_obs=50, kind=kind)
        res, orc, z = vs_oracle(bo, n, n_or)
        msgs.append(f"{kind} H={h:g} {float(res.price):.6f} vs oracle "
                    f"{orc[0]:.6f} (z={z:.2f})")
    far = mt.price_basket_barrier(BasketBarrierOption(b3, 1e7, n_obs=50), n,
                                  SEED)
    z_far = tie(far, float(pb.price), float(pb.std_error),
                "basket-barrier H=1e7 vs price_basket")
    phase("multi-walk-path", "basket-barrier default_reference(3) 2^22 "
          "n_obs=50 (K30): " + "; ".join(msgs) + f"; H=1e7 "
          f"{float(far.price):.6f} vs price_basket (z={z_far:.2f})")

    # K31: 16 assets at 50 dates, 100 assets at 12, both products.
    msgs = []
    for a, n_obs, n_paths in ((16, 50, n), (100, 12, 1 << 20)):
        bk = BasketOption.equicorrelated(a)
        for opt in (BasketAsianOption(bk, n_obs=n_obs),
                    BasketBarrierOption(bk, 115.0, n_obs=n_obs)):
            res, orc, z = vs_oracle(opt, n_paths, n_or)
            what = ("Asian" if isinstance(opt, BasketAsianOption)
                    else "up-and-out H=115")
            msgs.append(f"a={a} n_obs={n_obs} {what} {float(res.price):.6f} "
                        f"vs oracle {orc[0]:.6f} (z={z:.2f})")
    phase("multi-walk-path", "packed (K31): " + "; ".join(msgs))

    def crn(pricer, opt, n_paths, field, i, h):
        """CRN central difference of ``pricer`` in ``field`` (asset ``i`` of
        the basket's vector, or the scalar ``r`` when ``i`` is None)."""
        bk = opt.basket

        def price(x):
            if i is None:
                nb = dataclasses.replace(bk, **{field: x})
            else:
                vals = np.asarray(getattr(bk, field), float).copy()
                vals[i] = x
                nb = dataclasses.replace(bk, **{field: vals})
            res = pricer(dataclasses.replace(opt, basket=nb), n_paths, SEED)
            return float(res.price)

        x0 = float(getattr(bk, field) if i is None
                   else np.asarray(getattr(bk, field))[i])
        return (price(x0 + h) - price(x0 - h)) / (2 * h)

    def entries(res):
        """``(price, se)`` of each entry of a scalar or vector result."""
        return list(zip(np.atleast_1d(res.price.numpy()),
                        np.atleast_1d(res.std_error.numpy())))

    def ties(g, want, n_sigma, what):
        """Every output of ``g`` within ``n_sigma`` combined standard errors
        of ``want``'s; returns the largest distance."""
        worst = 0.0
        for f in ("price", "delta", "vega", "rho"):
            for j, ((x, xs), (y, ys)) in enumerate(zip(
                    entries(getattr(g, f)), entries(getattr(want, f)))):
                z = abs(x - y) / math.hypot(xs, ys)
                check(z < n_sigma, f"{what} {f}[{j}]: {x:.6f} vs {y:.6f} "
                                   f"({z:.2f} combined se)")
                worst = max(worst, z)
        return worst

    # K32 on equicorrelated(3, 0.3) at 16 dates: the price is
    # price_basket_asian's bit for bit (at n = 16 the Greek walk's
    # acc * (1/n) is acc / n), the Greeks within 5 se + 0.5% of CRN bumps;
    # at a = 1, greeks_asian's.
    eq3 = BasketOption.equicorrelated(3, 0.3)
    n_g = 1 << 24
    ga = BasketAsianOption(eq3, n_obs=16)
    g = mt.greeks(ga, n_g, SEED)
    p = mt.price_basket_asian(ga, n_g, SEED)
    check(float(g.price.price) == float(p.price),
          f"greeks_basket_asian price {float(g.price.price)!r} is not "
          f"price_basket_asian's {float(p.price)!r}")
    zs = []
    for i in range(3):
        zs.append(crn_gate(g.delta.price[i], g.delta.std_error[i],
                           crn(mt.price_basket_asian, ga, n_g, "s", i, 0.5),
                           f"basket-Asian delta_{i}"))
        zs.append(crn_gate(g.vega.price[i], g.vega.std_error[i],
                           crn(mt.price_basket_asian, ga, n_g, "v", i, 5e-3),
                           f"basket-Asian vega_{i}"))
    zs.append(crn_gate(g.rho.price, g.rho.std_error,
                       crn(mt.price_basket_asian, ga, n_g, "r", None, 2e-3),
                       "basket-Asian rho"))
    z1 = ties(mt.greeks(BasketAsianOption(one, n_obs=16), n_g, SEED),
              mt.greeks(AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=16),
                        n_g, SEED), 5.0, "basket-Asian a=1 vs greeks_asian")
    phase("multi-walk-path", "basket-Asian Greeks equicorrelated(3, 0.3) "
          "2^24 n_obs=16 (K32): price equals price_basket_asian "
          f"({float(p.price):.6f}); delta/vega/rho vs CRN bumps, max "
          f"|z| {max(zs):.2f}; a=1 vs greeks_asian, max z {z1:.2f}")

    # K33 on equicorrelated(16, 0.3) at 12 dates (the JAX Greeks CLI's
    # --product basket-asian --assets 16 at its default --obs), 2^22 paths:
    # the price within RTOL of price_basket_asian's (K31 takes acc / n where
    # K33 takes acc * (1/n)), equal bit for bit at 16 dates; per-asset delta
    # and vega and rho within 5 se + 0.5% of CRN bumps.
    eq16 = BasketOption.equicorrelated(16, 0.3)
    n_p = 1 << 22
    gp = BasketAsianOption(eq16, n_obs=12)
    g = mt.greeks(gp, n_p, SEED)
    p = mt.price_basket_asian(gp, n_p, SEED)
    gap = abs(float(g.price.price) - float(p.price)) / float(p.price)
    check(gap <= RTOL, f"greeks_basket_asian (16 assets) price "
                       f"{float(g.price.price)!r} vs price_basket_asian's "
                       f"{float(p.price)!r}")
    o16 = BasketAsianOption(eq16, n_obs=16)
    g16, p16 = mt.greeks(o16, n_p, SEED), mt.price_basket_asian(o16, n_p, SEED)
    check(float(g16.price.price) == float(p16.price),
          f"greeks_basket_asian (16 assets, 16 dates) price "
          f"{float(g16.price.price)!r} is not price_basket_asian's "
          f"{float(p16.price)!r}")
    zs = []
    for i in range(16):
        zs.append(crn_gate(g.delta.price[i], g.delta.std_error[i],
                           crn(mt.price_basket_asian, gp, n_p, "s", i, 0.5),
                           f"basket-Asian (16) delta_{i}"))
        zs.append(crn_gate(g.vega.price[i], g.vega.std_error[i],
                           crn(mt.price_basket_asian, gp, n_p, "v", i, 5e-3),
                           f"basket-Asian (16) vega_{i}"))
    zs.append(crn_gate(g.rho.price, g.rho.std_error,
                       crn(mt.price_basket_asian, gp, n_p, "r", None, 2e-3),
                       "basket-Asian (16) rho"))
    phase("multi-walk-path", "basket-Asian Greeks equicorrelated(16, 0.3) "
          f"2^22 n_obs=12 (K33): price {float(g.price.price):.6f} vs "
          f"price_basket_asian {float(p.price):.6f} (relative gap "
          f"{gap:.2e}), at n_obs=16 equal bit for bit "
          f"({float(p16.price):.6f}); delta/vega/rho vs CRN bumps, max |z| "
          f"{max(zs):.2f}")

    # K34 on equicorrelated(3, 0.3), H=130, 50 dates: the price is
    # price_basket_barrier's bit for bit, the LR Greeks within
    # tests/test_greeks.py's limits of CRN bumps (6 se + 0.003 delta, 0.3
    # vega and rho: the bumps flip knock-outs), at H=1e5 within 4 combined
    # se of greeks_basket, at a = 1 within 5 of greeks_barrier; a
    # rank-deficient correlation raises.
    n_g = 1 << 23
    gb = BasketBarrierOption(eq3, 130.0, n_obs=50)
    g = mt.greeks(gb, n_g, SEED)
    p = mt.price_basket_barrier(gb, n_g, SEED)
    check(float(g.price.price) == float(p.price),
          f"greeks_basket_barrier price {float(g.price.price)!r} is not "
          f"price_basket_barrier's {float(p.price)!r}")

    def lr_gate(got, se, fd, allow, what):
        got, se = float(got), float(se)
        check(abs(got - fd) < 6 * se + allow,
              f"{what}: {got:.6f} vs CRN bump {fd:.6f} (se {se:.2e})")
        return abs(got - fd) / se

    zs = []
    for i in range(3):
        zs.append(lr_gate(g.delta.price[i], g.delta.std_error[i],
                          crn(mt.price_basket_barrier, gb, n_g, "s", i, 0.25),
                          0.003, f"basket-barrier delta_{i}"))
        zs.append(lr_gate(g.vega.price[i], g.vega.std_error[i],
                          crn(mt.price_basket_barrier, gb, n_g, "v", i, 5e-3),
                          0.3, f"basket-barrier vega_{i}"))
    zs.append(lr_gate(g.rho.price, g.rho.std_error,
                      crn(mt.price_basket_barrier, gb, n_g, "r", None, 1e-2),
                      0.3, "basket-barrier rho"))
    zf = ties(mt.greeks(BasketBarrierOption(eq3, 1e5, n_obs=50), n_g, SEED),
              mt.greeks(eq3, n_g, SEED), N_SIGMA,
              "basket-barrier H=1e5 vs greeks_basket")
    z1 = ties(mt.greeks(BasketBarrierOption(one, 130.0, n_obs=50), n_g,
                        SEED),
              mt.greeks(BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, 130.0,
                                      n_obs=50), n_g, SEED), 5.0,
              "basket-barrier a=1 vs greeks_barrier")
    try:
        mt.greeks(BasketBarrierOption(b3, 130.0, n_obs=50), 1 << 20, SEED)
    except ValueError as err:
        check("rank-deficient" in str(err), f"wrong refusal: {err}")
    else:
        raise AssertionError("greeks_basket_barrier took default_reference(3)")
    phase("multi-walk-path", "basket-barrier LR Greeks equicorrelated(3, "
          "0.3) H=130 2^23 n_obs=50 (K34): price equals "
          f"price_basket_barrier ({float(p.price):.6f}); delta/vega/rho vs "
          f"CRN bumps, max |z| {max(zs):.2f}; H=1e5 vs greeks_basket, max "
          f"z {zf:.2f}; a=1 vs greeks_barrier, max z {z1:.2f}; "
          "default_reference(3) raises ValueError")

    # K35 on equicorrelated(9, 0.3) and (16, 0.3), up-and-out H=130, 50
    # dates (K31's knock-out shape; the JAX Greeks CLI's --product
    # basket-barrier --assets 16 --obs 50), 2^22 paths: the price equal to
    # price_basket_barrier's bit for bit (K31 and K35 take one pass shape
    # at these rows), the LR Greeks within the limits above of CRN bumps.
    msgs = []
    for a in (9, 16):
        gb = BasketBarrierOption(BasketOption.equicorrelated(a, 0.3), 130.0,
                                 n_obs=50)
        g = mt.greeks(gb, n, SEED)
        p = mt.price_basket_barrier(gb, n, SEED)
        check(float(g.price.price) == float(p.price),
              f"greeks_basket_barrier ({a} assets) price "
              f"{float(g.price.price)!r} is not price_basket_barrier's "
              f"{float(p.price)!r}")
        zs = []
        for i in range(a):
            zs.append(lr_gate(g.delta.price[i], g.delta.std_error[i],
                              crn(mt.price_basket_barrier, gb, n, "s", i,
                                  0.25), 0.003, f"K35 a={a} delta_{i}"))
            zs.append(lr_gate(g.vega.price[i], g.vega.std_error[i],
                              crn(mt.price_basket_barrier, gb, n, "v", i,
                                  5e-3), 0.3, f"K35 a={a} vega_{i}"))
        zs.append(lr_gate(g.rho.price, g.rho.std_error,
                          crn(mt.price_basket_barrier, gb, n, "r", None,
                              1e-2), 0.3, f"K35 a={a} rho"))
        msgs.append(f"a={a} price {float(p.price):.6f} equals "
                    f"price_basket_barrier, delta/vega/rho vs CRN bumps max "
                    f"|z| {max(zs):.2f}")
    phase("multi-walk-path", "basket-barrier LR Greeks equicorrelated(a, "
          "0.3) H=130 2^22 n_obs=50 (K35): " + "; ".join(msgs))


def cva_multi_spec(m: int, n_grid: int, mixed: bool = False):
    """A netting set of ``m`` calls at lambda = 0.03, lgd = 0.6, r = 0.05,
    T = 1: the JAX exotic CLI's (``--product cva-multi``: s = k = 100, v =
    0.2, correlation 0.5, w = 1/m), or with ``mixed`` the legs of
    ``tests/test_cva_multi.py``'s mixed-sign pair (s 100/95, v 0.2/0.3, k
    100/90, w 1/-0.6) alternated over the ``m`` underlyings."""
    from mctpu_torch.types import CvaMultiSpec

    corr = np.full((m, m), 0.5) + 0.5 * np.eye(m)
    if not mixed:
        full = np.full(m, 100.0)
        return CvaMultiSpec(0.03, 0.6, full, np.full(m, 0.2), corr, 0.05, 1.0,
                            full, np.full(m, 1.0 / m), n_grid)
    odd = np.arange(m) % 2 == 1
    pick = lambda a, b: np.where(odd, b, a)  # noqa: E731
    return CvaMultiSpec(0.03, 0.6, pick(100.0, 95.0), pick(0.2, 0.3), corr,
                        0.05, 1.0, pick(100.0, 90.0), pick(1.0, -0.6),
                        n_grid)


def cva_greeks_cli_spec(m: int = 3):
    """The JAX Greeks CLI's netting set (``--product cva-multi``,
    ``mctpu/cli/greeks.py:193-204``): ``m`` underlyings (its default 3, or
    ``--assets m``), correlation 0.3 + 0.7 I, s = 100 (1 - 0.05 i), v = 0.2
    (1 + 0.25 i), r = 0.04879, k = 100, w = 1, 12 nodes."""
    i = np.arange(m)
    return dataclasses.replace(
        cva_multi_spec(m, 12), s=100.0 * (1.0 - 0.05 * i),
        v=0.2 * (1.0 + 0.25 * i), r=0.04879,
        corr=np.full((m, m), 0.3) + 0.7 * np.eye(m), weights=np.ones(m))


def xva_spec(net, own: float = 0.02, spread: float = 0.01):
    """The JAX CLIs' bank side of ``--product xva``
    (``mctpu/cli/exotic.py:460-473``, ``mctpu/cli/greeks.py:230-244``) on
    the netting set ``net``: own intensity 0.02 (or ``own``), own lgd 0.5,
    funding spread 0.01 (or ``spread``)."""
    from mctpu_torch.types import XvaSpec

    return XvaSpec(net, own_intensity=own, own_lgd=0.5,
                   funding_spread=spread)


def cva_multi_path(mt, mcmath) -> None:
    """The netting-set CVA slice at full width with the default
    EngineConfig: ``price_cva_multi`` on the JAX exotic CLI's set (K40 at
    3 underlyings, K39 at 16, 2^20 paths, 50 nodes) against the closed form
    and its EE profile node by node against ``e^{r t_j} sum_m w_m C0_m``;
    the mixed-sign sets (2 underlyings, K40; 9, K39) against the float64
    oracle; one underlying against ``price_cva`` (K4); the JAX test's
    9-underlying set and 100 underlyings against the closed form;
    ``greeks_cva_multi`` (K42) on the JAX Greeks CLI's set against autograd
    of the closed form and on the mixed-sign pair against CRN bumps of
    ``price_cva_multi``, its CVA equal to the pricer's bit for bit; 9
    underlyings refused."""
    from mctpu_torch.models.cva_multi import cva_multi_oracle
    from mctpu_torch.types import CvaMultiSpec, CvaSpec, VanillaOption

    n, n_or = 1 << 20, 1 << 20

    def closed(spec):
        return float(mcmath.cva_multi_closed_form(
            spec.intensity, spec.lgd, spec.s, spec.v, spec.strikes,
            spec.weights, spec.r, spec.t, spec.n_grid))

    def tie(res, price, se, what):
        z = abs(float(res.cva) - price) / math.hypot(float(res.std_error), se)
        check(z < N_SIGMA, f"{what}: {float(res.cva):.6f} vs {price:.6f} "
                           f"({z:.2f} combined se)")
        return z

    # K40 and K39 on the CLI's all-long set: the CVA against the closed
    # form, each node of the EE profile against its martingale value within
    # 4 of its standard errors (the exposure's sample deviation per node
    # from the float64 oracle at 2^18 paths, over sqrt(n)).
    msgs = []
    for m in (3, 16):
        spec = cva_multi_spec(m, 50)
        res = mt.price_cva_multi(spec, n, SEED)
        z = within_sigma(res.cva, closed(spec), res.std_error,
                         f"cva_multi m={m}")
        _, _, _, ee_sd = cva_multi_oracle(spec, 1 << 18, SEED + m, "cuda")
        c0 = float(torch.sum(torch.as_tensor(spec.weights) * mcmath.bs_call(
            torch.as_tensor(spec.s), torch.as_tensor(spec.strikes), spec.r,
            torch.as_tensor(spec.v), spec.t)))
        tj = torch.arange(1, 51, dtype=torch.float64) / 50
        ee_want = c0 * torch.exp(spec.r * tj)
        ee = res.expected_exposure
        check(ee.shape == (50,) and bool(torch.isfinite(ee).all()),
              f"cva_multi m={m}: profile shape")
        zee = float(((ee - ee_want).abs() / (ee_sd / math.sqrt(res.n))).max())
        check(zee < N_SIGMA, f"cva_multi m={m}: EE profile {zee:.2f} "
                             "standard errors off its martingale value")
        msgs.append(f"m={m} ({'K40' if m <= 8 else 'K39'}) "
                    f"{float(res.cva):.6f} vs closed form "
                    f"{closed(spec):.6f} (z={z:.2f}), EE max |z| {zee:.2f}")
    phase("cva-multi-path", "CLI set 2^20 n_grid=50: " + "; ".join(msgs))

    # The mixed-sign sets against the float64 oracle, 2^20 paths each.
    msgs = []
    for m in (2, 9):
        spec = cva_multi_spec(m, 50, mixed=True)
        res = mt.price_cva_multi(spec, n, SEED)
        cva, se, _, _ = cva_multi_oracle(spec, n_or, SEED, "cuda")
        z = tie(res, cva, se, f"cva_multi mixed m={m} vs oracle")
        msgs.append(f"m={m} ({'K40' if m <= 8 else 'K39'}) "
                    f"{float(res.cva):.6f} vs oracle {cva:.6f} (z={z:.2f})")
    phase("cva-multi-path", "mixed-sign sets 2^20 n_grid=50 vs float64 "
          "oracle at 2^20: " + "; ".join(msgs))

    # One underlying (K40) against price_cva (K4); the JAX test's 9-set and
    # 100 underlyings (K39) against the closed form.
    one = cva_multi_spec(1, 50)
    r1 = mt.price_cva_multi(one, n, SEED)
    r4 = mt.price_cva(CvaSpec(0.03, 0.6, VanillaOption(100.0, 100.0, 0.05,
                                                       0.2, 1.0), 50),
                      n, SEED)
    z1 = tie(r1, float(r4.cva), float(r4.std_error), "cva_multi m=1 vs K4")
    m9 = 9
    s9 = CvaMultiSpec(0.03, 0.6, np.full(m9, 100.0),
                      np.linspace(0.15, 0.35, m9),
                      np.full((m9, m9), 0.2) + 0.8 * np.eye(m9), 0.05, 1.0,
                      np.linspace(90.0, 110.0, m9), np.full(m9, 1.0 / m9), 10)
    s100 = cva_multi_spec(100, 12)
    zs = []
    for spec, n_paths in ((s9, 1 << 18), (s100, 1 << 16)):
        res = mt.price_cva_multi(spec, n_paths, SEED)
        zs.append(within_sigma(res.cva, closed(spec), res.std_error,
                               f"cva_multi m={spec.n_underlyings}"))
    phase("cva-multi-path", f"m=1 (K40) {float(r1.cva):.6f} vs price_cva "
          f"{float(r4.cva):.6f} (z={z1:.2f}); m=9 n_grid=10 2^18 (K39) "
          f"z={zs[0]:.2f}, m=100 n_grid=12 2^16 (K39) z={zs[1]:.2f} vs the "
          "closed form")

    # K42 on the JAX Greeks CLI's set (m = 3, n_grid = 12): every output
    # within 4 se of autograd of the closed form; the CVA equal to
    # price_cva_multi's bit for bit.
    m = 3
    gspec = cva_greeks_cli_spec()
    g = mt.greeks(gspec, n, SEED)
    p = mt.price_cva_multi(gspec, n, SEED)
    check(float(g.cva.price) == float(p.cva),
          f"greeks_cva_multi cva {float(g.cva.price)!r} is not "
          f"price_cva_multi's {float(p.cva)!r}")
    lam, s0, v0 = (torch.tensor(np.asarray(x, np.float64), requires_grad=True)
                   for x in (gspec.intensity, gspec.s, gspec.v))
    cf = mcmath.cva_multi_closed_form(lam, gspec.lgd, s0, v0, gspec.strikes,
                                      gspec.weights, gspec.r, gspec.t, 12)
    cf.backward()
    zs = [within_sigma(g.cva.price, float(cf.detach()), g.cva.std_error,
                       "K42 cva"),
          within_sigma(g.credit_delta.price, float(lam.grad),
                       g.credit_delta.std_error, "K42 credit delta")]
    for j in range(m):
        zs.append(within_sigma(g.delta.price[j], float(s0.grad[j]),
                               g.delta.std_error[j], f"K42 delta_{j}"))
        zs.append(within_sigma(g.vega.price[j], float(v0.grad[j]),
                               g.vega.std_error[j], f"K42 vega_{j}"))
    phase("cva-multi-path", "Greeks CLI set 2^20 n_grid=12 (K42): cva "
          f"equals price_cva_multi ({float(p.cva):.6f}); cva, credit delta, "
          f"delta/vega vs autograd of the closed form, max z {max(zs):.2f}")

    # K42 on the mixed-sign pair against CRN bumps of price_cva_multi.
    mspec = cva_multi_spec(2, 50, mixed=True)
    g = mt.greeks(mspec, n, SEED)

    def bump(field, j, h):
        def at(x):
            if j is None:
                sp = dataclasses.replace(mspec, **{field: x})
            else:
                vals = np.asarray(getattr(mspec, field), float).copy()
                vals[j] = x
                sp = dataclasses.replace(mspec, **{field: vals})
            return float(mt.price_cva_multi(sp, n, SEED).cva)

        x0 = float(getattr(mspec, field) if j is None
                   else np.asarray(getattr(mspec, field))[j])
        return (at(x0 + h) - at(x0 - h)) / (2 * h)

    zs = [crn_gate(g.credit_delta.price, g.credit_delta.std_error,
                   bump("intensity", None, 1e-3), "K42 mixed credit delta")]
    for j in range(2):
        zs.append(crn_gate(g.delta.price[j], g.delta.std_error[j],
                           bump("s", j, 0.5), f"K42 mixed delta_{j}"))
        zs.append(crn_gate(g.vega.price[j], g.vega.std_error[j],
                           bump("v", j, 5e-3), f"K42 mixed vega_{j}"))
    phase("cva-multi-path", "Greeks mixed-sign pair 2^20 n_grid=50 (K42) vs "
          f"CRN bumps: max |z| {max(zs):.2f}")

    # K41 on the JAX Greeks CLI's set at --assets 9 and 16 (12 nodes,
    # 2^20): every output within 4 se of autograd of the closed form; the
    # CVA within 1e-5 of price_cva_multi's (K39: the same stream, the leg
    # priced in log(s / k)'s form).
    msgs = []
    for m in (9, 16):
        gspec = cva_greeks_cli_spec(m)
        g = mt.greeks(gspec, n, SEED)
        p = mt.price_cva_multi(gspec, n, SEED)
        rel = abs(float(g.cva.price) / float(p.cva) - 1.0)
        check(rel < 1e-5, f"K41 m={m}: cva {float(g.cva.price)!r} is "
                          f"{rel:.2e} from price_cva_multi's {float(p.cva)!r}")
        lam, s0, v0 = (torch.tensor(np.asarray(x, np.float64),
                                    requires_grad=True)
                       for x in (gspec.intensity, gspec.s, gspec.v))
        cf = mcmath.cva_multi_closed_form(lam, gspec.lgd, s0, v0,
                                          gspec.strikes, gspec.weights,
                                          gspec.r, gspec.t, 12)
        cf.backward()
        zs = [within_sigma(g.cva.price, float(cf.detach()), g.cva.std_error,
                           f"K41 m={m} cva"),
              within_sigma(g.credit_delta.price, float(lam.grad),
                           g.credit_delta.std_error,
                           f"K41 m={m} credit delta")]
        for j in range(m):
            zs.append(within_sigma(g.delta.price[j], float(s0.grad[j]),
                                   g.delta.std_error[j],
                                   f"K41 m={m} delta_{j}"))
            zs.append(within_sigma(g.vega.price[j], float(v0.grad[j]),
                                   g.vega.std_error[j],
                                   f"K41 m={m} vega_{j}"))
        msgs.append(f"m={m}: cva {rel:.1e} from price_cva_multi's, max z "
                    f"{max(zs):.2f}")
    phase("cva-multi-path", "Greeks CLI set --assets 9/16 2^20 n_grid=12 "
          "(K41) vs autograd of the closed form: " + "; ".join(msgs))


def xva_path(mt, mcmath) -> None:
    """The bilateral xVA slice at full width with the default EngineConfig:
    ``price_xva`` on the JAX exotic CLI's set (``--product xva``: K43 at 3
    underlyings, its runtime-m kernel at 16, 2^20 paths, 50 nodes) against
    the closed form, the EPE profile node by node against ``e^{r t_j} sum_m
    w_m C0_m``, exact zeros on the side a single-signed set never reaches;
    the all-short set's DVA and FBA; the mixed-sign pair (K43) and a
    9-underlying mixed set (runtime-m) against the float64 oracle; the
    no-own-default, no-funding tie to ``price_cva_multi``; one run at 100
    underlyings; ``greeks_xva`` on the JAX Greeks CLI's set (K44 at 3,
    runtime-m at 16, 12 nodes) against autograd of the closed form, and on
    ``tests/test_xva.py``'s mixed pair against CRN bumps of
    ``price_xva``."""
    from mctpu_torch.models.cva_multi import xva_oracle

    n = 1 << 20
    # A single-signed set never reaches the other side, but a leg deep out
    # of the money can price a hair below 0 under the Hastings CDF: its
    # side's legs and profile are 0 up to float32's subnormal range (mctpu's
    # XLA flushes subnormals to 0; the kernels and PyTorch keep them).
    tiny = torch.finfo(torch.float32).tiny

    def zero(x) -> bool:
        return bool((torch.as_tensor(x).abs() < tiny).all())

    def closed(xs, **inputs):
        net = xs.netting
        args = dict(intensity=net.intensity, own=xs.own_intensity,
                    spread=xs.funding_spread, s=net.s, v=net.v)
        args.update(inputs)
        return mcmath.xva_multi_closed_form(
            args["intensity"], net.lgd, args["own"], xs.own_lgd,
            args["spread"], args["s"], args["v"], net.strikes, net.weights,
            net.r, net.t, net.n_grid)

    # K43 and the runtime-m kernel on the CLI's all-long set: CVA and FCA
    # against the closed form, DVA, FBA and the ENE profile 0,
    # each EPE node within 4 of its standard errors of its martingale value
    # (the exposure's deviation per node from the float64 oracle at 2^18).
    msgs = []
    for m in (3, 16):
        xs = xva_spec(cva_multi_spec(m, 50))
        res = mt.price_xva(xs, n, SEED)
        legs = [float(x) for x in closed(xs)]
        zc = within_sigma(res.cva.price, legs[0], res.cva.std_error,
                          f"xva m={m} cva")
        zf = within_sigma(res.fca.price, legs[2], res.fca.std_error,
                          f"xva m={m} fca")
        check(zero(res.dva.price) and zero(res.fba.price)
              and zero(res.ene_profile),
              f"xva m={m}: the all-long set has a bank-side leg")
        net = xs.netting
        c0 = float(torch.sum(torch.as_tensor(net.weights) * mcmath.bs_call(
            torch.as_tensor(net.s), torch.as_tensor(net.strikes), net.r,
            torch.as_tensor(net.v), net.t)))
        tj = torch.arange(1, 51, dtype=torch.float64) / 50
        ora = xva_oracle(xs, 1 << 18, SEED + m, "cuda")
        zee = float(((res.epe_profile - c0 * torch.exp(net.r * tj)).abs()
                     / (ora["epe_sd"] / math.sqrt(res.cva.n))).max())
        check(zee < N_SIGMA, f"xva m={m}: EPE profile {zee:.2f} standard "
                             "errors off its martingale value")
        msgs.append(f"m={m} ({'K43' if m <= 8 else 'runtime-m'}) cva "
                    f"{float(res.cva.price):.6f} (z={zc:.2f}), fca "
                    f"{float(res.fca.price):.6f} (z={zf:.2f}), EPE max |z| "
                    f"{zee:.2f}")
    phase("xva-path", "CLI set 2^20 n_grid=50 vs the closed form: "
          + "; ".join(msgs))

    # The all-short set: DVA and FBA against the closed form, CVA, FCA and
    # the EPE profile 0.
    short = xva_spec(dataclasses.replace(cva_multi_spec(3, 50),
                                         weights=np.full(3, -1.0 / 3)))
    res = mt.price_xva(short, n, SEED)
    legs = [float(x) for x in closed(short)]
    zd = within_sigma(res.dva.price, legs[1], res.dva.std_error, "xva dva")
    zb = within_sigma(res.fba.price, legs[3], res.fba.std_error, "xva fba")
    check(zero(res.cva.price) and zero(res.fca.price)
          and zero(res.epe_profile),
          "xva: the all-short set has a counterparty-side leg")

    # The mixed-sign sets against the float64 oracle at 2^20: every leg.
    zs = []
    for m in (2, 9):
        xs = xva_spec(cva_multi_spec(m, 50, mixed=True))
        res = mt.price_xva(xs, n, SEED)
        ora = xva_oracle(xs, n, SEED, "cuda")
        for leg in ("cva", "dva", "fca", "fba"):
            r = getattr(res, leg)
            price, se = ora[leg]
            z = abs(float(r.price) - price) / math.hypot(float(r.std_error),
                                                         se)
            check(z < N_SIGMA, f"xva mixed m={m} {leg}: "
                               f"{float(r.price):.6f} vs oracle {price:.6f} "
                               f"({z:.2f} combined se)")
            zs.append(z)

    # No own default, no funding: the CVA leg is price_cva_multi's (K40)
    # bit for bit, its CI and EPE profile too.
    net = cva_multi_spec(3, 50)
    a = mt.price_xva(xva_spec(net, own=0.0, spread=0.0), n, SEED)
    b = mt.price_cva_multi(net, n, SEED)
    check(float(a.cva.price) == float(b.cva) and float(a.cva.ci) == float(
        b.ci) and torch.equal(a.epe_profile, b.expected_exposure),
          "xva at no own default and no funding is not price_cva_multi's")

    # One run at 100 underlyings (runtime-m K43, 12 nodes, 2^16 paths).
    x100 = xva_spec(cva_multi_spec(100, 12))
    r100 = mt.price_xva(x100, 1 << 16, SEED)
    z100 = within_sigma(r100.cva.price, float(closed(x100)[0]),
                        r100.cva.std_error, "xva m=100 cva")
    phase("xva-path", f"all-short m=3: dva z={zd:.2f}, fba z={zb:.2f}, "
          f"cva = fca = 0; mixed m=2 (K43) and m=9 (runtime-m) vs float64 "
          f"oracle at 2^20: max z {max(zs):.2f}; no own default and no "
          f"funding: cva {float(a.cva.price):.6f} equals price_cva_multi's; "
          f"m=100 2^16 n_grid=12 (runtime-m) cva z={z100:.2f}")

    # K44 and its runtime-m kernel on the JAX Greeks CLI's set (12 nodes,
    # 2^20): every output within 4 se of the closed form and its autograd.
    msgs = []
    for m in (3, 16):
        xs = xva_spec(cva_greeks_cli_spec(m))
        g = mt.greeks_xva(xs, n, SEED)
        net = xs.netting
        drv = {k: torch.tensor(np.asarray(x, np.float64), requires_grad=True)
               for k, x in (("intensity", net.intensity),
                            ("own", xs.own_intensity),
                            ("spread", xs.funding_spread), ("s", net.s),
                            ("v", net.v))}
        cva, dva, fca, fba = closed(xs, **drv)

        def grad(y, x):
            (gx,) = torch.autograd.grad(y, drv[x], retain_graph=True,
                                        allow_unused=True)
            return torch.zeros_like(drv[x]) if gx is None else gx

        zs = []
        for got, want in zip((g.cva, g.dva, g.fca, g.fba),
                             (cva, dva, fca, fba)):
            if float(want.detach()) == 0.0:
                check(zero(got.price), f"K44 m={m}: a leg the set never "
                                       "reaches is not 0")
            else:
                zs.append(within_sigma(got.price, float(want.detach()),
                                       got.std_error, f"K44 m={m} leg"))
        for got, want, what in (
                (g.credit_cpty, grad(cva, "intensity"), "credit_cpty"),
                (g.funding, grad(fca - fba, "spread"), "funding")):
            zs.append(within_sigma(got.price, float(want), got.std_error,
                                   f"K44 m={m} {what}"))
        check(zero(g.credit_own.price) and float(grad(dva, "own")) == 0.0,
              f"K44 m={m}: credit_own of an all-long set is not 0")
        total = cva - dva + fca - fba
        ds, dv = grad(total, "s"), grad(total, "v")
        for j in range(m):
            zs.append(within_sigma(g.delta.price[j], float(ds[j]),
                                   g.delta.std_error[j],
                                   f"K44 m={m} delta_{j}"))
            zs.append(within_sigma(g.vega.price[j], float(dv[j]),
                                   g.vega.std_error[j],
                                   f"K44 m={m} vega_{j}"))
        msgs.append(f"m={m} ({'K44' if m <= 8 else 'runtime-m'}) max z "
                    f"{max(zs):.2f}")
    phase("xva-path", "Greeks CLI set 2^20 n_grid=12 vs autograd of the "
          "closed form: " + "; ".join(msgs))

    # K44 on tests/test_xva.py's mixed pair (w 1/-0.8, 25 nodes) against
    # central CRN bumps of price_xva at that test's limits.
    mixed = xva_spec(dataclasses.replace(cva_multi_spec(2, 25, mixed=True),
                                         weights=np.array([1.0, -0.8])))
    g = mt.greeks_xva(mixed, n, SEED)

    def total(field, h):
        vals = np.asarray(getattr(mixed.netting, field), float).copy()
        vals[0] += h
        sp = dataclasses.replace(mixed, netting=dataclasses.replace(
            mixed.netting, **{field: vals}))
        r = mt.price_xva(sp, n, SEED)
        return (float(r.cva.price) - float(r.dva.price)
                + float(r.fca.price) - float(r.fba.price))

    zs = []
    for field, h, allow, got in (("s", 0.25, 2e-4, g.delta),
                                 ("v", 0.005, 5e-3, g.vega)):
        fd = (total(field, h) - total(field, -h)) / (2 * h)
        se = float(got.std_error[0])
        check(abs(float(got.price[0]) - fd) < 6 * se + allow,
              f"K44 mixed {field}: {float(got.price[0]):.6f} vs CRN bump "
              f"{fd:.6f} (se {se:.2e})")
        zs.append(abs(float(got.price[0]) - fd) / se)
    phase("xva-path", "Greeks mixed pair w 1/-0.8 2^20 n_grid=25 (K44) vs "
          f"CRN bumps of price_xva: delta_0, vega_0 |z| {zs[0]:.2f}, "
          f"{zs[1]:.2f}")


def rainbow_path(mt) -> None:
    """The rainbow slice at full width with the default EngineConfig:
    ``price_rainbow`` (K36 on the JAX exotic CLI's 3-asset rainbow and at 1
    and 2 assets, K37 at 16 and 100) against the Stulz closed form, the
    k = 0 identity, Black-Scholes and the float64 oracle;
    ``greeks_rainbow`` (K38) against autograd of the Stulz form, CRN bumps
    and the k = 0 identities, its price equal to the pricer's."""
    from mctpu_torch import math as mcmath
    from mctpu_torch.models.rainbow import rainbow_oracle
    from mctpu_torch.types import RainbowOption

    n24, n22, n_or = 1 << 24, 1 << 22, 1 << 20

    # Two assets against Stulz, max + min at k = 0 against s1 + s2 (its
    # sigma that of the forwards' sum: lognormal moments), one asset
    # against Black-Scholes.
    two = RainbowOption.equicorrelated([100.0, 95.0], [0.2, 0.3], 0.3, 100.0,
                                       0.05)
    msgs = []
    for kind in ("max", "min"):
        res = mt.price_rainbow(dataclasses.replace(two, kind=kind), n24, SEED)
        cf = float(getattr(mcmath, f"rainbow_{kind}_call")(
            100.0, 95.0, 100.0, 0.05, 0.2, 0.3, 0.3, 1.0))
        z = within_sigma(res.price, cf, res.std_error,
                         f"rainbow {kind} of 2 vs Stulz")
        msgs.append(f"{kind} {float(res.price):.6f} vs Stulz {cf:.6f} "
                    f"(z={z:.2f})")
    mx = mt.price_rainbow(dataclasses.replace(two, k=0.0), n24, SEED)
    mn = mt.price_rainbow(dataclasses.replace(two, k=0.0, kind="min"), n24,
                          SEED)
    s2, v2 = np.array([100.0, 95.0]), np.array([0.2, 0.3])
    var = (np.sum(s2 * s2 * np.expm1(v2 * v2))
           + 2 * s2[0] * s2[1] * np.expm1(0.3 * v2[0] * v2[1]))
    z0 = within_sigma(float(mx.price) + float(mn.price), 195.0,
                      math.sqrt(var / mx.n), "rainbow k=0 max + min")
    one = RainbowOption(s=np.array([100.0]), v=np.array([0.2]),
                        corr=np.eye(1), k=100.0, r=0.05, t=1.0)
    r1 = mt.price_rainbow(one, n24, SEED)
    bs = float(mcmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    z1 = within_sigma(r1.price, bs, r1.std_error, "rainbow a=1 vs BS")
    phase("rainbow-path", "2^24 (K36): " + "; ".join(msgs) + f"; k=0 max + "
          f"min {float(mx.price) + float(mn.price):.6f} vs 195 (z={z0:.2f})"
          f"; a=1 {float(r1.price):.6f} vs BS {bs:.6f} (z={z1:.2f})")

    # 3 assets (the JAX exotic CLI's --product rainbow: vols 0.2/0.3/0.2,
    # correlation 0.3, k = 100), 16 (tests/test_rainbow.py's packed case:
    # v = 0.25, k = 110) and 100, max and min (the min's strike lowered with
    # the basket), against the float64 oracle at 2^20 paths.
    cells = ((3, n24, [0.2, 0.3, 0.2], 100.0, 100.0),
             (16, n22, [0.25] * 16, 110.0, 75.0),
             (100, n22, [0.25] * 100, 110.0, 60.0))
    msgs = []
    for a, n, vols, k_max, k_min in cells:
        for kind, k in (("max", k_max), ("min", k_min)):
            opt = RainbowOption.equicorrelated(np.full(a, 100.0), vols, 0.3,
                                               k, 0.05, kind=kind)
            res = mt.price_rainbow(opt, n, SEED)
            price, se = rainbow_oracle(opt, n_or, SEED, "cuda")
            z = abs(float(res.price) - price) / math.hypot(
                float(res.std_error), se)
            check(z < N_SIGMA, f"rainbow {kind} of {a}: {float(res.price):.6f}"
                               f" vs oracle {price:.6f} ({z:.2f} combined se)")
            msgs.append(f"{kind} of {a} 2^{n.bit_length() - 1} "
                        f"{float(res.price):.6f} vs {price:.6f} (z={z:.2f})")
    phase("rainbow-path", "vs float64 oracle (K36 at 3, K37 at 16 and 100): "
          + "; ".join(msgs))

    # K38 at 2 assets (tests/test_greeks.py's option, correlation 0.5): every
    # output within 4 se of autograd of the Stulz form, max and min.
    g2 = RainbowOption.equicorrelated([100.0, 95.0], [0.2, 0.3], 0.5, 100.0,
                                      0.05)
    worst = 0.0
    for kind in ("max", "min"):
        xs = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (100.0, 95.0, 0.2, 0.3, 0.05, 1.0)]
        s1, s2_, v1, v2_, r, t = xs
        price = getattr(mcmath, f"rainbow_{kind}_call")(s1, s2_, 100.0, r,
                                                        v1, v2_, 0.5, t)
        price.backward()
        want = {"price": [price.item()], "delta": [s1.grad, s2_.grad],
                "vega": [v1.grad, v2_.grad], "rho": [r.grad],
                "theta": [t.grad]}
        g = mt.greeks(dataclasses.replace(g2, kind=kind), n24, SEED)
        check(g.gamma is None, "rainbow gamma is not None")
        for f, ws in want.items():
            res = getattr(g, f)
            for x, se, w in zip(np.atleast_1d(res.price.numpy()),
                                np.atleast_1d(res.std_error.numpy()), ws):
                worst = max(worst, within_sigma(
                    x, float(w), se, f"rainbow {kind} of 2 {f}"))

    # 3 assets (tests/test_greeks.py's CRN option): delta within 0.01 of a
    # CRN bump of price_rainbow (h = 0.25), vega within max(5%, 0.3)
    # (h = 0.005), that test's limits.
    o3 = RainbowOption(s=np.array([100.0, 98.0, 102.0]),
                       v=np.array([0.2, 0.25, 0.3]),
                       corr=np.array([[1.0, 0.3, 0.2], [0.3, 1.0, 0.4],
                                      [0.2, 0.4, 1.0]]),
                       k=100.0, r=0.05, t=1.0)
    g = mt.greeks(o3, n22, SEED)

    def fd(field, i, h):
        vals = []
        for sign in (1.0, -1.0):
            x = np.asarray(getattr(o3, field), float).copy()
            x[i] += sign * h
            vals.append(float(mt.price_rainbow(
                dataclasses.replace(o3, **{field: x}), n22, SEED).price))
        return (vals[0] - vals[1]) / (2 * h)

    dev_d = dev_v = 0.0
    for i in range(3):
        got, want = float(g.delta.price[i]), fd("s", i, 0.25)
        check(abs(got - want) <= 0.01, f"rainbow delta_{i}: {got:.6f} vs "
                                       f"CRN bump {want:.6f}")
        dev_d = max(dev_d, abs(got - want))
        got, want = float(g.vega.price[i]), fd("v", i, 0.005)
        check(abs(got - want) <= max(0.05 * abs(want), 0.3),
              f"rainbow vega_{i}: {got:.6f} vs CRN bump {want:.6f}")
        dev_v = max(dev_v, abs(got - want))

    # k = 0: rho exactly 0, and per asset delta_max + delta_min = 1.
    gmax = mt.greeks(dataclasses.replace(g2, k=0.0), n22, SEED)
    gmin = mt.greeks(dataclasses.replace(g2, k=0.0, kind="min"), n22, SEED)
    check(float(gmax.rho.price) == 0.0 and float(gmin.rho.price) == 0.0,
          "rainbow k=0: rho is not exactly 0")
    d = gmax.delta.price.numpy() + gmin.delta.price.numpy()
    se = np.hypot(gmax.delta.std_error.numpy(), gmin.delta.std_error.numpy())
    zk = float(np.max(np.abs(d - 1.0) / se))
    check(zk < N_SIGMA, f"rainbow k=0: delta_max + delta_min = {d}")

    # The JAX Greeks CLI's rainbow (spots 100/95/90, vols 0.2/0.25/0.3,
    # correlation 0.5): the Greeks price is price_rainbow's bit for bit;
    # 9 assets are refused.
    gc = RainbowOption.equicorrelated([100.0, 95.0, 90.0], [0.2, 0.25, 0.3],
                                      0.5, 100.0, 0.04879)
    g = mt.greeks_rainbow(gc, n24, SEED)
    p = mt.price_rainbow(gc, n24, SEED)
    check(float(g.price.price) == float(p.price),
          f"greeks_rainbow price {float(g.price.price)!r} is not "
          f"price_rainbow's {float(p.price)!r}")
    try:
        mt.greeks(RainbowOption.equicorrelated(np.full(9, 100.0),
                                               np.full(9, 0.2), 0.3, 100.0,
                                               0.05), 1 << 20, SEED)
    except ValueError as err:
        check("asset-major" in str(err), f"wrong refusal: {err}")
    else:
        raise AssertionError("greeks_rainbow took 9 assets")
    phase("rainbow-path", f"Greeks (K38): a=2 max/min 2^24 vs autograd of "
          f"Stulz, max |z| {worst:.2f}; a=3 2^22 vs CRN bumps, max |delta "
          f"- fd| {dev_d:.2e}, max |vega - fd| {dev_v:.2e}; k=0 rho 0, "
          f"delta_max + delta_min - 1 max |z| {zk:.2f}; the Greeks CLI's "
          f"3 assets at 2^24: price equals price_rainbow "
          f"({float(p.price):.6f}); 9 assets raise ValueError")


def varred_path(mt, mcmath) -> None:
    """The control-variate path at the JAX exotic CLI's ``--product cv``
    shapes (S=K=100, r=0.05, v=0.2, T=1): ``mctpu_torch.variance``'s
    pricers with the default EngineConfig, each against Black-Scholes or
    the plain pricer on an independent seed, and its standard error
    against the plain pricer's at the same path count (the limits of
    tests/test_variance.py, tests/test_asian.py and
    tests/test_varred_engine.py)."""
    from mctpu_torch import variance
    from mctpu_torch.types import AsianOption, BasketOption, VanillaOption

    def tighter(cv, mc, factor, what):
        ratio = float(mc.std_error) / max(float(cv.std_error), 1e-300)
        check(bool(torch.isfinite(cv.price)) and ratio > factor,
              f"{what}: CV std_error {float(cv.std_error):.3e} not below "
              f"plain {float(mc.std_error):.3e} / {factor}")
        return ratio

    def vs_plain(cv, mc, what):
        se = math.hypot(float(cv.std_error), float(mc.std_error))
        z = abs(float(cv.price) - float(mc.price)) / se
        check(z < N_SIGMA, f"{what}: CV {float(cv.price):.6f} vs plain "
                           f"{float(mc.price):.6f} is {z:.2f} combined "
                           "standard errors away")
        return z

    van = VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    n_van = 1 << 28
    bs = float(mcmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    cv = variance.price_vanilla_cv(van, n_van, SEED)
    mc = mt.price_vanilla(van, n_van, SEED + 1)
    z = within_sigma(cv.price, bs, cv.std_error, "vanilla CV")
    ratio = tighter(cv, mc, 1.8, "vanilla CV")
    plan = variance.cv_setup(van, n_van, mt.EngineConfig()).plan
    pilot = variance._pilot_plan(plan, 0.1)  # 8 blocks x 51 iterations
    check(cv.n == n_van and cv.n_paths == n_van + pilot.total_paths,
          f"vanilla CV paths {cv.n_paths}, units {cv.n}")
    anti = variance.price_vanilla_cv(van, 1 << 24, SEED,
                                     mt.EngineConfig(antithetic=True))
    z_a = within_sigma(anti.price, bs, anti.std_error, "vanilla CV antithetic")
    deep = VanillaOption(100.0, 20.0, 0.05, 0.2, 1.0)
    cv_d = variance.price_vanilla_cv(deep, 1 << 24, SEED)
    mc_d = mt.price_vanilla(deep, 1 << 24, SEED + 1)
    bs_d = float(mcmath.bs_call(100.0, 20.0, 0.05, 0.2, 1.0))
    tighter(cv_d, mc_d, 100.0, "deep ITM vanilla CV")
    # d is one float32 value on every deep in-the-money path, so the
    # standard error may be exactly 0: the float32 centers' rounding (half
    # an ulp of m = s0 e^{rT}) is the price's only error.
    check(abs(float(cv_d.price) - bs_d) < 4 * float(cv_d.std_error) + 4e-6,
          f"deep ITM vanilla CV {float(cv_d.price):.7f} vs BS {bs_d:.7f}")
    phase("cv-path", f"vanilla CV 2^28 (K45): {float(cv.price):.6f} (BS "
                     f"{bs:.6f}, z={z:.2f}), std_error "
                     f"{float(cv.std_error):.3e}, {ratio:.2f}x below plain "
                     f"{float(mc.std_error):.3e}; antithetic 2^24 "
                     f"z={z_a:.2f}; k=20 2^24 std_error "
                     f"{float(cv_d.std_error):.3e} vs plain "
                     f"{float(mc_d.std_error):.3e}, price - BS "
                     f"{float(cv_d.price) - bs_d:.2e}")

    ari = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=50)
    cv = variance.price_asian_cv(ari, 1 << 22, SEED)
    mc = mt.price_asian(ari, 1 << 22, SEED + 1)
    z = vs_plain(cv, mc, "Asian CV")
    ratio = tighter(cv, mc, 8.0, "Asian CV")
    phase("cv-path", f"arithmetic Asian CV n_obs=50 2^22 (K46): "
                     f"{float(cv.price):.6f} vs plain {float(mc.price):.6f} "
                     f"(z={z:.2f}), std_error {ratio:.1f}x below plain")

    msgs = []
    base3 = BasketOption.default_reference(3)
    for label, bopt, n in (
            ("equicorrelated(3, 0.3) (K47)",
             BasketOption.equicorrelated(3, 0.3), 1 << 24),
            ("equicorrelated(100, 0.3) (K48)",
             BasketOption.equicorrelated(100, 0.3), 1 << 22),
            ("default_reference(3), d=0.3 (K47)",
             dataclasses.replace(base3, d=np.full(3, 0.3)), 1 << 22)):
        cv = variance.price_basket_cv(bopt, n, SEED)
        mc = mt.price_basket(bopt, n, SEED + 1)
        z = vs_plain(cv, mc, f"basket CV {label}")
        ratio = tighter(cv, mc, 1.8, f"basket CV {label}")
        msgs.append(f"{label} 2^{n.bit_length() - 1} {float(cv.price):.6f} "
                    f"vs plain {float(mc.price):.6f} (z={z:.2f}), "
                    f"std_error {ratio:.1f}x below")
    phase("cv-path", "basket CV: " + "; ".join(msgs))


def bermudan(s, k, r, v, t, n_dates: int, n_steps: int,
             payoff: str = "put") -> float:
    """CRR lattice price of an option exercisable only at ``n_dates``
    equally spaced dates (``n_steps`` a multiple of ``n_dates``), float64
    NumPy: the oracle of a frozen rule at those dates (the continuous
    lattice prices the American, which a 12-date rule does not)."""
    dt = t / n_steps
    u = np.exp(v * np.sqrt(dt))
    d = 1.0 / u
    p = (np.exp(r * dt) - d) / (u - d)
    disc = np.exp(-r * dt)
    st = s * u ** (n_steps - np.arange(n_steps + 1)) \
        * d ** np.arange(n_steps + 1)

    def exercise(sv):
        return (np.maximum(k - sv, 0.0) if payoff == "put"
                else np.maximum(sv - k, 0.0))

    values = exercise(st)
    every = n_steps // n_dates
    for step in range(n_steps - 1, 0, -1):
        st = st[: step + 1] * d
        values = disc * (p * values[:-1] + (1 - p) * values[1:])
        if step % every == 0:
            values = np.maximum(values, exercise(st))
    return float(disc * (p * values[0] + (1 - p) * values[1]))


def american_path(mt, mcmath) -> None:
    """The American path at the JAX CLIs' shapes (S=K=100, r=0.05, v=0.2,
    T=1; mctpu/cli/exotic.py's american and is products, mctpu/cli/
    greeks.py's american): ``lsm.price_american`` on the engine tier
    (K50) against the CRR lattice and the float64 oracle tier, the call
    against Black-Scholes, one date against the European put, the dual
    bracket, ``greeks_american`` (K51) against lattice differences and
    its price against the pricer's bit for bit, the Heston American
    against the characteristic-function European and the CRR limit, and
    ``variance.price_vanilla_is`` (K49) against Black-Scholes (the limits
    of tests/test_american.py, tests/test_greeks.py and
    tests/test_variance.py)."""
    from mctpu_torch import lsm, variance
    from mctpu_torch.models import heston as mheston
    from mctpu_torch.types import AmericanOption, HestonOption, VanillaOption

    crr = mcmath.binomial_american
    cfg = mt.EngineConfig()
    put = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=50)
    n = 1 << 22
    res = lsm.price_american(put, n, SEED, config=cfg)
    p, se = float(res.price), float(res.std_error)
    c2000 = crr(100.0, 100.0, 0.05, 0.2, 1.0, 2000, "put")
    c1000 = crr(100.0, 100.0, 0.05, 0.2, 1.0, 1000, "put")
    check(res.n_paths == n and abs(p - c2000) < 4 * se + 0.02,
          f"American put {p:.6f} vs CRR-2000 {c2000:.6f} (se {se:.2e})")
    check(c1000 - 0.06 < p < c1000 + 3 * se,
          f"American put {p:.6f} outside (CRR-1000 - 0.06, CRR-1000 + 3 "
          f"se) around {c1000:.6f}")
    oracle = lsm.price_american(put, 1 << 20, SEED)
    se_c = math.hypot(se, float(oracle.std_error))
    z_o = abs(p - float(oracle.price)) / se_c
    check(z_o < 5.0, f"engine tier {p:.6f} vs oracle tier "
                     f"{float(oracle.price):.6f}: {z_o:.2f} combined se")
    phase("american-path", f"put 50 dates 2^22 (K50): {p:.6f} ± "
                           f"{float(res.ci):.6f}, CRR-2000 {c2000:.6f} "
                           f"(gap {c2000 - p:.4f}, Bermudan and rule), "
                           f"float64 oracle tier 2^20 "
                           f"{float(oracle.price):.6f} (z={z_o:.2f})")

    call = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=20,
                          payoff="call")
    bs = float(mcmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    rc = lsm.price_american(call, n, SEED, config=cfg)
    z_c = abs(float(rc.price) - bs) / float(rc.std_error)
    check(z_c < 5.0, f"American call {float(rc.price):.6f} vs BS {bs:.6f}")
    one = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=1)
    bs_put = float(mcmath.bs_put(100.0, 100.0, 0.05, 0.2, 1.0))
    r1 = lsm.price_american(one, n, SEED, config=cfg)
    z_1 = abs(float(r1.price) - bs_put) / float(r1.std_error)
    check(z_1 < 5.0, f"one-date put {float(r1.price):.6f} vs BS put "
                     f"{bs_put:.6f}")
    b = lsm.price_american_bounds(put, 1 << 16, SEED, n_sub=64, config=cfg)
    c4000 = crr(100.0, 100.0, 0.05, 0.2, 1.0, 4000, "put")
    lo = float(b.lower.price) - float(b.lower.ci)
    hi = float(b.upper.price) + float(b.upper.ci)
    check(lo <= c4000 <= hi, f"bracket [{lo:.6f}, {hi:.6f}] misses "
                             f"CRR-4000 {c4000:.6f}")
    check(b.gap < 0.005 * c4000 + float(b.lower.ci) + float(b.upper.ci),
          f"bracket gap {b.gap:.6f}")
    phase("american-path", f"call 20 dates 2^22 z={z_c:.2f} vs BS; one "
                           f"date z={z_1:.2f} vs the BS put; bracket 2^16 "
                           f"n_sub=64 [{lo:.6f}, {hi:.6f}] holds CRR-4000 "
                           f"{c4000:.6f}, gap {b.gap:.6f} "
                           f"({b.gap / c4000:.3%})")

    # The Greeks CLI's put: 12 exercise dates, 2^20 paths.  The frozen rule
    # prices the 12-date Bermudan, not the American, and its pathwise delta
    # and rho carry the rule's boundary term, which moves with the pilot
    # by several times the standard error at 2^20 (tools/
    # american_greeks_spread.py).  So, as tests/test_greeks.py holds them:
    # vega within 4 standard errors of central differences of the Bermudan
    # lattice at the same dates (4800 steps), rho within 4 standard errors
    # + 0.5, delta within 0.02 of the frozen-rule CRN difference of
    # price_american at h = 0.5 (the estimator's own definition); the call,
    # never exercised early, within 4 standard errors of Black-Scholes.
    # The z-scores against the Bermudan and the continuous CRR-4000
    # differences are printed beside them.
    g_opt = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=12)
    n_g = 1 << 20
    g = mt.greeks_american(g_opt, n_g, SEED)

    def diffs(price):
        at = {"s": 100.0, "r": 0.05, "v": 0.2}

        def fd(name, h):
            up, dn = dict(at), dict(at)
            up[name] += h
            dn[name] -= h
            return (price(**up) - price(**dn)) / (2 * h)

        return {"delta": fd("s", 0.25), "vega": fd("v", 5e-3),
                "rho": fd("r", 2e-3)}

    berm = diffs(lambda s, r, v: bermudan(s, 100.0, r, v, 1.0, 12, 4800))
    amer = diffs(lambda s, r, v: crr(s, 100.0, r, v, 1.0, 4000, "put"))
    beta = lsm.fit_exercise_rule(100.0, 100.0, 0.05, 0.2, 1.0, SEED, 1 << 15,
                                 12, "put", device=cfg.torch_device())

    def frozen(ds):
        return float(lsm._price_forward_engine(
            dataclasses.replace(g_opt, s=100.0 + ds), beta, SEED, n_g, cfg,
            False).price)

    crn_delta = frozen(0.5) - frozen(-0.5)
    msgs = []
    for name, slack in (("delta", None), ("vega", 0.0), ("rho", 0.5)):
        r = getattr(g, name)
        got, gse = float(r.price), float(r.std_error)
        if slack is None:
            check(abs(got - crn_delta) < 0.02,
                  f"American delta {got:.6f} vs frozen-rule CRN difference "
                  f"{crn_delta:.6f}")
        else:
            check(abs(got - berm[name]) < 4 * gse + slack,
                  f"American {name} {got:.6f} vs Bermudan-12 lattice "
                  f"{berm[name]:.6f} (se {gse:.2e})")
        msgs.append(f"{name} {got:.5f} (Bermudan-12 {berm[name]:.5f}, "
                    f"z={(got - berm[name]) / gse:.2f}; CRR-4000 "
                    f"{amer[name]:.5f}, z={(got - amer[name]) / gse:.2f})")
    p12 = lsm.price_american(g_opt, n_g, SEED, antithetic=False, config=cfg)
    check(float(g.price.sum_p) == float(p12.sum_p)
          and float(g.price.sum_p2) == float(p12.sum_p2),
          "greeks_american's price sums differ from price_american's")
    g_call = mt.greeks_american(dataclasses.replace(g_opt, payoff="call"),
                                n_g, SEED)
    bs_g = mcmath.bs_greeks(100.0, 100.0, 0.05, 0.2, 1.0)
    zc = [within_sigma(getattr(g_call, name).price, bs_g[name],
                       getattr(g_call, name).std_error,
                       f"American call {name}")
          for name in ("delta", "vega", "rho")]
    phase("american-path", "Greeks put 12 dates 2^20 (K51): " + "; ".join(msgs)
          + f"; delta vs frozen-rule CRN {crn_delta:.5f}; price "
            f"{float(g.price.price):.6f} equals price_american's bit for "
            "bit; call delta/vega/rho vs BS z=" + "/".join(f"{z:.2f}"
                                                          for z in zc))

    hopt = HestonOption(s=100.0, k=100.0, r=0.05, t=1.0, v0=0.04, kappa=1.5,
                        theta=0.04, xi=0.5, rho=-0.7)
    rh = lsm.price_american_heston(hopt, 1 << 17, SEED, n_steps=50)
    eur = mheston.cf_call_price(hopt) - 100.0 + 100.0 * math.exp(-0.05)
    check(float(rh.price) > eur + 3 * float(rh.std_error),
          f"Heston American {float(rh.price):.6f} not above the European "
          f"{eur:.6f}")
    hlim = dataclasses.replace(hopt, xi=1e-4, rho=0.0, kappa=2.0)
    rl = lsm.price_american_heston(hlim, 1 << 17, SEED + 1, n_steps=50)
    c50 = crr(100.0, 100.0, 0.05, 0.2, 1.0, 50, "put")
    check(abs(float(rl.price) - c50) < 4 * float(rl.std_error) + 0.02,
          f"Heston xi=1e-4 {float(rl.price):.6f} vs CRR-50 {c50:.6f}")
    z_h = (float(rh.price) - eur) / float(rh.std_error)
    phase("american-path", f"Heston QE 50 steps 2^17: {float(rh.price):.6f} "
                           f"above the CF European put {eur:.6f} by "
                           f"{z_h:.1f} se; xi=1e-4 {float(rl.price):.6f} vs "
                           f"CRR-50 {c50:.6f}")

    deep = VanillaOption(100.0, 200.0, 0.05, 0.2, 1.0)
    n_is = 1 << 28
    bs_d = float(mcmath.bs_call(100.0, 200.0, 0.05, 0.2, 1.0))
    ri = variance.price_vanilla_is(deep, n_is, SEED)
    z_i = within_sigma(ri.price, bs_d, ri.std_error, "IS K=200")
    mc = mt.price_vanilla(deep, n_is, SEED)
    ratio = float(mc.std_error) / float(ri.std_error)
    check(ratio >= 10.0, f"IS std_error only {ratio:.1f}x below plain")
    zs = []
    bs_150 = float(mcmath.bs_call(100.0, 150.0, 0.05, 0.2, 1.0))
    for theta in (0.5, 1.5, 3.0):
        rt = variance.price_vanilla_is(
            VanillaOption(100.0, 150.0, 0.05, 0.2, 1.0), n_is, SEED,
            theta=theta)
        z = abs(float(rt.price) - bs_150) / float(rt.std_error)
        check(z < 5.0, f"IS K=150 theta={theta}: {float(rt.price):.8f} vs "
                       f"BS {bs_150:.8f}")
        zs.append(f"theta={theta} z={z:.2f}")
    phase("american-path", f"IS K=200 2^28 (K49, tilt "
                           f"{variance.optimal_tilt(deep):.3f}): "
                           f"{float(ri.price):.8f} (BS {bs_d:.8f}, "
                           f"z={z_i:.2f}), std_error {ratio:.1f}x below "
                           "price_vanilla's at the same seed; K=150 "
                           + ", ".join(zs))


def mlmc_path(mt, mcmath) -> None:
    """The MLMC path: ``mctpu_torch.mlmc`` at the JAX exotic CLI's
    ``--product mlmc``, ``mlmc-asian`` and ``mlmc-barrier`` defaults (S=K=100,
    r=0.05, v=0.2, T=1; mctpu/cli/exotic.py:353-425) on the CLI's 512 x 256
    config, at eps = 0.02 and, for Heston and the Asian, a desk's 0.005;
    the Heston gate of tests/test_mlmc.py on ``mctpu``'s 8 x 8 default at
    eps = 0.05; the level checks of tests/test_mlmc.py at 2^22 paths.
    Each call prints its level table, wall ms, path-steps per second and
    launches (level 0's K27, K9 or K12 and the level kernel's)."""
    from mctpu_torch import mlmc
    from mctpu_torch.kernels import asian as kasian
    from mctpu_torch.kernels import barrier as kbarrier
    from mctpu_torch.kernels import heston as kheston
    from mctpu_torch.models import heston as mheston
    from mctpu_torch.types import AsianOption, BarrierOption, HestonOption

    counters = (kheston.LAUNCHES, kasian.LAUNCHES, kbarrier.LAUNCHES)

    def n_launches():
        return sum(sum(c.values()) for c in counters)

    def run(label, fn):
        before = n_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(all(math.isfinite(x) for lv in res.levels
                  for x in (lv.mean, lv.var)) and res.std_error > 0,
              f"{label}: non-finite level table")
        table = "; ".join(f"l{lv.level} n={lv.n_steps} N={lv.n_paths} "
                          f"mean={lv.mean:+.3e} var={lv.var:.3e}"
                          for lv in res.levels)
        phase("mlmc-path", f"{label}: {res.price:.6f} ± {res.ci:.6f}, "
                           f"{wall * 1e3:.1f} ms wall, "
                           f"{res.total_path_steps / wall:.4g} path-steps/s "
                           f"({res.total_path_steps:.4g}), "
                           f"{n_launches() - before} launches; {table}")
        return res

    cli = mt.EngineConfig()  # the JAX CLIs' --blocks 512 --rows 256
    hopt = HestonOption(*HESTON_OPTS["opt"])
    cf = mheston.cf_call_price(hopt)
    for eps in (0.02, 0.005):
        res = run(f"Heston Euler eps={eps} (K27, K29; CF {cf:.6f})",
                  lambda e=eps: mlmc.price_heston_mlmc(hopt, e, SEED, cli))
        check(abs(res.price - cf) < 3 * eps,
              f"MLMC Heston eps={eps}: {res.price:.6f} vs CF {cf:.6f}")
    topt = HestonOption(*HESTON_OPTS["mlmc_test"])
    cf_t = mheston.cf_call_price(topt)
    res = run(f"Heston Euler tests/test_mlmc.py option, 8 x 8 default, "
              f"eps=0.05 (CF {cf_t:.6f})",
              lambda: mlmc.price_heston_mlmc(topt, 0.05, SEED))
    check(abs(res.price - cf_t) < 3 * 0.05,
          f"MLMC Heston 8 x 8: {res.price:.6f} vs CF {cf_t:.6f}")

    geo = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=4,
                      average="geometric")
    for eps in (0.02, 0.005):
        res = run(f"geometric Asian eps={eps} (K9, K11)",
                  lambda e=eps: mlmc.price_asian_mlmc(geo, e, SEED, cli))
        cfa = float(mcmath.geometric_asian_call(
            100.0, 100.0, 0.05, 0.2, 1.0, res.levels[-1].n_steps))
        z = abs(res.price - cfa) / res.std_error
        check(z < N_SIGMA, f"MLMC geometric Asian eps={eps}: "
                           f"{res.price:.6f} vs closed form {cfa:.6f} at "
                           f"{res.levels[-1].n_steps} dates (z={z:.2f})")
        phase("mlmc-path", f"geometric Asian eps={eps}: closed form at "
                           f"{res.levels[-1].n_steps} dates {cfa:.6f}, "
                           f"z={z:.2f}")
    ari = run("arithmetic Asian eps=0.02 (K9, K11)",
              lambda: mlmc.price_asian_mlmc(
                  dataclasses.replace(geo, average="arithmetic"), 0.02, SEED,
                  cli))
    check(ari.price > res.price, "arithmetic Asian MLMC price below the "
                                 "geometric one")

    uo = BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, barrier=130.0, n_obs=8)
    res = run("up-and-out H=130 eps=0.02 max_levels=8 (K12, K14)",
              lambda: mlmc.price_barrier_mlmc(uo, 0.02, SEED, cli,
                                              max_levels=8))
    cont = float(mcmath.up_and_out_call(100.0, 100.0, 0.05, 0.2, 1.0, 130.0))
    bias_est = abs(res.levels[-1].mean) * math.exp(-0.05) / (2 ** 0.5 - 1.0)
    check(res.price > cont and abs(res.price - cont)
          < 0.02 + bias_est + 3 * res.std_error,
          f"MLMC up-and-out {res.price:.6f} vs continuous {cont:.6f} "
          f"(bias estimate {bias_est:.4f}, se {res.std_error:.2e})")
    phase("mlmc-path", f"up-and-out: continuous closed form {cont:.6f}, "
                       f"remaining-bias estimate {bias_est:.5f}")

    # Level checks at 2^22 paths on the CLI config: E[d_l] of the geometric
    # Asian equals cf(n_l) - cf(n_l / 2) (undiscounted, 4 sigma); the
    # up-and-out level means are negative.
    n = 1 << 22
    msgs = []
    for lv in (1, 3):
        s, s2, nu = mlmc.asian_level_partials(geo, SEED + lv, lv, 4, n, cli)
        m = s / nu
        se = math.sqrt(max(s2 / nu - m * m, 0.0) / nu)
        want = float(mcmath.geometric_asian_call(100.0, 100.0, 0.05, 0.2, 1.0,
                                                 4 * 2 ** lv)
                     - mcmath.geometric_asian_call(100.0, 100.0, 0.05, 0.2,
                                                   1.0, 2 * 2 ** lv)) \
            * math.exp(0.05)
        z = abs(m - want) / se
        check(z < N_SIGMA, f"geometric level {lv} mean {m:.6e} vs "
                           f"{want:.6e} (z={z:.2f})")
        msgs.append(f"Asian l{lv} {m:+.5e} vs {want:+.5e} z={z:.2f}")
    for lv in (1, 2, 3):
        s, _, nu = mlmc.barrier_level_partials(uo, SEED + lv, lv, 8, n, cli)
        check(s / nu < 0, f"up-and-out level {lv} mean {s / nu:.3e} >= 0")
        msgs.append(f"barrier l{lv} {s / nu:+.4e}")
    phase("mlmc-path", "level means 2^22: " + "; ".join(msgs))


def rqmc_path(mt, mcmath) -> None:
    """The RQMC path: ``mctpu_torch.qmc_engine`` at the JAX CLIs' RQMC
    calls and defaults (``mctpu-exotic --product rqmc``, ``mctpu-greeks
    --rqmc``; S=K=100, r=0.05, v=0.2, T=1, 16 replicates, n = 131072 on the
    512 x 256 config; mctpu/cli/exotic.py:265-299, mctpu/cli/greeks.py:
    594-611): the vanilla call within 4 standard errors of Black-Scholes
    and its CI 5x below ``price_vanilla``'s at the same total paths, the put
    within 5 of parity; the Asian at max(n // 50, 4096) points and 50 dates,
    the geometric within 5 of its closed form, the arithmetic between it
    and the vanilla; baskets equicorrelated(3, 0.3) and (100, 0.3) within 4
    combined standard errors of ``price_basket`` at 2^24 and 2^22 paths;
    ``greeks_vanilla_rqmc`` call and put at 2^13 and 2^20 points a
    replicate, every output within 4 of ``bs_greeks`` (the put by parity,
    tests/test_qmc_engine.py); the geometric Asian at 252 dates against its
    closed form.  Each call prints its wall ms, points per second and
    launches."""
    from mctpu_torch import qmc_engine
    from mctpu_torch.kernels import rqmc as krqmc
    from mctpu_torch.types import AsianOption, BasketOption, VanillaOption

    n, reps = 131072, 16

    def run(label, fn, points):
        before = sum(krqmc.LAUNCHES.values())
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        phase("rqmc-path", f"{label}: {wall * 1e3:.2f} ms wall, "
                           f"{points / wall:.4g} points/s, "
                           f"{sum(krqmc.LAUNCHES.values()) - before} launches")
        return res

    def near(res, want, n_sigma, what):
        z = abs(float(res.price) - want) / float(res.std_error)
        check(bool(torch.isfinite(res.price)) and z < n_sigma,
              f"{what}: {float(res.price):.6f} vs {want:.6f} is {z:.2f} "
              "standard errors away")
        return z

    call = VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    put = dataclasses.replace(call, kind="put")
    bs = float(mcmath.bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    res = run("vanilla call n=131072 x 16 (K52)",
              lambda: mt.price_vanilla_rqmc(call, n, SEED), n * reps)
    z = near(res, bs, N_SIGMA, "RQMC vanilla call")
    check(res.n == reps and res.n_paths == n * reps,
          f"RQMC vanilla n={res.n}, n_paths={res.n_paths}")
    mc = mt.price_vanilla(call, res.n_paths, SEED)
    ratio = float(mc.ci) / float(res.ci)
    check(ratio > 5.0, f"RQMC CI {float(res.ci):.3e} not 5x below plain MC "
                       f"{float(mc.ci):.3e}")
    resp = run("vanilla put (K52)",
               lambda: mt.price_vanilla_rqmc(put, n, SEED), n * reps)
    parity = bs - 100.0 + 100.0 * math.exp(-0.05)
    zp = near(resp, parity, 5.0, "RQMC vanilla put")
    phase("rqmc-path", f"call {float(res.price):.6f} ± {float(res.ci):.2e} "
                       f"(BS {bs:.6f}, z={z:.2f}), CI {ratio:.0f}x below "
                       f"price_vanilla's at {res.n_paths} paths; put "
                       f"{float(resp.price):.6f} (parity {parity:.6f}, "
                       f"z={zp:.2f})")

    n_as = max(n // 50, 1 << 12)
    geo = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=50,
                      average="geometric")
    rg = run(f"geometric Asian 50 dates n={n_as} (K55)",
             lambda: mt.price_asian_rqmc(geo, n_as, SEED), n_as * reps * 50)
    cf = float(mcmath.geometric_asian_call(100.0, 100.0, 0.05, 0.2, 1.0, 50))
    zg = near(rg, cf, 5.0, "RQMC geometric Asian")
    ra = run(f"arithmetic Asian 50 dates n={n_as} (K55)",
             lambda: mt.price_asian_rqmc(dataclasses.replace(
                 geo, average="arithmetic"), n_as, SEED), n_as * reps * 50)
    check(float(rg.price) < float(ra.price) < bs,
          f"RQMC arithmetic Asian {float(ra.price):.6f} outside "
          f"({float(rg.price):.6f}, {bs:.6f})")
    g252 = dataclasses.replace(geo, n_obs=252)
    r252 = run(f"geometric Asian 252 dates n={n} (K55)",
               lambda: mt.price_asian_rqmc(g252, n, SEED), n * reps * 252)
    cf252 = float(mcmath.geometric_asian_call(100.0, 100.0, 0.05, 0.2, 1.0,
                                              252))
    z252 = near(r252, cf252, 5.0, "RQMC geometric Asian 252")
    phase("rqmc-path", f"Asian: geometric {float(rg.price):.6f} (closed form "
                       f"{cf:.6f}, z={zg:.2f}), arithmetic "
                       f"{float(ra.price):.6f} ± {float(ra.ci):.2e}; 252 "
                       f"dates {float(r252.price):.6f} (closed form "
                       f"{cf252:.6f}, z={z252:.2f})")

    msgs = []
    for a, n_mc in ((3, 1 << 24), (100, 1 << 22)):
        bopt = BasketOption.equicorrelated(a, 0.3)
        rb = run(f"basket equicorrelated({a}, 0.3) n={n} (K54)",
                 lambda o=bopt: mt.price_basket_rqmc(o, n, SEED),
                 n * reps)
        mc = mt.price_basket(bopt, n_mc, SEED + 1)
        se = math.hypot(float(rb.std_error), float(mc.std_error))
        zb = abs(float(rb.price) - float(mc.price)) / se
        check(zb < N_SIGMA, f"RQMC basket a={a} {float(rb.price):.6f} vs "
                            f"price_basket {float(mc.price):.6f} (z={zb:.2f})")
        msgs.append(f"a={a} {float(rb.price):.6f} ± {float(rb.ci):.2e} vs "
                    f"price_basket 2^{n_mc.bit_length() - 1} "
                    f"{float(mc.price):.6f} (z={zb:.2f})")
    phase("rqmc-path", "basket: " + "; ".join(msgs))

    names = ("price", "delta", "vega", "rho", "theta", "gamma", "vanna",
             "volga")
    gopt = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
    cf_call = {k: float(v) for k, v in
               mcmath.bs_greeks(100.0, 100.0, 0.048790, 0.2, 1.0).items()}
    disc = math.exp(-0.048790)
    cf_put = dict(cf_call)
    cf_put["price"] -= 100.0 - 100.0 * disc
    cf_put["delta"] -= 1.0
    cf_put["rho"] -= 100.0 * disc
    cf_put["theta"] -= 0.048790 * 100.0 * disc
    for pts in (1 << 13, 1 << 20):
        for kind, cf_g in (("call", cf_call), ("put", cf_put)):
            g = run(f"Greeks {kind} {pts} x 16 (K53)",
                    lambda k=kind, p=pts: qmc_engine.greeks_vanilla_rqmc(
                        dataclasses.replace(gopt, kind=k), p, SEED),
                    pts * reps)
            zs = []
            for name in names:
                r = getattr(g, name)
                zn = abs(float(r.price) - cf_g[name]) / float(r.std_error)
                check(zn < N_SIGMA, f"RQMC {kind} {name} {float(r.price):.6f} "
                                    f"vs {cf_g[name]:.6f} (z={zn:.2f})")
                zs.append(f"{name} z={zn:.2f}")
            phase("rqmc-path", f"Greeks {kind} 2^{pts.bit_length() - 1}: "
                               + ", ".join(zs))


def main() -> int:

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mctpu_torch
    from mctpu_torch import (_build, engine, estimator as mcest, lsm,
                             qmc_engine, variance)
    from mctpu_torch import math as mcmath
    from mctpu_torch.kernels import asian as kasian
    from mctpu_torch.kernels import barrier as kbarrier
    from mctpu_torch.kernels import barrier_book as kbb
    from mctpu_torch.kernels import basket as kbasket
    from mctpu_torch.kernels import book as kbook
    from mctpu_torch.kernels import cliquet as kcliquet
    from mctpu_torch.kernels import cva as kcva
    from mctpu_torch.kernels import cva_multi as kcm
    from mctpu_torch.kernels import greeks as kgreeks
    from mctpu_torch.kernels import heston as kheston
    from mctpu_torch.kernels import ladder as kladder
    from mctpu_torch.kernels import lookback as klookback
    from mctpu_torch.kernels import lsm as klsm
    from mctpu_torch.kernels import multi_walk as kmw
    from mctpu_torch.kernels import rainbow as krainbow
    from mctpu_torch.kernels import rqmc as krqmc
    from mctpu_torch.kernels import vanilla as kvanilla
    from mctpu_torch.kernels import varred as kvr
    from mctpu_torch.kernels import varswap as kvarswap
    from mctpu_torch.parallel.reduce import pairwise_tree_sum
    from mctpu_torch.types import (AmericanOption, AsianOption, BarrierBook,
                                   BarrierOption, BasketAsianOption,
                                   BasketBarrierOption,
                                   BasketOption, CliquetOption,
                                   CvaPortfolioSpec, CvaSpec, HestonOption,
                                   LookbackOption, Precision, RainbowOption,
                                   VanillaBook, VanillaOption)

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

    def contract(label, fn, plain, units=None, rtol=RTOL, moments=False,
                 blocks=nb):
        """``units`` per block given: the Greek partials' scaled bound, or
        with ``moments`` the control variates' moment bound; ``blocks``
        simulation blocks (``nb`` unless a plan's own count is kept)."""
        outs = [fn(0, blocks), fn(0, blocks), fn(2, blocks - 2),
                plain(0, blocks)]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        torch.cuda.synchronize()
        worst = 0.0
        for got, again, tail, want in zip(*outs):
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
            check(torch.equal(got, again), f"{label}: launches differ")
            check(torch.equal(got[2:], tail), f"{label}: block offset")
            if moments:
                worst = max(worst, close_moments(got, want, units, rtol,
                                                 label))
            elif units is None:
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
    # K3 split per (block, iteration) and folded in the unsplit order: its
    # register-tiled product at 10, 16, 100 and 128 assets and the per-path
    # code at 200, at 72 rows (a short last chunk at 100, 128 and 200),
    # plain with Kahan and antithetic without; the scratch capped at 1
    # float (every (block, iteration) its own group, the fold's Acc2s
    # carried between them) and at half the one-group scratch bit-equal to
    # one group.
    for a in (10, 16, 100, 128, 200):
        bopt = BasketOption.equicorrelated(a)
        ops = kbasket.operands(bopt, mcmath.cholesky_lower(bopt.corr), dev)
        a_tile, _, width = kbasket.pack_factor(a)
        for anti in (False, True):
            probe = kbasket.make_plan(1, nb, 72, anti, not anti, n_assets=a)
            plan = kbasket.make_plan(nb * iters * probe.paths_per_iter, nb,
                                     72, anti, not anti, n_assets=a)
            contract(f"K3 split a={a} rows 72"
                     f"{' antithetic' if anti else ''}",
                     lambda off, n: kbasket.partials(ops, SEED, off, plan, n),
                     lambda off, n: kbasket.plain_partials(ops, SEED, off,
                                                           plan, n))
        whole = _build.library().mctpu_basket_packed_scratch_floats(
            a_tile, width, nb, plan.rows, plan.iters, 0)
        want = kbasket.partials(ops, SEED, 0, plan, nb)
        for cap in (1, whole // 2):
            check(torch.equal(kbasket.partials(ops, SEED, 0, plan, nb,
                                               scratch_cap=cap), want),
                  f"K3 a={a}: scratch capped at {cap} floats differs")
        phase("kernel-vs-plain", f"K3 split a={a}: scratch capped at 1 and "
                                 f"{whole // 2} floats bit-equal to one "
                                 "group")
    spec50 = CvaSpec(0.03, 0.6, VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0),
                     50)
    # K4 at rows 32: eight 4-row slices a block, two iterations, folded.
    for label, port, prec, anti in (
            ("K4 n_grid=50", CvaPortfolioSpec.from_single(spec50),
             Precision.F32_KAHAN, False),
            ("K4 WWR b=0.8", CvaPortfolioSpec.from_single(spec50, wwr_b=0.8),
             Precision.F32_KAHAN, False),
            ("K4 F32_DS", CvaPortfolioSpec.from_single(spec50),
             Precision.F32_DS, False),
            ("K4 netted 2-option", CvaPortfolioSpec(
                0.03, 0.6, 100.0, 0.05, 0.2, 1.0, [95.0, 110.0], [1.0, -0.5],
                0.0, 50), Precision.F32_KAHAN, False),
            ("K4 antithetic WWR b=0.8 F32_DS",
             CvaPortfolioSpec.from_single(spec50, wwr_b=0.8),
             Precision.F32_DS, True)):
        ops = kcva.operands(port, dev)
        wwr = float(port.wwr_b) != 0.0
        plan = kcva.make_plan(nb * iters * rows * 128 * (2 if anti else 1),
                              nb, rows, anti, prec.kahan, prec.ds)
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
    # K5 as K4: eight 4-row slices a block, two iterations, folded.
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

    # The single-asset walks at an odd date count (the trailing half pair).
    n_obs = 13
    ari13 = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=n_obs)
    uo13 = BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, 130.0, n_obs=n_obs)
    for greek, k_asian, k_barrier in ((False, 9, 12), (True, 10, 13)):
        for label, kmod, wopt, anti in (
                (f"K{k_asian} arithmetic", kasian, ari13, False),
                (f"K{k_asian} geometric", kasian,
                 dataclasses.replace(ari13, average="geometric"), False),
                (f"K{k_asian} arithmetic antithetic", kasian, ari13, True),
                (f"K{k_barrier} up-and-out H=130", kbarrier, uo13, False),
                (f"K{k_barrier} down-and-out H=80", kbarrier,
                 dataclasses.replace(uo13, barrier=80.0,
                                     kind="down-and-out"), False)):
            plan = kmod.make_plan(nb * iters * rows * 128 * (2 if anti else 1),
                                  nb, rows, anti)
            fn, plain = walk_launchers(kmod, wopt, greek, dev)
            contract(label, lambda off, n: fn(off, n, plan),
                     lambda off, n: plain(off, n, plan),
                     units=units(plan) if greek else None)
    # K12, K15 and K30 are split per path element and folded in the unsplit
    # order: on the MLMC 8 x 8 plan with many iterations against their plain
    # versions, and under a forced small scratch cap (1 float: every (block,
    # iteration) its own group, the fold's carry between them; half the
    # one-group scratch: blocks in groups) bit-equal to the one-group launch.
    # K15 in every mode, the fixed strikes off the atom at s0.
    uo50 = BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, 130.0, n_obs=50)
    bpar = kbarrier.params(uo50, dev)
    b3 = BasketOption.default_reference(3)
    lt3, par3 = (x.to(dev) for x in kmw.walk_ops(
        b3, mcmath.cholesky_lower(b3.corr), 50))
    split_cases = (
        ("K12 up-and-out H=130", 1,
         lambda off, n, pl, cap=0: kbarrier.partials(
             bpar, SEED, off, pl, n, 50, True, scratch_cap=cap),
         lambda off, n, pl: kbarrier.plain_partials(bpar, SEED, off, pl, n,
                                                    50, True),
         lambda pl, cap: _build.library().mctpu_barrier_scratch_floats(
             pl.num_blocks, pl.rows, pl.iters, cap)),
    ) + tuple(
        (f"K30 a=3 {product}", 3,
         lambda off, n, pl, cap=0, pr=product, sc=sc: kmw.partials(
             lt3, par3, sc, SEED, off, pl, n, pr, 50, True,
             scratch_cap=cap),
         lambda off, n, pl, pr=product, sc=sc: kmw.plain_partials(
             lt3, par3, sc, SEED, off, pl, n, pr, 50, True),
         lambda pl, cap: _build.library().mctpu_multi_walk_am_scratch_floats(
             pl.num_blocks, pl.rows, pl.iters, cap))
        for product, sc in (("asian", kmw.scalars(b3).to(dev)),
                            ("barrier", kmw.scalars(b3, 130.0).to(dev)))
    ) + tuple(
        (f"K15 {lopt.kind} {lopt.payoff}", 1,
         lambda off, n, pl, cap=0, lp=lp, m=m: klookback.partials(
             lp, SEED, off, pl, n, 50, m, scratch_cap=cap),
         lambda off, n, pl, lp=lp, m=m: klookback.plain_partials(
             lp, SEED, off, pl, n, 50, m),
         lambda pl, cap: _build.library().mctpu_lookback_scratch_floats(
             pl.num_blocks, pl.rows, pl.iters, cap))
        for lopt in (LookbackOption(100.0, 0.05, 0.2, 1.0, n_obs=50,
                                    kind=kind, payoff=payoff, k=k)
                     for kind, payoff, k in (("floating", "call", 0.0),
                                             ("floating", "put", 0.0),
                                             ("fixed", "call", 105.0),
                                             ("fixed", "put", 95.0)))
        for lp, m in ((klookback.params(lopt, dev),
                       klookback.mode_of(lopt)),))
    def split_contract(label, fn, plain, floats, pairs=False):
        """A split walk on the MLMC 8 x 32 x 8 plan, plain and antithetic,
        against its plain version (by the scaled pair bound with
        ``pairs``), and at nb x 3 x 13 with its scratch capped at 1 float
        and at half the one-group scratch, bit-equal to one group."""
        for anti in (False, True):
            plan = kbarrier.make_plan(8 * 32 * 8 * 128 * (2 if anti else 1),
                                      8, 8, anti)
            contract(f"{label} MLMC plan 8 x 32 x 8"
                     f"{' antithetic' if anti else ''}",
                     lambda off, n: fn(off, n, plan),
                     lambda off, n: plain(off, n, plan), blocks=8,
                     units=units(plan) if pairs else None)
        plan = kbarrier.make_plan(nb * 3 * 13 * 128, nb, 13, False)
        want = fn(0, nb, plan)
        whole = floats(plan, 0)
        check(floats(plan, 1) < whole, f"{label}: the cap did not bind")
        for cap in (1, whole // 2):
            check(torch.equal(fn(0, nb, plan, cap), want),
                  f"{label}: scratch capped at {cap} floats differs")
        phase("kernel-vs-plain", f"{label} split: scratch capped at 1 and "
                                 f"{whole // 2} floats ({nb} x 3 x 13) "
                                 "bit-equal to one group")

    for label, _, fn, plain, floats in split_cases:
        split_contract(label, fn, plain, floats)
    # K10 is a split walk too, its 5 outputs an element folded once an
    # iteration (its pairs by the scaled bound), at the odd 13 dates.
    for average in ("arithmetic", "geometric"):
        geo = average == "geometric"
        gp13 = kasian.greek_params(dataclasses.replace(ari13,
                                                       average=average), dev)
        split_contract(
            f"K10 {average} 13 dates",
            lambda off, n, pl, cap=0, gp=gp13, geo=geo: kasian.greek_partials(
                gp, SEED, off, pl, n, 13, geo, scratch_cap=cap),
            lambda off, n, pl, gp=gp13, geo=geo: kasian.greek_plain_partials(
                gp, SEED, off, pl, n, 13, geo),
            lambda pl, cap: _build.library().mctpu_asian_greeks_scratch_floats(
                pl.num_blocks, pl.rows, pl.iters, cap), pairs=True)

    # The lookback in every mode (fixed strikes off the atom at s0) and the
    # cliquet, at the same odd step count.
    lb13 = LookbackOption(100.0, 0.05, 0.2, 1.0, n_obs=n_obs)
    cq13 = CliquetOption(100.0, 0.03, 0.2, 1.0, n_periods=n_obs, cap=0.05,
                         floor=-0.02)
    for greek, k_lb, k_cq in ((False, 15, 17), (True, 16, 18)):
        for label, kmod, wopt, anti in (
                (f"K{k_lb} floating call", klookback, lb13, False),
                (f"K{k_lb} floating put", klookback,
                 dataclasses.replace(lb13, payoff="put"), False),
                (f"K{k_lb} fixed call k=105", klookback,
                 dataclasses.replace(lb13, kind="fixed", k=105.0), False),
                (f"K{k_lb} fixed put k=95", klookback,
                 dataclasses.replace(lb13, kind="fixed", payoff="put",
                                     k=95.0), False),
                (f"K{k_lb} floating call antithetic", klookback, lb13, True),
                (f"K{k_cq} cliquet", kcliquet, cq13, False),
                (f"K{k_cq} cliquet antithetic", kcliquet, cq13, True)):
            plan = kmod.make_plan(nb * iters * rows * 128 * (2 if anti else 1),
                                  nb, rows, anti)
            fn, plain = walk_launchers(kmod, wopt, greek, dev)
            contract(label, lambda off, n: fn(off, n, plan),
                     lambda off, n: plain(off, n, plan),
                     units=units(plan) if greek else None)

    # The strike ladder and the vanilla book (K21-K24) at K and M of 1, 5
    # and 64: calls, puts and a mixed book, antithetic and Kahan on and off.
    def flat(x):
        return x.reshape(x.shape[0], -1)

    variants = (("call", False, True), ("put", False, False),
                ("call", True, False), ("put", True, True))
    for n_k in (1, 5, 64):
        ks = kladder.strike_vector(np.linspace(50.0, 150.0, n_k), dev)
        for kind, anti, kahan in variants:
            o = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
            plan = kladder.make_plan(nb * iters * 2 * rows * 128
                                     * (2 if anti else 1), nb, rows, anti,
                                     kahan)
            put = kind == "put"
            tag = (f"K={n_k} {kind}{' antithetic' if anti else ''}"
                   f"{'' if kahan else ' f32'}")
            par, gp = kladder.params(o, dev), kladder.greek_params(o, dev)
            contract(f"K21 {tag}",
                     lambda off, n: flat(kladder.partials(par, ks, SEED, off,
                                                          plan, n, put)),
                     lambda off, n: flat(kladder.plain_partials(
                         par, ks, SEED, off, plan, n, put)))
            contract(f"K22 {tag}",
                     lambda off, n: flat(kladder.greek_partials(
                         gp, ks, SEED, off, plan, n, put)),
                     lambda off, n: flat(kladder.greek_plain_partials(
                         gp, ks, SEED, off, plan, n, put)),
                     units=units(plan))
    for m in (1, 5, 64):
        for kind, anti, kahan in (
                ("mixed", False, True), ("put", False, False),
                ("call", True, False), ("mixed", True, True)):
            bk = VanillaBook.serving(m, kind)
            plan = kbook.make_plan(nb * iters * 2 * rows * 128
                                   * (2 if anti else 1), nb, rows, anti, kahan)
            tag = (f"M={m} {kind}{' antithetic' if anti else ''}"
                   f"{'' if kahan else ' f32'}")
            par, cvec = kbook.params(bk, dev), kbook.greek_const_rows(bk, dev)
            contract(f"K23 {tag}",
                     lambda off, n: flat(kbook.partials(par, SEED, off, plan,
                                                        n)),
                     lambda off, n: flat(kbook.plain_partials(par, SEED, off,
                                                              plan, n)))
            contract(f"K24 {tag}",
                     lambda off, n: flat(kbook.greek_partials(
                         cvec, SEED, off, plan, n)),
                     lambda off, n: flat(kbook.greek_plain_partials(
                         cvec, SEED, off, plan, n)),
                     units=units(plan))

    # The variance swap (K19, K20) at 1, 13 and 252 dates.
    vs_opt = VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    for n_obs, anti, kahan in ((1, False, True), (13, False, False),
                               (13, True, True), (252, False, True),
                               (252, True, False)):
        plan = kvarswap.make_plan(nb * iters * rows * 128 * (2 if anti else 1),
                                  nb, rows, anti, kahan)
        tag = (f"n_obs={n_obs}{' antithetic' if anti else ''}"
               f"{'' if kahan else ' f32'}")
        par = kvarswap.params(vs_opt, n_obs, dev)
        gp = kvarswap.greek_params(vs_opt, n_obs, dev)
        contract(f"K19 {tag}",
                 lambda off, n: kvarswap.partials(par, SEED, off, plan, n,
                                                  n_obs),
                 lambda off, n: kvarswap.plain_partials(par, SEED, off, plan,
                                                        n, n_obs))
        contract(f"K20 {tag}",
                 lambda off, n: kvarswap.greek_partials(gp, SEED, off, plan,
                                                        n, n_obs),
                 lambda off, n: kvarswap.greek_plain_partials(
                     gp, SEED, off, plan, n, n_obs),
                 units=units(plan))
    # The barrier book (K25, K26) at M of 1, 5 and 32 and 1, 7 and 50 dates:
    # the serving mix (calls up-and-out, puts down-and-out) and all calls.
    for m, n_obs, kind, anti, kahan in (
            (1, 7, "call", False, True), (1, 50, "call", True, False),
            (5, 1, "mixed", True, True), (5, 50, "mixed", False, False),
            (32, 7, "call", False, True), (32, 50, "mixed", False, True),
            (32, 50, "mixed", True, False)):
        bk = dataclasses.replace(BarrierBook.serving(m, kind), n_obs=n_obs)
        plan = kbb.make_plan(nb * iters * rows * 128 * (2 if anti else 1), nb,
                             rows, anti, kahan)
        tag = (f"M={m} n_obs={n_obs} {kind}{' antithetic' if anti else ''}"
               f"{'' if kahan else ' f32'}")
        par, gp = kbb.book_params(bk, dev), kbb.greek_rows(bk, dev)
        contract(f"K25 {tag}",
                 lambda off, n: flat(kbb.partials(par, SEED, off, plan, n,
                                                  n_obs)),
                 lambda off, n: flat(kbb.plain_partials(par, SEED, off, plan,
                                                        n, n_obs)))
        contract(f"K26 {tag}",
                 lambda off, n: flat(kbb.greek_partials(gp, SEED, off, plan, n,
                                                        n_obs)),
                 lambda off, n: flat(kbb.greek_plain_partials(
                     gp, SEED, off, plan, n, n_obs)),
                 units=units(plan))
    # The Heston walks: K27 (Euler and QE) and K28 at an odd 13 steps and
    # the default 100, on the reference option and the Feller-violating
    # one; K19/K20's Heston leg at 13 and 252 dates.
    h_opt, h_steep, h_vs = (HestonOption(*HESTON_OPTS[k])
                            for k in ("opt", "steep", "vs"))
    for label, hopt, n_steps, anti, kahan in (
            ("", h_opt, 13, False, True), ("", h_opt, 100, True, False),
            (" Feller-violating", h_steep, 100, False, True)):
        plan = kheston.make_plan(nb * iters * rows * 128 * (2 if anti else 1),
                                 nb, rows, anti, kahan)
        tag = (f"n_steps={n_steps}{label}{' antithetic' if anti else ''}"
               f"{'' if kahan else ' f32'}")
        for qe in (False, True):
            par = kheston.params(hopt, n_steps, qe, dev)
            contract(f"K27 {'QE' if qe else 'Euler'} {tag}",
                     lambda off, n: kheston.partials(par, SEED, off, plan, n,
                                                     n_steps, qe),
                     lambda off, n: kheston.plain_partials(
                         par, SEED, off, plan, n, n_steps, qe))
        gp = kheston.greek_params(hopt, n_steps, dev)
        contract(f"K28 {tag}",
                 lambda off, n: kheston.greek_partials(gp, SEED, off, plan, n,
                                                       n_steps),
                 lambda off, n: kheston.greek_plain_partials(
                     gp, SEED, off, plan, n, n_steps),
                 units=units(plan))
    # K27 is a split walk (as K12): Euler and QE at 8 steps, level 0 of
    # mctpu's MLMC default, on that plan's shape and with its scratch
    # capped, bit-equal to one group.
    for qe in (False, True):
        hpar8 = kheston.params(h_opt, 8, qe, dev)
        split_contract(
            f"K27 {'QE' if qe else 'Euler'} 8 steps (MLMC level 0)",
            lambda off, n, pl, cap=0, par=hpar8, qe=qe: kheston.partials(
                par, SEED, off, pl, n, 8, qe, scratch_cap=cap),
            lambda off, n, pl, par=hpar8, qe=qe: kheston.plain_partials(
                par, SEED, off, pl, n, 8, qe),
            lambda pl, cap: _build.library().mctpu_heston_scratch_floats(
                pl.num_blocks, pl.rows, pl.iters, cap))
    # K19 is a split walk (as K27), both legs: GBM at 13 dates, Heston at
    # 13 and 252.
    vs_gbm13 = kvarswap.params(VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0),
                               13, dev)
    for leg, vpar, vn in (("GBM", vs_gbm13, 13),
                          ("Heston", kvarswap.heston_params(h_vs, 13, dev),
                           13),
                          ("Heston", kvarswap.heston_params(h_vs, 252, dev),
                           252)):
        split_contract(
            f"K19 {leg} {vn} dates",
            lambda off, n, pl, cap=0, par=vpar, vn=vn: kvarswap.partials(
                par, SEED, off, pl, n, vn, scratch_cap=cap),
            lambda off, n, pl, par=vpar, vn=vn: kvarswap.plain_partials(
                par, SEED, off, pl, n, vn),
            lambda pl, cap: _build.library().mctpu_varswap_scratch_floats(
                pl.num_blocks, pl.rows, pl.iters, cap))
    # K20's Heston leg is a split walk too, its six outputs an element
    # folded once an iteration (its pairs by the scaled bound).
    vhgp13 = kvarswap.heston_greek_params(h_vs, 13, dev)
    split_contract(
        "K20 Heston 13 dates",
        lambda off, n, pl, cap=0: kvarswap.greek_partials(
            vhgp13, SEED, off, pl, n, 13, scratch_cap=cap),
        lambda off, n, pl: kvarswap.greek_plain_partials(vhgp13, SEED, off,
                                                         pl, n, 13),
        lambda pl, cap: _build.library().mctpu_varswap_greeks_scratch_floats(
            pl.num_blocks, pl.rows, pl.iters, cap),
        pairs=True)
    for n_obs, anti, kahan in ((13, False, True), (252, False, True),
                               (252, True, False)):
        plan = kvarswap.make_plan(nb * iters * rows * 128 * (2 if anti else 1),
                                  nb, rows, anti, kahan)
        tag = (f"Heston n_obs={n_obs}{' antithetic' if anti else ''}"
               f"{'' if kahan else ' f32'}")
        par = kvarswap.heston_params(h_vs, n_obs, dev)
        gp = kvarswap.heston_greek_params(h_vs, n_obs, dev)
        contract(f"K19 {tag}",
                 lambda off, n: kvarswap.partials(par, SEED, off, plan, n,
                                                  n_obs),
                 lambda off, n: kvarswap.plain_partials(par, SEED, off, plan,
                                                        n, n_obs))
        contract(f"K20 {tag}",
                 lambda off, n: kvarswap.greek_partials(gp, SEED, off, plan,
                                                        n, n_obs),
                 lambda off, n: kvarswap.greek_plain_partials(
                     gp, SEED, off, plan, n, n_obs),
                 units=units(plan))

    # The MLMC level kernels at levels 1 and 4: K29 on the reference option
    # (the JAX exotic CLI's --product mlmc) with n0 = 8 (16 and 128 fine
    # steps), K11 with n0 = 4 (8 and 64 dates) under both averages, K14 with
    # n0 = 8 (16 and 128 dates) up-and-out at H = 130 and down-and-out at H
    # = 80; antithetic and Kahan each on and off.  d is a payoff difference,
    # so its block sums are held by the scaled pair bound.  K29 and K11 are
    # split walks (as K12): also at level 4 (K11 under both averages) on
    # the MLMC 8 x 32 x 8 plan and with their scratch capped, bit-equal to
    # one group.
    hlp4 = kheston.level_params(h_opt, 128, dev)
    split_contract(
        "K29 level 4 (128 steps)",
        lambda off, n, pl, cap=0: kheston.level_partials(
            hlp4, SEED, off, pl, n, 128, scratch_cap=cap),
        lambda off, n, pl: kheston.level_plain_partials(hlp4, SEED, off, pl,
                                                        n, 128),
        lambda pl, cap: _build.library().mctpu_heston_level_scratch_floats(
            pl.num_blocks, pl.rows, pl.iters, cap), pairs=True)
    alp4 = kasian.level_params(
        AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=4), 64, dev)
    for average in ("arithmetic", "geometric"):
        split_contract(
            f"K11 {average} level 4 (64 dates)",
            lambda off, n, pl, cap=0, g=average == "geometric":
            kasian.level_partials(alp4, SEED, off, pl, n, 64, g,
                                  scratch_cap=cap),
            lambda off, n, pl, g=average == "geometric":
            kasian.level_plain_partials(alp4, SEED, off, pl, n, 64, g),
            lambda pl, cap: _build.library().mctpu_asian_level_scratch_floats(
                pl.num_blocks, pl.rows, pl.iters, cap), pairs=True)
    for lv, anti, kahan in ((1, False, True), (4, True, False),
                            (4, False, True)):
        plan = kheston.make_plan(nb * iters * rows * 128 * (2 if anti else 1),
                                 nb, rows, anti, kahan)
        tag = (f"level {lv}{' antithetic' if anti else ''}"
               f"{'' if kahan else ' f32'}")
        nf = 8 * 2 ** lv
        lp = kheston.level_params(h_opt, nf, dev)
        contract(f"K29 {tag} ({nf} steps)",
                 lambda off, n: kheston.level_partials(lp, SEED, off, plan, n,
                                                       nf),
                 lambda off, n: kheston.level_plain_partials(
                     lp, SEED, off, plan, n, nf), units=units(plan))
        for average in ("arithmetic", "geometric"):
            nfa = 4 * 2 ** lv
            ap = kasian.level_params(
                AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=4), nfa, dev)
            geo = average == "geometric"
            contract(f"K11 {average} {tag} ({nfa} dates)",
                     lambda off, n: kasian.level_partials(
                         ap, SEED, off, plan, n, nfa, geo),
                     lambda off, n: kasian.level_plain_partials(
                         ap, SEED, off, plan, n, nfa, geo),
                     units=units(plan))
        for kind, h in (("up-and-out", 130.0), ("down-and-out", 80.0)):
            bp = kbarrier.level_params(
                BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, barrier=h,
                              n_obs=8, kind=kind), nf, dev)
            up = kind == "up-and-out"
            contract(f"K14 {kind} H={h:g} {tag} ({nf} dates)",
                     lambda off, n: kbarrier.level_partials(
                         bp, SEED, off, plan, n, nf, up),
                     lambda off, n: kbarrier.level_plain_partials(
                         bp, SEED, off, plan, n, nf, up),
                     units=units(plan))

    # The multi-asset walks: K30 and K32/K34 at a = 1, 3 and 8, K31 and
    # K33/K35 at 16 and 100 assets and at the edges of K31's register
    # instances (9 and 16 for a_tile 16, 17 and 32 for a_tile 32; 100 takes
    # the shared-memory design), both products (up- and down-and-out), 13
    # dates (the trailing half pair); antithetic and Kahan on and off,
    # rotated over the products so that each kernel meets every variant
    # (K33's and K35's padded lanes held to exact zeros by the pair bound's
    # zero columns); K35's price sums equal K31's bit for bit.
    def mw_pairs(out):
        scal, vec = out
        return torch.cat([scal] + [vec[:, :, i] for i in range(vec.shape[2])],
                         1)

    mw_variants = ((False, True), (True, True), (False, False))
    mw_obs = 13
    for ka, a in enumerate((1, 3, 8, 16, 100, 9, 17, 32)):
        bk = BasketOption.equicorrelated(a, 0.3)
        chol = mcmath.cholesky_lower(bk.corr)
        lt, par = (x.to(dev) for x in kmw.walk_ops(bk, chol, mw_obs))
        kid = "K30" if kbasket.use_asset_major(a) else "K31"
        for (product, up, h), (anti, kahan) in zip(
                (("asian", True, None), ("barrier", True, 104.0),
                 ("barrier", False, 96.0)),
                mw_variants[ka % 3:] + mw_variants[:ka % 3]):
            probe = kmw.make_plan(1, nb, rows, anti, kahan, n_assets=a)
            plan = kmw.make_plan(nb * iters * probe.paths_per_iter, nb, rows,
                                 anti, kahan, n_assets=a)
            scal = kmw.scalars(bk, h).to(dev)
            tag = (f"a={a} {product if h is None else ('up' if up else 'down')}"
                   f"{'' if h is None else f' H={h:g}'}"
                   f"{' antithetic' if anti else ''}{'' if kahan else ' f32'}")
            contract(f"{kid} {tag}",
                     lambda off, n: kmw.partials(lt, par, scal, SEED, off,
                                                 plan, n, product, mw_obs, up),
                     lambda off, n: kmw.plain_partials(lt, par, scal, SEED,
                                                       off, plan, n, product,
                                                       mw_obs, up))
            if a > 8 and product == "asian":
                ops = tuple(x.to(dev) for x in kmw.packed_greek_ops(
                    bk, chol, mw_obs))
                fn = kmw.am_greek_partials
                plain = kmw.packed_greek_plain_partials
                extra, gid = (), "K33"
            elif a > 8:
                ops = tuple(x.to(dev) for x in kmw.packed_bar_greek_ops(
                    bk, chol, mw_obs, h))
                fn = kmw.bar_greek_partials
                plain = kmw.packed_bar_greek_plain_partials
                extra, gid = (up,), "K35"
            elif product == "asian":
                ops = tuple(x.to(dev) for x in kmw.am_greek_ops(bk, chol,
                                                                mw_obs))
                fn, plain = kmw.am_greek_partials, kmw.am_greek_plain_partials
                extra, gid = (), "K32"
            else:
                ops = tuple(x.to(dev) for x in kmw.am_bar_greek_ops(
                    bk, chol, mw_obs, h))
                fn = kmw.am_bar_greek_partials
                plain = kmw.am_bar_greek_plain_partials
                extra, gid = (up,), "K34"
            contract(f"{gid} {tag}",
                     lambda off, n: mw_pairs(fn(*ops, SEED, off, plan, n,
                                                mw_obs, *extra)),
                     lambda off, n: mw_pairs(plain(*ops, SEED, off, plan, n,
                                                   mw_obs, *extra)),
                     units=units(plan))
            if gid == "K35":
                check(torch.equal(
                    fn(*ops, SEED, 0, plan, nb, mw_obs, *extra)[0][:, :2],
                    kmw.partials(lt, par, scal, SEED, 0, plan, nb, product,
                                 mw_obs, up)),
                      f"K35 {tag}: price sums differ from K31's")
    # K34 is a split walk, its 2 + 2a outputs an element folded once an
    # iteration into add_greek_sums' row: at 3 assets up-and-out and 8
    # down-and-out, 13 dates, its pairs by the scaled bound.
    for a, up, h in ((3, True, 104.0), (8, False, 96.0)):
        bk = BasketOption.equicorrelated(a, 0.3)
        bops = tuple(x.to(dev) for x in kmw.am_bar_greek_ops(
            bk, mcmath.cholesky_lower(bk.corr), mw_obs, h))
        split_contract(
            f"K34 a={a} {'up' if up else 'down'} H={h:g} {mw_obs} dates",
            lambda off, n, pl, cap=0, o=bops, u=up: mw_pairs(
                kmw.am_bar_greek_partials(*o, SEED, off, pl, n, mw_obs, u,
                                          scratch_cap=cap)),
            lambda off, n, pl, o=bops, u=up: mw_pairs(
                kmw.am_bar_greek_plain_partials(*o, SEED, off, pl, n, mw_obs,
                                                u)),
            lambda pl, cap, a=a: _build.library()
            .mctpu_multi_walk_bar_greeks_am_scratch_floats(
                a, pl.num_blocks, pl.rows, pl.iters, cap),
            pairs=True)

    # K33's register kernel (a_tile 16 at 9 and 16 assets, 32 at 17 and 32)
    # at 5 dates, plain and antithetic, Kahan on and off, against its plain
    # version; its price sums equal K31's bit for bit at 16 dates.
    for a in (9, 16, 17, 32):
        bk = BasketOption.equicorrelated(a, 0.3)
        chol = mcmath.cholesky_lower(bk.corr)
        for anti in (False, True):
            for kahan in (True, False):
                probe = kmw.make_plan(1, nb, rows, anti, kahan, n_assets=a)
                plan = kmw.make_plan(nb * iters * probe.paths_per_iter, nb,
                                     rows, anti, kahan, n_assets=a)
                ops = tuple(x.to(dev) for x in kmw.packed_greek_ops(bk, chol,
                                                                   5))
                contract(f"K33 register a={a} n_obs=5"
                         f"{' antithetic' if anti else ''}"
                         f"{'' if kahan else ' f32'}",
                         lambda off, n: mw_pairs(kmw.am_greek_partials(
                             *ops, SEED, off, plan, n, 5)),
                         lambda off, n: mw_pairs(
                             kmw.packed_greek_plain_partials(
                                 *ops, SEED, off, plan, n, 5)),
                         units=units(plan))
            ops16 = tuple(x.to(dev) for x in kmw.packed_greek_ops(bk, chol,
                                                                 16))
            lt, par = (x.to(dev) for x in kmw.walk_ops(bk, chol, 16))
            check(torch.equal(
                kmw.am_greek_partials(*ops16, SEED, 0, plan, nb, 16)[0][:, :2],
                kmw.partials(lt, par, kmw.scalars(bk).to(dev), SEED, 0, plan,
                             nb, "asian", 16)),
                  f"K33 a={a}{' antithetic' if anti else ''}: price sums at "
                  "16 dates differ from K31's")
        phase("kernel-vs-plain", f"K33 register a={a}: price sums at 16 "
                                 "dates equal K31's bit for bit")

    # The rainbow: K36 and K38 at 1, 3 and 8 assets, K37 at 9, 16 and 100,
    # max and min, antithetic and Kahan rotated over the sizes; K38's price
    # sums equal K36's bit for bit.
    rb_strike_min = {1: 100.0, 3: 90.0, 8: 85.0, 9: 80.0, 16: 75.0,
                     100: 60.0}
    for ka, a in enumerate(sorted(rb_strike_min)):
        j = np.arange(a)
        kid = "K36" if kbasket.use_asset_major(a) else "K37"
        for kind, (anti, kahan) in zip(("max", "min"),
                                       mw_variants[ka % 3:]
                                       + mw_variants[:ka % 3]):
            ropt = RainbowOption.equicorrelated(
                90.0 + 20.0 * ((j * 7) % 11) / 10.0, 0.15 + 0.05 * (j % 5),
                0.3, 100.0 if kind == "max" else rb_strike_min[a], 0.05,
                kind=kind)
            chol = mcmath.cholesky_lower(ropt.corr)
            ops = krainbow.operands(ropt, chol, dev)
            probe = krainbow.make_plan(1, nb, rows, anti, kahan, n_assets=a)
            plan = krainbow.make_plan(nb * iters * probe.paths_per_iter, nb,
                                      rows, anti, kahan, n_assets=a)
            tag = (f"a={a} {kind}{' antithetic' if anti else ''}"
                   f"{'' if kahan else ' f32'}")
            contract(f"{kid} {tag}",
                     lambda off, n: krainbow.partials(ops, SEED, off, plan, n),
                     lambda off, n: krainbow.plain_partials(ops, SEED, off,
                                                            plan, n))
            if a > 8:
                continue
            gops = krainbow.greek_operands(ropt, chol, dev)
            contract(f"K38 {tag}",
                     lambda off, n: krainbow.greek_partials(gops, SEED, off,
                                                            plan, n),
                     lambda off, n: krainbow.greek_plain_partials(
                         gops, SEED, off, plan, n), units=units(plan))
            check(torch.equal(
                krainbow.greek_partials(gops, SEED, 0, plan, nb)[:, :2],
                krainbow.partials(ops, SEED, 0, plan, nb)),
                f"K38 {tag}: price sums differ from K36's")

    def k41_gates(tag, gops, cops, plan):
        """K41's CVA sums within 1e-5 of K39's (the two forms of a leg)
        and its padded lanes exactly 0."""
        gsum, gvec = kcm.greek_partials(gops, SEED, 0, plan, nb)
        price = kcm.partials(cops, SEED, 0, plan, nb)[0]
        close = (gsum[:, :2].double() - price.double()).abs() <= (
            1e-5 * price.double().abs())
        check(bool(close.all()), f"K41 {tag}: CVA sums beyond 1e-5 of K39's")
        m = gops.n_underlyings
        a_tile, c_pk, _ = kbasket.pack_factor(m)
        check(bool((gvec.reshape(nb, 4, c_pk, a_tile)[..., m:] == 0).all()),
              f"K41 {tag}: a padded lane is not 0")

    # The netting-set CVA: K40 and K42 at 1, 2, 3 and 8 underlyings, K39
    # and K41 at 9, 16 and 100 (the mixed-sign legs at 2, 8, 9 and 100, the
    # CLI's all-long set at 1, 3 and 16), 13 nodes (the trailing half
    # pair), antithetic and Kahan rotated over the sizes; the EE profile at
    # RTOL (its warp-then-block order against the plain version's sum over
    # the block); K42's CVA sums equal K40's bit for bit (K40's split and
    # fold keep the order of the unsplit kernel that K42 runs), K41's K39's
    # at 1e-5 (the two forms of a leg).
    for ka, (m, mixed) in enumerate(((1, False), (2, True), (3, False),
                                     (8, True), (9, True), (16, False),
                                     (17, True), (32, False), (100, True))):
        anti, kahan = mw_variants[ka % 3]
        cspec = cva_multi_spec(m, 13, mixed)
        cops = kcm.operands(cspec, mcmath.cholesky_lower(cspec.corr), dev)
        probe = kcm.make_plan(1, nb, rows, anti, kahan, n_underlyings=m)
        plan = kcm.make_plan(nb * iters * probe.paths_per_iter, nb, rows,
                             anti, kahan, n_underlyings=m)
        tag = (f"m={m}{' mixed' if mixed else ''}"
               f"{' antithetic' if anti else ''}{'' if kahan else ' f32'}")
        contract(f"{'K40' if m <= 8 else 'K39'} {tag}",
                 lambda off, n: kcm.partials(cops, SEED, off, plan, n),
                 lambda off, n: kcm.plain_partials(cops, SEED, off, plan, n))
        gops = kcm.operands(cspec, mcmath.cholesky_lower(cspec.corr), dev,
                            greeks=True)
        kid = "K42" if m <= 8 else "K41"
        contract(f"{kid} {tag}",
                 lambda off, n: mw_pairs(kcm.greek_partials(gops, SEED, off,
                                                            plan, n)),
                 lambda off, n: mw_pairs(kcm.greek_plain_partials(
                     gops, SEED, off, plan, n)), units=units(plan))
        if m <= 8:
            check(torch.equal(
                kcm.greek_partials(gops, SEED, 0, plan, nb)[0][:, :2],
                kcm.partials(cops, SEED, 0, plan, nb)[0]),
                f"K42 {tag}: CVA sums differ from K40's")
        else:
            k41_gates(tag, gops, cops, plan)

    # K39's and K41's register instances (a_tile 16 at 9 and 16
    # underlyings, 32 at 17 and 32) at rows that leave K39's passes with
    # lanes past the tile's rows (35: two passes of 18 rows at a_tile 16;
    # 69: two of 35 at 32) and give K41 one-row passes, mixed and all-long
    # legs, 13 nodes; K41 plain and antithetic at each size, its padded
    # lanes exactly 0 and its CVA sums within 1e-5 of K39's.
    for ka, (m, mixed, urows) in enumerate(((9, True, 35), (16, False, 35),
                                            (17, True, 69),
                                            (32, False, 69))):
        anti, kahan = mw_variants[ka % 3]
        cspec = cva_multi_spec(m, 13, mixed)
        cops = kcm.operands(cspec, mcmath.cholesky_lower(cspec.corr), dev)
        gops = kcm.operands(cspec, mcmath.cholesky_lower(cspec.corr), dev,
                            greeks=True)
        probe = kcm.make_plan(1, nb, urows, anti, kahan, n_underlyings=m)
        plan = kcm.make_plan(nb * iters * probe.paths_per_iter, nb, urows,
                             anti, kahan, n_underlyings=m)
        contract(f"K39 m={m}{' mixed' if mixed else ''} rows={urows}"
                 f"{' antithetic' if anti else ''}{'' if kahan else ' f32'}",
                 lambda off, n: kcm.partials(cops, SEED, off, plan, n),
                 lambda off, n: kcm.plain_partials(cops, SEED, off, plan, n))
        for ganti in (False, True):
            probe = kcm.make_plan(1, nb, urows, ganti, kahan,
                                  n_underlyings=m)
            gplan = kcm.make_plan(nb * iters * probe.paths_per_iter, nb,
                                  urows, ganti, kahan, n_underlyings=m)
            tag = (f"m={m}{' mixed' if mixed else ''} rows={urows}"
                   f"{' antithetic' if ganti else ''}"
                   f"{'' if kahan else ' f32'}")
            contract(f"K41 {tag}",
                     lambda off, n: mw_pairs(kcm.greek_partials(
                         gops, SEED, off, gplan, n)),
                     lambda off, n: mw_pairs(kcm.greek_plain_partials(
                         gops, SEED, off, gplan, n)), units=units(gplan))
            k41_gates(tag, gops, cops, gplan)

    def k44_contract(tag, xgops, plan, m, anti, wide=None):
        """K44 against its plain version, and with its scratch capped at 1
        float (every (block, iteration) its own group, the fold's carry
        between them) and at half its one-group scratch, bit-equal to one
        group."""
        contract(f"K44 {tag}",
                 lambda off, n: mw_pairs(kcm.xva_greek_partials(
                     xgops, SEED, off, plan, n, wide=wide)),
                 lambda off, n: mw_pairs(kcm.xva_greek_plain_partials(
                     xgops, SEED, off, plan, n)), units=units(plan))
        want = kcm.xva_greek_partials(xgops, SEED, 0, plan, nb, wide=wide)
        whole = _build.library().mctpu_xva_scratch_floats(
            m, xgops.n_grid, 1, int(bool(wide) or m > 8), nb, plan.rows,
            plan.iters, int(anti), 0)
        for cap in (1, whole // 2):
            got = kcm.xva_greek_partials(xgops, SEED, 0, plan, nb, wide=wide,
                                         scratch_cap=cap)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K44 {tag}: scratch capped at {cap} floats differs")
        phase("kernel-vs-plain", f"K44 {tag}: scratch capped at 1 and "
                                 f"{whole // 2} floats bit-equal to one "
                                 "group")

    # The bilateral xVA: K43 and K44 at 1, 2 (mixed), 3 and 8 (mixed), their
    # runtime-m kernels at 9 (mixed), 16, 17 (mixed) and 100 (mixed: the
    # register tiles 16 and 32 at their edges, then the scratch state) and
    # forced at 3 (mixed), 13 nodes, antithetic and Kahan rotated; the
    # profiles at RTOL; K44 also with its scratch capped; at own_intensity
    # = 0 and funding_spread = 0 K43's CVA sums and EPE profile equal K40's
    # bit for bit.
    for ka, (m, mixed, wide) in enumerate(((1, False, None), (2, True, None),
                                           (3, False, None), (8, True, None),
                                           (9, True, None), (16, False, None),
                                           (3, True, True), (17, True, None),
                                           (100, True, None))):
        anti, kahan = mw_variants[ka % 3]
        xs = xva_spec(cva_multi_spec(m, 13, mixed))
        chol = mcmath.cholesky_lower(xs.netting.corr)
        xops = kcm.xva_operands(xs, chol, dev)
        xgops = kcm.xva_operands(xs, chol, dev, greeks=True)
        plan = kcm.make_plan(nb * iters * rows * 128 * (2 if anti else 1),
                             nb, rows, anti, kahan, n_underlyings=1)
        wide_run = wide or m > 8
        tag = (f"m={m}{' mixed' if mixed else ''}"
               f"{' runtime-m' if wide_run else ''}"
               f"{' antithetic' if anti else ''}{'' if kahan else ' f32'}")
        contract(f"K43 {tag}",
                 lambda off, n: kcm.xva_partials(xops, SEED, off, plan, n,
                                                 wide=wide),
                 lambda off, n: kcm.xva_plain_partials(xops, SEED, off, plan,
                                                       n))
        k44_contract(tag, xgops, plan, m, anti, wide)
        if wide:  # the runtime-m kernels against K43's and K44's M = 3
            for got, want in zip(kcm.xva_partials(xops, SEED, 0, plan, nb,
                                                  wide=True),
                                 kcm.xva_partials(xops, SEED, 0, plan, nb)):
                close_rtol(got, want, f"K43 {tag} vs M=3")
            close_pairs(mw_pairs(kcm.xva_greek_partials(
                xgops, SEED, 0, plan, nb, wide=True)),
                mw_pairs(kcm.xva_greek_partials(xgops, SEED, 0, plan, nb)),
                units(plan), RTOL, f"K44 {tag} vs M=3")
        if m <= 8 and not wide:
            zs = xva_spec(xs.netting, own=0.0, spread=0.0)
            zsum, zprof = kcm.xva_partials(kcm.xva_operands(zs, chol, dev),
                                           SEED, 0, plan, nb)
            cops = kcm.operands(zs.netting, chol, dev)
            csum, cprof = kcm.partials(cops, SEED, 0, plan, nb)
            check(torch.equal(zsum[:, :2], csum)
                  and torch.equal(zprof[:, 0], cprof),
                  f"K43 {tag}: the CVA sums or EPE profile at no own "
                  "default and no funding differ from K40's")

    # K44's split at the other instances of its am kernel, 4 (512 threads)
    # to 7 (256), mixed legs, 13 nodes, antithetic and Kahan rotated, with
    # its scratch capped too.
    for ka, m in enumerate((4, 5, 6, 7)):
        anti, kahan = mw_variants[ka % 3]
        xs = xva_spec(cva_multi_spec(m, 13, True))
        xgops = kcm.xva_operands(xs, mcmath.cholesky_lower(xs.netting.corr),
                                 dev, greeks=True)
        plan = kcm.make_plan(nb * iters * rows * 128 * (2 if anti else 1),
                             nb, rows, anti, kahan, n_underlyings=1)
        k44_contract(f"m={m} mixed{' antithetic' if anti else ''}"
                     f"{'' if kahan else ' f32'}", xgops, plan, m, anti)

    # K44's runtime-m kernel at 13 rows, so that each block's last slice
    # holds 5 rows (its last pass with half its warps idle), against the
    # plain version: at 9 and 17 (the register tiles 16 and 32) and at 100
    # (the state in scratch), 7 nodes, mixed legs.
    for m, anti, kahan in ((9, False, True), (17, True, False),
                           (100, False, True)):
        xs = xva_spec(cva_multi_spec(m, 7, True))
        xgops = kcm.xva_operands(xs, mcmath.cholesky_lower(xs.netting.corr),
                                 dev, greeks=True)
        plan = kcm.make_plan(nb * iters * 13 * 128 * (2 if anti else 1), nb,
                             13, anti, kahan, n_underlyings=1)
        contract(f"K44 m={m} mixed runtime-m rows=13"
                 f"{' antithetic' if anti else ''}{'' if kahan else ' f32'}",
                 lambda off, n: mw_pairs(kcm.xva_greek_partials(
                     xgops, SEED, off, plan, n)),
                 lambda off, n: mw_pairs(kcm.xva_greek_plain_partials(
                     xgops, SEED, off, plan, n)), units=units(plan))

    # The control variates (K45-K48) at the a-priori float32 centers,
    # antithetic and Kahan each on and off: K45 at and deep in the money
    # (where d is exactly 0 on every path), K46 at an odd 13 dates and at
    # 50, K47 at 1, 3 (a Brownian offset d = 0.3) and 8 assets, K48 at 9,
    # 16, 17, 32 and 100 (its tiled product at a_tile 16, 32 and 128) and
    # on the pilot's plan of a 100-asset call (8 blocks, 102 iterations).
    cv_variants = ((False, True), (True, False), (True, True), (False, False))
    base3 = BasketOption.equicorrelated(3, 0.3)
    for label, copt, variants in (
            ("K45 k=100", VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0),
             cv_variants),
            ("K45 k=20", VanillaOption(100.0, 20.0, 0.05, 0.2, 1.0),
             cv_variants[:2]),
            ("K46 n_obs=13", ari13, cv_variants),
            ("K46 n_obs=50", dataclasses.replace(ari13, n_obs=50),
             cv_variants[:2]),
            ("K47 a=1", BasketOption.equicorrelated(1, 0.3), cv_variants[:2]),
            ("K47 a=3 d=0.3", dataclasses.replace(base3, d=np.full(3, 0.3)),
             cv_variants),
            ("K47 a=8", BasketOption.equicorrelated(8, 0.3), cv_variants[:2]),
            ("K48 a=9", BasketOption.equicorrelated(9, 0.3), cv_variants[:2]),
            ("K48 a=16", BasketOption.equicorrelated(16, 0.3), cv_variants),
            ("K48 a=17", BasketOption.equicorrelated(17, 0.3),
             cv_variants[1:3]),
            ("K48 a=32", BasketOption.equicorrelated(32, 0.3),
             cv_variants[2:]),
            ("K48 a=100", BasketOption.equicorrelated(100, 0.3),
             cv_variants[:2])):
        for anti, kahan in variants:
            cvs = variance.cv_setup(copt, 1, engine.EngineConfig(
                num_blocks=nb, rows=rows, antithetic=anti,
                precision=Precision.F32_KAHAN if kahan else Precision.F32,
                auto_shrink=False))
            plan = dataclasses.replace(cvs.plan, iters=iters)
            cops = cvs.operands(kvr.center32(cvs.center))
            contract(f"{label}{' antithetic' if anti else ''}"
                     f"{'' if kahan else ' f32'}",
                     lambda off, n: cvs.partials(cops, SEED, off, plan, n),
                     lambda off, n: cvs.plain_partials(cops, SEED, off, plan,
                                                       n),
                     units=units(plan), moments=True)
    for anti in (False, True):
        cvs = variance.cv_setup(BasketOption.equicorrelated(100, 0.3), 1 << 22,
                                engine.EngineConfig(antithetic=anti))
        plan = variance._pilot_plan(cvs.plan, 0.1)  # 8 x 102 (x 51)
        cops = cvs.operands(kvr.center32(cvs.center))
        contract(f"K48 a=100 pilot {plan.num_blocks} x {plan.iters}"
                 f"{' antithetic' if anti else ''}",
                 lambda off, n: cvs.partials(cops, SEED, off, plan, n),
                 lambda off, n: cvs.plain_partials(cops, SEED, off, plan, n),
                 units=units(plan), moments=True, blocks=plan.num_blocks)

    # K49 at the money and twice the spot, untilted and at the optimal
    # tilt (0 at the money); K50 and K51 on a put and a call at 1, 13 and 50 dates under a
    # rule fitted on a 2^15-path pilot; antithetic and Kahan each on and
    # off.  K51's price sums must equal K50's bit for bit.
    for kk in (100.0, 200.0):
        vopt = VanillaOption(100.0, kk, 0.05, 0.2, 1.0)
        for th in sorted({0.0, variance.optimal_tilt(vopt)}):
            ipar = kvr.is_params(vopt, th, dev)
            for anti, kahan in cv_variants:
                plan = kvanilla.make_plan(nb * iters * 2 * rows * 128, nb,
                                          rows, anti, kahan)
                contract(f"K49 k={kk:.0f} theta={th:.3f}"
                         f"{' antithetic' if anti else ''}"
                         f"{'' if kahan else ' f32'}",
                         lambda off, n: kvr.is_partials(ipar, SEED, off,
                                                        plan, n),
                         lambda off, n: kvr.is_plain_partials(ipar, SEED,
                                                              off, plan, n))
    for payoff in ("put", "call"):
        for n_steps in (1, 13, 50):
            aopt = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0,
                                  n_steps=n_steps, payoff=payoff)
            beta = lsm.fit_exercise_rule(100.0, 100.0, 0.05, 0.2, 1.0, SEED,
                                         1 << 15, n_steps, payoff,
                                         device=dev)
            lops = klsm.operands(aopt, beta, dev)
            is_put = payoff == "put"
            for anti, kahan in cv_variants:
                plan = klsm.make_plan(nb * iters * rows * 128, nb, rows,
                                      anti, kahan)
                tag = (f"{payoff} n_steps={n_steps}"
                       f"{' antithetic' if anti else ''}"
                       f"{'' if kahan else ' f32'}")
                contract(f"K50 {tag}",
                         lambda off, n: klsm.partials(lops, SEED, off, plan,
                                                      n, is_put),
                         lambda off, n: klsm.plain_partials(
                             lops, SEED, off, plan, n, is_put))
                contract(f"K51 {tag}",
                         lambda off, n: klsm.greek_partials(
                             lops, SEED, off, plan, n, is_put),
                         lambda off, n: klsm.greek_plain_partials(
                             lops, SEED, off, plan, n, is_put),
                         units=units(plan))
                check(torch.equal(
                    klsm.greek_partials(lops, SEED, 0, plan, nb, is_put)
                    [:, :2], klsm.partials(lops, SEED, 0, plan, nb, is_put)),
                    f"K51 {tag}: price sums differ from K50's")

    # The RQMC nets (K52-K55), 16 replicates of 3 chunks: K52 and K53 call
    # and put (rows 32), K54 at 3, 12 and 100 assets (c = 32, 8, 1), at
    # 300 on rows 8 and at 65 and 128 on rows 37 (the tiled design's ends,
    # chunk bases off the 32-point groups), K55 geometric and
    # arithmetic at 12 dates on rows 8 (a 1024-point chunk) and rows 24
    # (3072 points), at 50 dates on rows 163 (the Asian's cap) and at 252
    # dates on rows 32, and at 300 dates (the kernel's largest W array);
    # K55 at 1 date too, and its split net with the scratch capped at 1
    # float and at half, bit-equal to one group.
    # Each chunk's float32 sum depends on its order, so s and c each differ
    # between kernel and plain version while s + c agrees: the quads are
    # compared folded, K53's outputs by the scaled pair bound.
    # Two launches bitwise equal, block offsets bitwise, on the raw quads.
    def fold_quads(x):
        x = x.double()
        out = torch.empty((x.shape[0], x.shape[1] // 2), dtype=torch.float64,
                          device=x.device)
        out[:, 0::2] = x[:, 0::4] + x[:, 1::4]
        out[:, 1::2] = x[:, 2::4] + x[:, 3::4]
        return out

    def rqmc_contract(label, fn, plain, units=None):
        nr = 16
        got, again, tail = fn(0, nr), fn(0, nr), fn(2, nr - 2)
        want = plain(0, nr)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        check(torch.equal(got, again), f"{label}: launches differ")
        check(torch.equal(got[2:], tail), f"{label}: block offset")
        fg, fw = fold_quads(got), fold_quads(want)
        if units is None:
            close_rtol(fg, fw, label)
            worst = float(((fg - fw).abs() / fw.abs().clamp(min=1e-30)).max())
            what = "max rel err"
        else:
            worst = close_pairs(fg, fw, units, RTOL, label)
            what = "max err / scaled bound"
        phase("kernel-vs-plain", f"{label}: ok, folded {what} {worst:.2e}")

    rkey = qmc_engine.rqmc_key(SEED)
    for kind in ("call", "put"):
        vo = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
        is_put = kind == "put"
        plan = qmc_engine.rqmc_plan(3 * rows * 128, 16, rows)
        vops = krqmc.vanilla_operands(vo, dev)
        gops = krqmc.greek_operands(vo, dev)
        rqmc_contract(f"K52 {kind}",
                      lambda off, n: krqmc.vanilla_partials(
                          vops, rkey, off, plan, n, is_put),
                      lambda off, n: krqmc.vanilla_plain_partials(
                          vops, rkey, off, plan, n, is_put))
        rqmc_contract(f"K53 {kind}",
                      lambda off, n: krqmc.greek_partials(
                          gops, rkey, off, plan, n, is_put),
                      lambda off, n: krqmc.greek_plain_partials(
                          gops, rkey, off, plan, n, is_put),
                      units=plan.paths_per_block)
    for a, brows in ((3, rows), (12, rows), (100, rows), (300, 8), (65, 37),
                     (128, 37)):
        bopt = BasketOption.equicorrelated(a, 0.3)
        c = kbasket.pack_factor(a)[1]
        plan = qmc_engine.rqmc_plan(3 * brows * c, 16, brows,
                                    pts_per_chunk=brows * c)
        bops = krqmc.basket_operands(bopt, mcmath.cholesky_lower(bopt.corr),
                                     dev)
        rqmc_contract(f"K54 a={a} (c={c}, rows={brows})",
                      lambda off, n: krqmc.basket_partials(
                          bops, rkey, off, plan, n),
                      lambda off, n: krqmc.basket_plain_partials(
                          bops, rkey, off, plan, n))
    for m, arows, avgs in ((1, 8, ("arithmetic",)),
                           (12, 8, ("geometric", "arithmetic")),
                           (12, 24, ("geometric", "arithmetic")),
                           (50, 163, ("geometric", "arithmetic")),
                           (252, 32, ("geometric", "arithmetic")),
                           (300, 8, ("arithmetic",))):
        for avg in avgs:
            aops = krqmc.asian_operands(AsianOption(
                100.0, 100.0, 0.05, 0.2, 1.0, n_obs=m, average=avg), dev)
            plan = qmc_engine.rqmc_plan(3 * arows * 128, 16, arows)
            geo = avg == "geometric"
            rqmc_contract(f"K55 {avg} n_obs={m} rows={arows}",
                          lambda off, n: krqmc.asian_partials(
                              aops, rkey, off, plan, n, geo),
                          lambda off, n: krqmc.asian_plain_partials(
                              aops, rkey, off, plan, n, geo))
            want = krqmc.asian_partials(aops, rkey, 0, plan, 16, geo)
            whole = _build.library().mctpu_rqmc_asian_scratch_floats(
                16, plan.paths_per_iter, plan.iters, 0)
            for cap in (1, whole // 2):
                check(torch.equal(krqmc.asian_partials(
                    aops, rkey, 0, plan, 16, geo, scratch_cap=cap), want),
                    f"K55 {avg} n_obs={m} rows={arows}: scratch capped at "
                    f"{cap} floats differs")
            phase("kernel-vs-plain", f"K55 {avg} n_obs={m} rows={arows} "
                                     f"split: scratch capped at 1 and "
                                     f"{whole // 2} floats bit-equal to one "
                                     "group")

    # ---- 4a. the pricing path at real size ------------------------------
    counters = (kvanilla.LAUNCHES, kbasket.LAUNCHES, kcva.LAUNCHES,
                kgreeks.LAUNCHES, kasian.LAUNCHES, kbarrier.LAUNCHES,
                klookback.LAUNCHES, kcliquet.LAUNCHES, kladder.LAUNCHES,
                kbook.LAUNCHES, kvarswap.LAUNCHES, kbb.LAUNCHES,
                kheston.LAUNCHES, kmw.LAUNCHES, krainbow.LAUNCHES,
                kcm.LAUNCHES, kvr.LAUNCHES, klsm.LAUNCHES, krqmc.LAUNCHES)

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

    # ---- 4c. the exotic path at full width ------------------------------
    reset_counts()
    t_exotic = time.perf_counter()
    exotic_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(EXOTIC_KERNELS))
    phase("exotic-path", f"done in {time.perf_counter() - t_exotic:.1f} s")

    # ---- 4d. the lookback/cliquet path at full width -----------------------
    reset_counts()
    t_lc = time.perf_counter()
    lookback_cliquet_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(LOOKBACK_KERNELS + CLIQUET_KERNELS))
    phase("lookback-cliquet-path",
          f"done in {time.perf_counter() - t_lc:.1f} s")

    # ---- 4e. the strike-ladder and vanilla-book path at full width -------
    reset_counts()
    t_book = time.perf_counter()
    book_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(BOOK_KERNELS))
    phase("book-path", f"done in {time.perf_counter() - t_book:.1f} s")

    # ---- 4f. the variance-swap path at full width ------------------------
    reset_counts()
    t_vs = time.perf_counter()
    varswap_path(mctpu_torch)
    torch.cuda.synchronize()
    launches.update(read_counts(VARSWAP_KERNELS))
    phase("varswap-path", f"done in {time.perf_counter() - t_vs:.1f} s")

    # ---- 4g. the barrier-book path at full width -------------------------
    reset_counts()
    t_bb = time.perf_counter()
    barrier_book_path(mctpu_torch)
    torch.cuda.synchronize()
    launches.update(read_counts(BARRIER_BOOK_KERNELS))
    phase("barrier-book-path", f"done in {time.perf_counter() - t_bb:.1f} s")

    # ---- 4h. the Heston path at full width -------------------------------
    reset_counts()
    t_h = time.perf_counter()
    heston_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(HESTON_KERNELS))
    phase("heston-path", f"done in {time.perf_counter() - t_h:.1f} s")

    # ---- 4i. the multi-asset walk path at full width ---------------------
    reset_counts()
    t_mw = time.perf_counter()
    multi_walk_path(mctpu_torch)
    torch.cuda.synchronize()
    launches.update(read_counts(MULTI_WALK_KERNELS))
    phase("multi-walk-path", f"done in {time.perf_counter() - t_mw:.1f} s")

    # ---- 4j. the rainbow path at full width ------------------------------
    reset_counts()
    t_rb = time.perf_counter()
    rainbow_path(mctpu_torch)
    torch.cuda.synchronize()
    launches.update(read_counts(RAINBOW_KERNELS))
    phase("rainbow-path", f"done in {time.perf_counter() - t_rb:.1f} s")

    # ---- 4k. the netting-set CVA path at full width ----------------------
    reset_counts()
    t_cm = time.perf_counter()
    cva_multi_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(CVA_MULTI_KERNELS))
    phase("cva-multi-path", f"done in {time.perf_counter() - t_cm:.1f} s")

    # ---- 4l. the bilateral xVA path at full width -------------------------
    reset_counts()
    t_xva = time.perf_counter()
    xva_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(XVA_KERNELS))
    phase("xva-path", f"done in {time.perf_counter() - t_xva:.1f} s")

    # ---- 4m. the control-variate path at full width ----------------------
    reset_counts()
    t_cv = time.perf_counter()
    varred_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(CV_KERNELS))
    phase("cv-path", f"done in {time.perf_counter() - t_cv:.1f} s")

    # ---- 4n. the American and importance-sampling path at full width ----
    reset_counts()
    t_am = time.perf_counter()
    american_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(AMERICAN_KERNELS))
    phase("american-path", f"done in {time.perf_counter() - t_am:.1f} s")

    # ---- 4o. the MLMC path at the CLI's shapes --------------------------
    reset_counts()
    t_ml = time.perf_counter()
    mlmc_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(MLMC_KERNELS))
    phase("mlmc-path", f"done in {time.perf_counter() - t_ml:.1f} s")

    # ---- 4p. the RQMC path at the CLIs' defaults -------------------------
    reset_counts()
    t_rq = time.perf_counter()
    rqmc_path(mctpu_torch, mcmath)
    torch.cuda.synchronize()
    launches.update(read_counts(RQMC_KERNELS))
    phase("rqmc-path", f"done in {time.perf_counter() - t_rq:.1f} s")

    # ---- 5. launch counters ----------------------------------------------
    all_kernels = (PRICE_KERNELS + GREEK_KERNELS + EXOTIC_KERNELS
                   + LOOKBACK_KERNELS + CLIQUET_KERNELS + BOOK_KERNELS
                   + VARSWAP_KERNELS + BARRIER_BOOK_KERNELS + HESTON_KERNELS
                   + MULTI_WALK_KERNELS + RAINBOW_KERNELS + CVA_MULTI_KERNELS
                   + XVA_KERNELS + CV_KERNELS + AMERICAN_KERNELS
                   + MLMC_KERNELS + RQMC_KERNELS)
    check(all(launches.get(k, 0) > 0 for k in all_kernels),
          f"a kernel of a main path never launched: {launches}")
    phase("launches", json.dumps(launches))

    # ---- 6. times at the phase-4 shapes ----------------------------------
    def median_ms(fn, reps=5):
        """The median over ``reps`` calls of a call's CUDA-event time (its
        launches on the device, and the host's time before its first
        launch), each call alone on an idle device; the caller's comparison
        run is the warm-up."""
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    kernels = []

    def estimates(outs, plan, disc):
        """The price (the ``(B, 2K)`` ladder's or book's prices, and, for
        CVA and xVA, the exposure profiles) the engine forms from these
        partials."""
        sums = pairwise_tree_sum(outs[0].double(), 0).cpu()
        vals = [mcest.estimate(sums[0::2], sums[1::2], plan.total_units,
                               discount=disc).price.reshape(-1)]
        if len(outs) > 1:
            vals.append(pairwise_tree_sum(outs[1].double(), 0).cpu()
                        .reshape(-1) / plan.total_units)
        return torch.cat(vals)

    def greek_estimates(outs, plan, disc, fold=None):
        """Every output's mean (price and each Greek) the engine forms
        from these Greek partials; ``fold = (c, a_tile, a)`` folds K8's and
        K33's slot vectors onto the assets."""
        vals = []
        for out in outs:
            total = pairwise_tree_sum(out.double(), 0).cpu()
            if total.ndim == 2:  # K8's, K33's slot vectors (rows, width)
                c, a_tile, a = fold
                total = pairwise_tree_sum(
                    total.reshape(total.shape[0], c, a_tile), 1)[:, :a]
            vals.append((disc * total[0::2] / plan.total_units).reshape(-1))
        return torch.cat(vals)

    def cv_price(out, plan, disc, p0):
        """The price the CV estimator forms from one run's moment sums,
        regressed on themselves, at the undiscounted center ``p0``."""
        m = pairwise_tree_sum(out.double(), 0).cpu()
        n = plan.total_units
        db = (m[4] - m[0] * m[2] / n) / (m[3] - m[2] * m[2] / n + 1e-300)
        return torch.stack([disc * (p0 + (m[0] - db * m[2]) / n)])

    def timed(kname, source, replaces, plan, steps, disc, kernel, plain,
              ops, in_bytes=64, units=None, fold=None, plain_reps=5,
              rtol=RTOL, cv_p0=None, record=True, quads=False, row=None):
        """``units`` per block given: Greek partials (scaled pair bound,
        every output's estimate in max_abs_err), or with ``cv_p0`` (the
        center) the control variates' moment sums (their bound, the CV
        price in max_abs_err).  ``quads``: the RQMC nets' unfolded
        ``[s, c, s2, c2]`` quads, compared and estimated folded.  ``ops``
        are the run's instruction counts (:func:`work`), ``in_bytes`` its
        operands' bytes.  ``record=False`` prints the line only (a kernel's
        second shape); ``row`` names a second shape's own line (K48's
        pilot), with the kernel's launches."""
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        out_bytes = sum(g.numel() * g.element_size() for g in got)
        if quads:
            got, want = ((fold_quads(got[0]),), (fold_quads(want[0]),))
        for g, w in zip(got, want):
            if cv_p0 is not None:
                close_moments(g, w, units, rtol, kname)
            elif units is None:
                close_rtol(g, w, kname)
            else:
                close_pairs(g, w, units, rtol, kname)
        # max_abs_err: kernel vs plain in the estimates, in price units.
        if cv_p0 is not None:
            err = float((cv_price(got[0], plan, disc, cv_p0)
                         - cv_price(want[0], plan, disc, cv_p0)).abs().max())
        elif units is None:
            err = float((estimates(got, plan, disc)
                         - estimates(want, plan, disc)).abs().max())
        else:
            err = float((greek_estimates(got, plan, disc, fold)
                         - greek_estimates(want, plan, disc, fold))
                        .abs().max())
        ms, plain_ms = median_ms(kernel), median_ms(plain, plain_reps)
        rate = plan.total_paths * steps / (ms * 1e-3)
        unit = "path-steps/s" if steps > 1 else "paths/s"
        bound_ms, bound_by, cls = bound(ops, in_bytes + out_bytes)
        phase("times", f"{row or kname}: kernel {ms:.3f} ms "
                       f"({rate:.4g} {unit}), "
                       f"plain {plain_ms:.3f} ms (median of {plain_reps}), "
                       f"{plan.num_blocks} blocks x {plan.iters} iters x rows "
                       f"{plan.rows}; bound {bound_ms:.4f} ms ({cls}; "
                       f"int32/f32/sfu {ops[0]:.3e}/{ops[1]:.3e}/"
                       f"{ops[2]:.3e}), {bound_ms / ms:.0%} of it reached; "
                       f"max_abs_err {err:.3e}; [{smi}]")
        # library_ms: no one PyTorch call computes any of these kernels'
        # functions (an in-kernel counter-based stream feeding per-block
        # compensated sums).
        if record:
            kernels.append({"name": row or kname, "route": "cuda",
                            "source": source,
                            "replaces": replaces, "launches": launches[kname],
                            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": None})

    plan, par = engine.vanilla_setup(opt, n_van, cfg)
    timed("vanilla", "mctpu_torch/csrc/vanilla.cu",
          "mctpu/kernels/vanilla.py:107", plan, 1, math.exp(-opt.r * opt.t),
          lambda: kvanilla.partials(par, SEED, 0, plan, plan.num_blocks,
                                    False),
          lambda: kvanilla.plain_partials(par, SEED, 0, plan,
                                          plan.num_blocks, False),
          work(draws=plan.total_paths, expf=plan.total_paths,
               f32=6 * plan.total_paths + 11 * plan.total_units))

    def basket_work(plan, a, per_asset, per_path, per_unit):
        """K2/K3 (K7/K8): a normals, a expf and the lower-triangular
        correlation product per path, ``per_asset`` and ``per_path`` float32
        operations beyond them, ``per_unit`` for the sums."""
        p = plan.total_paths
        return work(draws=p * a, expf=p * a,
                    f32=p * (a * (a + 1) / 2 + per_asset * a + per_path)
                    + per_unit * plan.total_units)
    for kname, label, replaces in (
            ("basket_am", "K2", "mctpu/kernels/basket.py:353"),
            ("basket_packed", "K3", "mctpu/kernels/basket.py:311")):
        bopt, n = basket_cells[label]
        plan, ops = engine.basket_setup(bopt, n, cfg)
        a = bopt.n_assets
        timed(kname, "mctpu_torch/csrc/basket.cu", replaces, plan, 1,
              math.exp(-bopt.r * bopt.t),
              lambda: kbasket.partials(ops, SEED, 0, plan, plan.num_blocks),
              lambda: kbasket.plain_partials(ops, SEED, 0, plan,
                                             plan.num_blocks),
              basket_work(plan, a, 4, 3, 11), in_bytes=4 * (a * a + 4 * a))
    port = CvaPortfolioSpec.from_single(
        CvaSpec(0.03, 0.6, VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0), 500))
    plan, ops = engine.cva_setup(port, 1 << 20, cfg)
    timed("cva", "mctpu_torch/csrc/cva.cu", "mctpu/kernels/cva.py:409", plan,
          500, 1.0,
          lambda: kcva.partials(ops, SEED, 0, plan, plan.num_blocks, False),
          lambda: kcva.plain_partials(ops, SEED, 0, plan, plan.num_blocks,
                                      False),
          walk_work("cva", plan, 500), in_bytes=4 * 7 * 500)

    def gunits(plan):
        return plan.iters * plan.units_per_iter

    plan, par = engine.greeks_vanilla_setup(opt, n_van, cfg)
    timed("greeks_vanilla", "mctpu_torch/csrc/greeks.cu",
          "mctpu/kernels/greeks.py:189", plan, 1, math.exp(-opt.r * opt.t),
          lambda: kgreeks.partials(par, SEED, 0, plan, plan.num_blocks,
                                   False),
          lambda: kgreeks.plain_partials(par, SEED, 0, plan, plan.num_blocks,
                                         False),
          work(draws=plan.total_paths, expf=plan.total_paths,
               f32=66 * plan.total_paths + 24 * plan.total_units),
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
              basket_work(plan, a, 29, 30, 24), in_bytes=4 * (a * a + 4 * a),
              units=gunits(plan), fold=(c, a_tile, a), plain_reps=3)
    plan, ops = engine.greeks_cva_setup(port, 1 << 20, cfg)
    timed("cva_greeks", "mctpu_torch/csrc/cva_greeks.cu",
          "mctpu/kernels/cva.py:742", plan, 500, 1.0,
          lambda: kcva.greek_partials(ops, SEED, 0, plan, plan.num_blocks,
                                      False),
          lambda: kcva.greek_plain_partials(ops, SEED, 0, plan,
                                            plan.num_blocks, False),
          walk_work("cva_greeks", plan, 500), in_bytes=4 * 12 * 500,
          units=gunits(plan), plain_reps=3)

    # The exotic path's shape: arithmetic Asian and up-and-out H=130 calls,
    # n_obs=50, 2^22 paths.
    n_ex = 1 << 22
    ari = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=50)
    uo = BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, barrier=130.0, n_obs=50)
    disc = math.exp(-0.05)
    for kname, replaces, kmod, wopt, greek in (
            ("asian", "mctpu/kernels/asian.py:344", kasian, ari, False),
            ("asian_greeks", "mctpu/kernels/asian.py:257", kasian, ari, True),
            ("barrier", "mctpu/kernels/barrier.py:305", kbarrier, uo, False),
            ("barrier_greeks", "mctpu/kernels/barrier.py:228", kbarrier, uo,
             True)):
        setup = engine.asian_setup if kmod is kasian else engine.barrier_setup
        plan, _ = setup(wopt, n_ex, cfg)
        fn, plain = walk_launchers(kmod, wopt, greek, dev)
        source = "mctpu_torch/csrc/" + kname.split("_")[0] + ".cu"
        timed(kname, source, replaces, plan, 50, disc,
              lambda: fn(0, plan.num_blocks, plan),
              lambda: plain(0, plan.num_blocks, plan),
              walk_work(kname, plan, 50),
              units=gunits(plan) if greek else None, plain_reps=3)

    # The lookback/cliquet path's shapes: the floating call at n_obs=50 and
    # 2^22 paths, the cliquet at 12 periods and 2^24 paths.
    fl = LookbackOption(100.0, 0.05, 0.2, 1.0, n_obs=50)
    cq = CliquetOption(100.0, 0.03, 0.2, 1.0, n_periods=12, cap=0.05,
                       floor=-0.02)
    for kname, replaces, kmod, wopt, greek, n_paths, steps, disc in (
            ("lookback", "mctpu/kernels/lookback.py:127", klookback, fl,
             False, n_ex, 50, math.exp(-0.05)),
            ("lookback_greeks", "mctpu/kernels/lookback.py:321", klookback,
             fl, True, n_ex, 50, math.exp(-0.05)),
            ("cliquet", "mctpu/kernels/cliquet.py:179", kcliquet, cq, False,
             1 << 24, 12, math.exp(-0.03)),
            ("cliquet_greeks", "mctpu/kernels/cliquet.py:241", kcliquet, cq,
             True, 1 << 24, 12, math.exp(-0.03))):
        setup = (engine.lookback_setup if kmod is klookback
                 else engine.cliquet_setup)
        plan, _ = setup(wopt, n_paths, cfg)
        fn, plain = walk_launchers(kmod, wopt, greek, dev)
        source = "mctpu_torch/csrc/" + kname.split("_")[0] + ".cu"
        timed(kname, source, replaces, plan, steps, disc,
              lambda: fn(0, plan.num_blocks, plan),
              lambda: plain(0, plan.num_blocks, plan),
              walk_work(kname, plan, steps),
              units=gunits(plan) if greek else None, plain_reps=3)

    # The book path's shapes: 64 strikes 50..150 on the call, and the
    # 64-instrument serving book, at 2^24 paths.
    n_bk = 1 << 24
    call = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
    ks64 = np.linspace(50.0, 150.0, 64)
    book64 = VanillaBook.serving(64)
    disc_lad = math.exp(-call.r * call.t)
    disc_book = torch.exp(-torch.as_tensor(book64.r) * torch.as_tensor(
        book64.t))
    plan, par, ks = engine.ladder_setup(call, ks64, n_bk, cfg)
    _, gp, _ = engine.greeks_vanilla_ladder_setup(call, ks64, n_bk, cfg)
    _, bpar = engine.book_setup(book64, n_bk, cfg)
    _, cvec = engine.greeks_book_setup(book64, n_bk, cfg)
    nbl = plan.num_blocks
    for kname, replaces, kernel, plain, disc, in_bytes, greek in (
            ("ladder", "mctpu/kernels/ladder.py:104",
             lambda: kladder.partials(par, ks, SEED, 0, plan, nbl, False),
             lambda: kladder.plain_partials(par, ks, SEED, 0, plan, nbl,
                                            False),
             disc_lad, 4 * (3 + 64), False),
            ("ladder_greeks", "mctpu/kernels/ladder.py:294",
             lambda: kladder.greek_partials(gp, ks, SEED, 0, plan, nbl,
                                            False),
             lambda: kladder.greek_plain_partials(gp, ks, SEED, 0, plan, nbl,
                                                  False),
             disc_lad, 4 * (9 + 64), True),
            ("book", "mctpu/kernels/book.py:122",
             lambda: kbook.partials(bpar, SEED, 0, plan, nbl),
             lambda: kbook.plain_partials(bpar, SEED, 0, plan, nbl),
             disc_book, 4 * 5 * 64, False),
            ("book_greeks", "mctpu/kernels/book.py:292",
             lambda: kbook.greek_partials(cvec, SEED, 0, plan, nbl),
             lambda: kbook.greek_plain_partials(cvec, SEED, 0, plan, nbl),
             disc_book.repeat_interleave(6), 4 * 13 * 64, True)):
        # The bound counts one draw per path, the least the function needs;
        # the groups' redraws are this design's cost, printed beside it.
        groups = -(-64 // BOOK_GROUPS[kname])
        redrawn = bound(book_work(kname, plan, 64), 0)
        phase("times", f"{kname}: {groups} groups of {BOOK_GROUPS[kname]}, "
                       f"so each normal is drawn {groups} times (the redraw "
                       f"factor); the bound below counts one draw per path, "
                       f"with the redraws counted it would be "
                       f"{redrawn[0]:.4f} ms ({redrawn[2]})")
        timed(kname, f"mctpu_torch/csrc/{kname.split('_')[0]}.cu", replaces,
              plan, 1, disc, lambda f=kernel: flat(f()),
              lambda f=plain: flat(f()),
              book_work(kname, plan, 64, redraw=False), in_bytes=in_bytes,
              units=gunits(plan) if greek else None, plain_reps=3)

    # The variance-swap path's shape: 252 dates, 2^22 paths.
    plan, vpar = engine.varswap_setup(vs_opt, n_ex, cfg, 252)
    _, vgp = engine.greeks_varswap_setup(vs_opt, n_ex, cfg, 252)
    nbl = plan.num_blocks
    for kname, replaces, kernel, plain, greek in (
            ("varswap", "mctpu/kernels/varswap.py:123",
             lambda: kvarswap.partials(vpar, SEED, 0, plan, nbl, 252),
             lambda: kvarswap.plain_partials(vpar, SEED, 0, plan, nbl, 252),
             False),
            ("varswap_greeks", "mctpu/kernels/varswap.py:382",
             lambda: kvarswap.greek_partials(vgp, SEED, 0, plan, nbl, 252),
             lambda: kvarswap.greek_plain_partials(vgp, SEED, 0, plan, nbl,
                                                   252),
             True)):
        timed(kname, "mctpu_torch/csrc/varswap.cu", replaces, plan, 252, 1.0,
              kernel, plain, walk_work(kname, plan, 252),
              units=gunits(plan) if greek else None, plain_reps=3)

    # The barrier-book path's shape: the 32-instrument serving book, 50
    # dates, 2^22 paths.
    bbook = BarrierBook.serving(32)
    plan, bpar = engine.barrier_book_setup(bbook, n_ex, cfg)
    _, bgp = engine.greeks_barrier_book_setup(bbook, n_ex, cfg)
    nbl = plan.num_blocks
    disc_bb = torch.exp(-torch.as_tensor(bbook.r) * torch.as_tensor(bbook.t))
    for kname, replaces, kernel, plain, disc, in_bytes, greek in (
            ("barrier_book", "mctpu/kernels/barrier_book.py:174",
             lambda: kbb.partials(bpar, SEED, 0, plan, nbl, 50),
             lambda: kbb.plain_partials(bpar, SEED, 0, plan, nbl, 50),
             disc_bb, 4 * 7 * 32, False),
            ("barrier_book_greeks", "mctpu/kernels/barrier_book.py:344",
             lambda: kbb.greek_partials(bgp, SEED, 0, plan, nbl, 50),
             lambda: kbb.greek_plain_partials(bgp, SEED, 0, plan, nbl, 50),
             disc_bb.repeat_interleave(4), 4 * 13 * 32, True)):
        timed(kname, "mctpu_torch/csrc/barrier_book.cu", replaces, plan, 50,
              disc, lambda f=kernel: flat(f()), lambda f=plain: flat(f()),
              bb_work(kname, plan, 32, 50), in_bytes=in_bytes,
              units=gunits(plan) if greek else None, plain_reps=3)

    # The Heston path's shapes: the reference option at 100 steps (Euler,
    # QE, Greeks) and the variance swap's Heston leg at 252 dates, 2^22
    # paths.
    plan, hpar = engine.heston_setup(h_opt, n_ex, cfg, 100, "euler")
    _, hqe = engine.heston_setup(h_opt, n_ex, cfg, 100, "qe")
    _, hgp = engine.greeks_heston_setup(h_opt, n_ex, cfg, 100)
    _, vhpar = engine.varswap_setup(h_vs, n_ex, cfg, 252)
    _, vhgp = engine.greeks_varswap_setup(h_vs, n_ex, cfg, 252)
    nbl = plan.num_blocks
    disc_h = math.exp(-h_opt.r * h_opt.t)
    for kname, source, replaces, kernel, plain, ops, steps, disc, greek in (
            ("heston", "heston.cu", "heston.py:137",
             lambda: kheston.partials(hpar, SEED, 0, plan, nbl, 100, False),
             lambda: kheston.plain_partials(hpar, SEED, 0, plan, nbl, 100,
                                            False), hpar, 100, disc_h, False),
            ("heston_qe", "heston.cu", "heston.py:137",
             lambda: kheston.partials(hqe, SEED, 0, plan, nbl, 100, True),
             lambda: kheston.plain_partials(hqe, SEED, 0, plan, nbl, 100,
                                            True), hqe, 100, disc_h, False),
            ("heston_greeks", "heston.cu", "heston.py:337",
             lambda: kheston.greek_partials(hgp, SEED, 0, plan, nbl, 100),
             lambda: kheston.greek_plain_partials(hgp, SEED, 0, plan, nbl,
                                                  100), hgp, 100, disc_h,
             True),
            ("varswap_heston", "varswap.cu", "varswap.py:143",
             lambda: kvarswap.partials(vhpar, SEED, 0, plan, nbl, 252),
             lambda: kvarswap.plain_partials(vhpar, SEED, 0, plan, nbl, 252),
             vhpar, 252, 1.0, False),
            ("varswap_heston_greeks", "varswap.cu", "varswap.py:410",
             lambda: kvarswap.greek_partials(vhgp, SEED, 0, plan, nbl, 252),
             lambda: kvarswap.greek_plain_partials(vhgp, SEED, 0, plan, nbl,
                                                   252), vhgp, 252, 1.0,
             True)):
        timed(kname, f"mctpu_torch/csrc/{source}", f"mctpu/kernels/{replaces}",
              plan, steps, disc, kernel, plain, walk_work(kname, plan, steps),
              in_bytes=4 * ops.numel(), units=gunits(plan) if greek else None,
              plain_reps=3)
    # K27 Euler at level 0 of mctpu's MLMC default: 8 steps, 2^20 paths on
    # its 8 x 8 level plan (8 x 128 x 8), a second shape's line.
    from mctpu_torch import mlmc
    plan8 = mlmc._level_plan(1 << 20, engine.EngineConfig(num_blocks=8,
                                                          rows=8))
    hpar8 = kheston.params(h_opt, 8, False, dev)
    timed("heston", "mctpu_torch/csrc/heston.cu", "mctpu/kernels/heston.py:137",
          plan8, 8, disc_h,
          lambda: kheston.partials(hpar8, SEED, 0, plan8, plan8.num_blocks, 8,
                                   False),
          lambda: kheston.plain_partials(hpar8, SEED, 0, plan8,
                                         plan8.num_blocks, 8, False),
          walk_work("heston", plan8, 8), in_bytes=4 * hpar8.numel(),
          plain_reps=3, record=False, row="heston MLMC 8 x 8 level 0")

    # The multi-asset walk path's shapes: default_reference(3) and
    # equicorrelated(16) at 50 dates and 2^22 paths (the Asian, and the
    # up-and-out at H=130); the Greeks on equicorrelated(3, 0.3), the
    # Asian's at 16 dates and 2^24 paths, the knock-out's at H=130, 50
    # dates and 2^23; K33 on equicorrelated(16, 0.3) at 12 dates and K35 at
    # H=130 and 50 dates, 2^22 (their lane rows folded onto the assets for
    # max_abs_err).
    eq16 = BasketOption.equicorrelated(16)
    eq3 = BasketOption.equicorrelated(3, 0.3)
    mw_cells = (
        ("basket_asian_am", "multi_walk.py:369", BasketAsianOption(
            BasketOption.default_reference(3), n_obs=50), n_ex),
        ("basket_barrier_am", "multi_walk.py:369", BasketBarrierOption(
            BasketOption.default_reference(3), 130.0, n_obs=50), n_ex),
        ("basket_asian_packed", "multi_walk.py:316",
         BasketAsianOption(eq16, n_obs=50), n_ex),
        ("basket_barrier_packed", "multi_walk.py:316",
         BasketBarrierOption(eq16, 130.0, n_obs=50), n_ex),
        ("basket_asian_greeks_am", "multi_walk.py:1154",
         BasketAsianOption(eq3, n_obs=16), 1 << 24),
        ("basket_asian_greeks_packed", "multi_walk.py:630",
         BasketAsianOption(BasketOption.equicorrelated(16, 0.3), n_obs=12),
         n_ex),
        ("basket_barrier_greeks_am", "multi_walk.py:1347",
         BasketBarrierOption(eq3, 130.0, n_obs=50), 1 << 23),
        ("basket_barrier_greeks_packed", "multi_walk.py:933",
         BasketBarrierOption(BasketOption.equicorrelated(16, 0.3), 130.0,
                             n_obs=50), n_ex))
    for kname, replaces, mopt, n_paths in mw_cells:
        bk, a = mopt.basket, mopt.basket.n_assets
        barrier = isinstance(mopt, BasketBarrierOption)
        product = "barrier" if barrier else "asian"
        greek = "greeks" in kname
        fold = None
        if greek and barrier and not kbasket.use_asset_major(a):
            plan, ops = engine.greeks_basket_barrier_setup(mopt, n_paths,
                                                           cfg)
            a_tile, c, _ = kbasket.pack_factor(a)
            fold = (c, a_tile, a)
            kernel = (lambda o=ops, m=mopt: kmw.bar_greek_partials(
                *o, SEED, 0, plan, nbl, m.n_obs, True))
            pl = (lambda o=ops, m=mopt: kmw.packed_bar_greek_plain_partials(
                *o, SEED, 0, plan, nbl, m.n_obs, True))
        elif greek and not kbasket.use_asset_major(a):
            plan, ops = engine.greeks_basket_asian_setup(mopt, n_paths, cfg)
            a_tile, c, _ = kbasket.pack_factor(a)
            fold = (c, a_tile, a)
            kernel = (lambda o=ops, m=mopt: kmw.am_greek_partials(
                *o, SEED, 0, plan, nbl, m.n_obs))
            pl = (lambda o=ops, m=mopt: kmw.packed_greek_plain_partials(
                *o, SEED, 0, plan, nbl, m.n_obs))
        elif greek and barrier:
            plan, ops = engine.greeks_basket_barrier_setup(mopt, n_paths, cfg)
            fn = kmw.am_bar_greek_partials
            plain = kmw.am_bar_greek_plain_partials
            extra = (True,)
        elif greek:
            plan, ops = engine.greeks_basket_asian_setup(mopt, n_paths, cfg)
            fn, plain = kmw.am_greek_partials, kmw.am_greek_plain_partials
            extra = ()
        else:
            setup = (engine.basket_barrier_setup if barrier
                     else engine.basket_asian_setup)
            plan, ops = setup(mopt, n_paths, cfg)
            fn, plain = kmw.partials, kmw.plain_partials
            extra = (product, mopt.n_obs, True)
        nbl = plan.num_blocks
        if greek and fold is None:
            extra = (mopt.n_obs,) + extra
            kernel = (lambda f=fn, o=ops, e=extra:
                      mw_pairs(f(*o, SEED, 0, plan, nbl, *e)))
            pl = (lambda f=plain, o=ops, e=extra:
                  mw_pairs(f(*o, SEED, 0, plan, nbl, *e)))
        elif fold is None:
            kernel = lambda f=fn, o=ops, e=extra: f(*o, SEED, 0, plan, nbl, *e)
            pl = lambda f=plain, o=ops, e=extra: f(*o, SEED, 0, plan, nbl, *e)
        timed(kname, "mctpu_torch/csrc/multi_walk.cu",
              f"mctpu/kernels/{replaces}", plan, mopt.n_obs,
              math.exp(-bk.r * bk.t), kernel, pl,
              mw_work(kname, plan, a, mopt.n_obs),
              in_bytes=4 * sum(x.numel() for x in ops),
              units=gunits(plan) if greek else None, fold=fold, plain_reps=3)

    # The rainbow path's shapes: the JAX exotic CLI's max of 3 (K36) and
    # tests/test_rainbow.py's max of 16 (K37, 2^22 paths), the JAX Greeks
    # CLI's max of 3 (K38), 2^24 paths.
    rb_opt = RainbowOption.equicorrelated
    rb_cells = (
        ("rainbow_am", "rainbow.py:267",
         rb_opt([100.0] * 3, [0.2, 0.3, 0.2], 0.3, 100.0, 0.05), 1 << 24),
        ("rainbow_packed", "rainbow.py:231",
         rb_opt([100.0] * 16, [0.25] * 16, 0.3, 110.0, 0.05), n_ex),
        ("rainbow_greeks", "rainbow.py:493",
         rb_opt([100.0, 95.0, 90.0], [0.2, 0.25, 0.3], 0.5, 100.0, 0.04879),
         1 << 24))
    for kname, replaces, ropt, n_paths in rb_cells:
        a = ropt.n_assets
        if kname == "rainbow_greeks":
            plan, gops = engine.greeks_rainbow_setup(ropt, n_paths, cfg)
            kernel = (lambda o=gops, p=plan: krainbow.greek_partials(
                o, SEED, 0, p, p.num_blocks))
            pl = (lambda o=gops, p=plan: krainbow.greek_plain_partials(
                o, SEED, 0, p, p.num_blocks))
            in_bytes = 4 * (4 + a * a + 4 * a)
        else:
            plan, rops = engine.rainbow_setup(ropt, n_paths, cfg)
            kernel = (lambda o=rops, p=plan: krainbow.partials(
                o, SEED, 0, p, p.num_blocks))
            pl = (lambda o=rops, p=plan: krainbow.plain_partials(
                o, SEED, 0, p, p.num_blocks))
            in_bytes = 4 * (1 + a * a + 3 * a)
        timed(kname, "mctpu_torch/csrc/rainbow.cu",
              f"mctpu/kernels/{replaces}", plan, 1,
              math.exp(-ropt.r * ropt.t), kernel, pl,
              rb_work(kname, plan, a), in_bytes=in_bytes,
              units=gunits(plan) if kname == "rainbow_greeks" else None,
              plain_reps=3)

    # The netting-set CVA path's shapes, 2^20 paths: the JAX exotic CLI's
    # set at 3 underlyings (K40) and 16 (K39), 50 nodes; the JAX Greeks
    # CLI's set at 3 (K42) and --assets 16 (K41), 12 nodes.
    cm_cells = (
        ("cva_multi_am", "cva_multi.py:780", cva_multi_spec(3, 50)),
        ("cva_multi_packed", "cva_multi.py:201", cva_multi_spec(16, 50)),
        ("cva_multi_greeks_am", "cva_multi.py:986", cva_greeks_cli_spec()),
        ("cva_multi_greeks_packed", "cva_multi.py:508",
         cva_greeks_cli_spec(16)))
    for kname, replaces, cspec in cm_cells:
        m, g = cspec.n_underlyings, cspec.n_grid
        greek = "greeks" in kname
        fold = None
        if greek:
            plan, cops = engine.greeks_cva_multi_setup(cspec, 1 << 20, cfg)
        else:
            plan, cops = engine.price_cva_multi_setup(cspec, 1 << 20, cfg)
        if greek and not kbasket.use_asset_major(m):
            a_tile, c, _ = kbasket.pack_factor(m)
            fold = (c, a_tile, m)
            kernel = (lambda o=cops, p=plan: kcm.greek_partials(
                o, SEED, 0, p, p.num_blocks))
            pl = (lambda o=cops, p=plan: kcm.greek_plain_partials(
                o, SEED, 0, p, p.num_blocks))
        elif greek:
            kernel = (lambda o=cops, p=plan: mw_pairs(kcm.greek_partials(
                o, SEED, 0, p, p.num_blocks)))
            pl = (lambda o=cops, p=plan: mw_pairs(kcm.greek_plain_partials(
                o, SEED, 0, p, p.num_blocks)))
        else:
            kernel = (lambda o=cops, p=plan: kcm.partials(o, SEED, 0, p,
                                                          p.num_blocks))
            pl = (lambda o=cops, p=plan: kcm.plain_partials(o, SEED, 0, p,
                                                            p.num_blocks))
        timed(kname, "mctpu_torch/csrc/cva_multi.cu",
              f"mctpu/kernels/{replaces}", plan, g, 1.0, kernel, pl,
              cva_work(kname, plan, m, g),
              in_bytes=4 * sum(x.numel() for x in (cops.scal, cops.lt,
                                                   cops.par, cops.nodes)),
              units=gunits(plan) if greek else None, fold=fold,
              plain_reps=3)

    # The xVA path's shapes, 2^20 paths: the JAX exotic CLI's --product xva
    # at 3 underlyings (K43) and 16 (its runtime-m kernel), 50 nodes; the
    # JAX Greeks CLI's at 3 (K44) and 16 (runtime-m), 12 nodes.  mctpu has
    # no Pallas kernel past 8 underlyings: the runtime-m kernels stand in
    # for K43 and K44 there.
    xva_cells = (
        ("xva_am", "cva_multi.py:1189", xva_spec(cva_multi_spec(3, 50))),
        ("xva_wide", "cva_multi.py:1189", xva_spec(cva_multi_spec(16, 50))),
        ("xva_greeks_am", "cva_multi.py:1471",
         xva_spec(cva_greeks_cli_spec(3))),
        ("xva_greeks_wide", "cva_multi.py:1471",
         xva_spec(cva_greeks_cli_spec(16))))
    for kname, replaces, xs in xva_cells:
        m, g = xs.netting.n_underlyings, xs.netting.n_grid
        greek = "greeks" in kname
        setup = engine.greeks_xva_setup if greek else engine.price_xva_setup
        plan, xops = setup(xs, 1 << 20, cfg)
        if greek:
            kernel = (lambda o=xops, p=plan: mw_pairs(kcm.xva_greek_partials(
                o, SEED, 0, p, p.num_blocks)))
            pl = (lambda o=xops, p=plan: mw_pairs(
                kcm.xva_greek_plain_partials(o, SEED, 0, p, p.num_blocks)))
        else:
            kernel = (lambda o=xops, p=plan: kcm.xva_partials(
                o, SEED, 0, p, p.num_blocks))
            pl = (lambda o=xops, p=plan: kcm.xva_plain_partials(
                o, SEED, 0, p, p.num_blocks))
        timed(kname, "mctpu_torch/csrc/cva_multi.cu",
              f"mctpu/kernels/{replaces}", plan, g, 1.0, kernel, pl,
              cva_work(kname, plan, m, g),
              in_bytes=4 * sum(x.numel() for x in (xops.scal, xops.lt,
                                                   xops.par, xops.nodes)),
              units=gunits(plan) if greek else None, plain_reps=3)
    # K43 = K40 at the timed shape, both signs: at no own default and no
    # funding K43's split and fold give K40's CVA sums and EPE profile bit
    # for bit (one walk, one order of additions).
    tie_net = cva_multi_spec(3, 50)
    for anti in (False, True):
        c = dataclasses.replace(cfg, antithetic=anti)
        plan, xops = engine.price_xva_setup(
            xva_spec(tie_net, own=0.0, spread=0.0), 1 << 20, c)
        _, cops = engine.price_cva_multi_setup(tie_net, 1 << 20, c)
        xsum, xprof = kcm.xva_partials(xops, SEED, 0, plan, plan.num_blocks)
        csum, cprof = kcm.partials(cops, SEED, 0, plan, plan.num_blocks)
        check(torch.equal(xsum[:, :2], csum) and torch.equal(xprof[:, 0],
                                                             cprof),
              f"K43 m=3{' antithetic' if anti else ''} at 2^20: the CVA sums "
              "or EPE profile at no own default and no funding differ from "
              "K40's")
    phase("times", "K43 = K40 at m=3, 50 nodes, 2^20, plain and "
                   "antithetic: CVA sums and EPE profile bit for bit")

    # The control-variate path's shapes (the JAX exotic CLI's --product cv
    # at its defaults): K45 the call at 2^28, K46 the arithmetic Asian at
    # n_obs=50 and 2^22, K47 equicorrelated(3, 0.3) at 2^24, K48
    # equicorrelated(100, 0.3) at 2^22; the main run's plan at the a-priori
    # float32 centers.
    cv_cells = (
        ("vanilla_cv", "varred.py:167",
         VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0), 1 << 28),
        ("asian_cv", "varred.py:273", ari, n_ex),
        ("basket_cv_am", "varred.py:402", BasketOption.equicorrelated(3, 0.3),
         1 << 24),
        ("basket_cv_packed", "varred.py:430",
         BasketOption.equicorrelated(100, 0.3), n_ex))
    for kname, replaces, copt, n in cv_cells:
        cvs = variance.cv_setup(copt, n, cfg)
        cops = cvs.operands(kvr.center32(cvs.center))
        a = getattr(copt, "n_assets", 1)
        steps = getattr(copt, "n_obs", 1)
        if kname.startswith("basket"):
            in_bytes = 4 * sum(x.numel() for x in (cops.scal, cops.lt,
                                                   cops.par))
        else:
            in_bytes = 4 * cops.numel()  # the six scalars
        timed(kname, "mctpu_torch/csrc/varred.cu",
              f"mctpu/kernels/{replaces}", cvs.plan, steps,
              math.exp(-copt.r * copt.t),
              lambda s=cvs, o=cops: s.partials(o, SEED, 0, s.plan,
                                               s.plan.num_blocks),
              lambda s=cvs, o=cops: s.plain_partials(o, SEED, 0, s.plan,
                                                     s.plan.num_blocks),
              cv_work(kname, cvs.plan, a, steps), in_bytes=in_bytes,
              units=gunits(cvs.plan), plain_reps=3, cv_p0=cvs.center[0])
        if kname == "basket_cv_packed":  # its pilot launch, 8 x 102 x 256
            pilot = variance._pilot_plan(cvs.plan, 0.1)
            timed(kname, "mctpu_torch/csrc/varred.cu",
                  f"mctpu/kernels/{replaces}", pilot, steps,
                  math.exp(-copt.r * copt.t),
                  lambda s=cvs, o=cops, p=pilot: s.partials(
                      o, SEED, 0, p, p.num_blocks),
                  lambda s=cvs, o=cops, p=pilot: s.plain_partials(
                      o, SEED, 0, p, p.num_blocks),
                  cv_work(kname, pilot, a, steps), in_bytes=in_bytes,
                  units=gunits(pilot), plain_reps=3, cv_p0=cvs.center[0],
                  row="basket_cv_packed_pilot")

    # The American path's shapes: K49 at the exotic CLI's --product is
    # (K = 200, 2^28 paths at the optimal tilt); K50 and K51 on the put at
    # 50 dates and 2^22 paths and K51 at the Greeks CLI's 12 dates and
    # 2^20, each on the default EngineConfig's plan (no antithetic) under
    # its pilot-fitted rule.
    deep = VanillaOption(100.0, 200.0, 0.05, 0.2, 1.0)
    plan = engine._terminal_plan(1 << 28, cfg)
    ipar = kvr.is_params(deep, variance.optimal_tilt(deep), dev)
    timed("vanilla_is", "mctpu_torch/csrc/varred.cu",
          "mctpu/kernels/varred.py:567", plan, 1, math.exp(-0.05),
          lambda: kvr.is_partials(ipar, SEED, 0, plan, plan.num_blocks),
          lambda: kvr.is_plain_partials(ipar, SEED, 0, plan,
                                        plan.num_blocks),
          is_work(plan), in_bytes=4 * 5, plain_reps=3)
    for kname, replaces, n_steps, n, record in (
            ("lsm", "mctpu/kernels/lsm.py:149", 50, n_ex, True),
            ("lsm_greeks", "mctpu/kernels/lsm.py:383", 50, n_ex, True),
            ("lsm_greeks", "mctpu/kernels/lsm.py:383", 12, 1 << 20, False)):
        aopt = AmericanOption(100.0, 100.0, 0.05, 0.2, 1.0, n_steps=n_steps)
        beta = lsm.fit_exercise_rule(100.0, 100.0, 0.05, 0.2, 1.0, SEED,
                                     1 << 15, n_steps, "put", device=dev)
        plan, lops = engine.american_setup(aopt, beta, n, cfg)
        greek = kname == "lsm_greeks"
        fn = klsm.greek_partials if greek else klsm.partials
        plain = klsm.greek_plain_partials if greek else klsm.plain_partials
        timed(kname, "mctpu_torch/csrc/lsm.cu", replaces, plan, n_steps, 1.0,
              lambda f=fn, o=lops, p=plan: f(o, SEED, 0, p, p.num_blocks,
                                             True),
              lambda f=plain, o=lops, p=plan: f(o, SEED, 0, p, p.num_blocks,
                                                True),
              walk_work(kname, plan, n_steps),
              in_bytes=4 * sum(x.numel() for x in (lops.scal, lops.beta,
                                                   lops.tables)),
              units=gunits(plan) if greek else None, plain_reps=3,
              record=record)

    # The MLMC path's level kernels at 2^22 paths on the level plan of the
    # default EngineConfig (mlmc._level_plan): K29 at level 4 of n0 = 8 (128
    # fine steps) on the reference option, K11 arithmetic at level 4 of n0 =
    # 4 (64 dates), K14 up-and-out at H = 130 at level 3 of n0 = 8 (64
    # dates).  max_abs_err is in discounted level means.
    plan = mlmc._level_plan(n_ex, cfg)
    nbl = plan.num_blocks
    disc_m = math.exp(-0.05)
    hlp = kheston.level_params(h_opt, 128, dev)
    alp = kasian.level_params(ari, 64, dev)
    blp = kbarrier.level_params(
        BarrierOption(100.0, 100.0, 0.05, 0.2, 1.0, barrier=130.0, n_obs=8),
        64, dev)
    for kname, source, replaces, kernel, plain, ops, steps in (
            ("heston_level", "heston.cu", "heston.py:511",
             lambda: kheston.level_partials(hlp, SEED, 0, plan, nbl, 128),
             lambda: kheston.level_plain_partials(hlp, SEED, 0, plan, nbl,
                                                  128), hlp, 128),
            ("asian_level", "asian.cu", "asian.py:491",
             lambda: kasian.level_partials(alp, SEED, 0, plan, nbl, 64,
                                           False),
             lambda: kasian.level_plain_partials(alp, SEED, 0, plan, nbl, 64,
                                                 False), alp, 64),
            ("barrier_level", "barrier.cu", "barrier.py:471",
             lambda: kbarrier.level_partials(blp, SEED, 0, plan, nbl, 64,
                                             True),
             lambda: kbarrier.level_plain_partials(blp, SEED, 0, plan, nbl,
                                                   64, True), blp, 64)):
        timed(kname, f"mctpu_torch/csrc/{source}", f"mctpu/kernels/{replaces}",
              plan, steps, disc_m, kernel, plain,
              walk_work(kname, plan, steps), in_bytes=4 * ops.numel(),
              units=gunits(plan), plain_reps=3)

    # The RQMC path's nets at PERF.md's section 4 shapes, 16 replicates on
    # the default EngineConfig's layout: K52 and K53 at 2^24 points a
    # replicate (rows 256), K54 at equicorrelated(3, 0.3) 2^20 (c = 32) and
    # (100, 0.3) 2^18 (c = 1), K55 arithmetic at 50 dates 2^18 (rows 163)
    # and geometric at 252 dates 2^16 (rows 32).  max_abs_err is in the
    # replicate-mean estimates (every Greek's for K53); the bytes are the
    # operands, the chunk scratch written and read, the quads.
    def rqmc_bytes(ops, plan, n_sums):
        tabs = sum(x.numel() * x.element_size() for x in (
            ops.par, ops.v, ops.low, ops.lt, ops.rows, ops.drift, ops.bridge)
            if x is not None)
        return tabs + 8 * plan.num_blocks * plan.iters * n_sums

    rq_van = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0)
    for kname, replaces, greek in (
            ("rqmc_vanilla", "mctpu/qmc_engine.py:288", False),
            ("rqmc_greeks", "mctpu/qmc_engine.py:395", True)):
        plan, rops = qmc_engine.vanilla_rqmc_setup(rq_van, 1 << 24, cfg, 16,
                                                   greeks=greek)
        fn = krqmc.greek_partials if greek else krqmc.vanilla_partials
        plain = (krqmc.greek_plain_partials if greek
                 else krqmc.vanilla_plain_partials)
        timed(kname, "mctpu_torch/csrc/rqmc.cu", replaces, plan, 1,
              math.exp(-0.048790),
              lambda f=fn, o=rops, p=plan: f(o, rkey, 0, p, 16, False),
              lambda f=plain, o=rops, p=plan: f(o, rkey, 0, p, 16, False),
              rqmc_work(kname, plan),
              in_bytes=rqmc_bytes(rops, plan, 16 if greek else 2),
              units=plan.paths_per_block if greek else None, plain_reps=3,
              quads=True)
    for a, n, row in ((3, 1 << 20, None), (100, 1 << 18, "rqmc_basket_a100")):
        bopt = BasketOption.equicorrelated(a, 0.3)
        plan, rops = qmc_engine.basket_rqmc_setup(bopt, n, cfg, 16)
        timed("rqmc_basket", "mctpu_torch/csrc/rqmc.cu",
              "mctpu/qmc_engine.py:519", plan, a, math.exp(-0.05),
              lambda o=rops, p=plan: krqmc.basket_partials(o, rkey, 0, p, 16),
              lambda o=rops, p=plan: krqmc.basket_plain_partials(
                  o, rkey, 0, p, 16),
              rqmc_work("rqmc_basket", plan, a),
              in_bytes=rqmc_bytes(rops, plan, 2), plain_reps=3, quads=True,
              row=row)
    for m, avg, n, record in ((50, "arithmetic", 1 << 18, True),
                              (252, "geometric", 1 << 16, False)):
        aopt = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=m,
                           average=avg)
        plan, rops = qmc_engine.asian_rqmc_setup(aopt, n, cfg, 16)
        geo = avg == "geometric"
        timed("rqmc_asian", "mctpu_torch/csrc/rqmc.cu",
              "mctpu/qmc_engine.py:769", plan, m, math.exp(-0.05),
              lambda o=rops, p=plan, g=geo: krqmc.asian_partials(
                  o, rkey, 0, p, 16, g),
              lambda o=rops, p=plan, g=geo: krqmc.asian_plain_partials(
                  o, rkey, 0, p, 16, g),
              rqmc_work("rqmc_asian", plan, m, geo),
              in_bytes=rqmc_bytes(rops, plan, 2), plain_reps=3, quads=True,
              record=record)

    # K37 at 100 assets on the plan rainbow_path gives it (c = 1, a
    # 5050-term product a thread), held against its plain version untimed.
    ropt = rb_opt(np.full(100, 100.0), np.full(100, 0.25), 0.3, 110.0, 0.05)
    plan, rops = engine.rainbow_setup(ropt, n_ex, cfg)
    got = krainbow.partials(rops, SEED, 0, plan, plan.num_blocks)
    close_rtol(got, krainbow.plain_partials(rops, SEED, 0, plan,
                                            plan.num_blocks),
               "rainbow_packed a=100")
    phase("times", f"rainbow_packed a=100 max, {plan.num_blocks} blocks x "
                   f"{plan.iters} iters x rows {plan.rows}: kernel matches "
                   f"plain at rtol {RTOL}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
