"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit: it builds the
kernels from ``mctpu_torch/csrc`` and skips where there is no card.  The
module imports neither jax nor mctpu, so on a machine with a GPU and no JAX
it runs without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: ``rtol=2e-5`` between a kernel and its plain version — the two
draw the same normals but sum in other orders, and nvcc contracts
multiply-adds into FMAs (about 1e-6 relative is expected).  The Greek
kernels' ``(sum x, sum x^2)`` pairs are held by the scaled bound of
``tests/torch_tolerance.py`` (``rtol * (|want sum x| + sqrt(n * want sum
x^2))``, ``n`` the units per block), because a Greek's block sum can nearly
cancel; under wrong-way risk at ``rtol=1e-4`` (the hazard's series switch
can flip on one ulp).  Repeated launches and the block-offset contract are
held bitwise.  The RQMC nets' unfolded quads ``[s, c, s2, c2]`` are
compared folded (``s + c``, ``s2 + c2``): each of ``s`` and ``c`` depends
on the order of a chunk's float32 sum.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mctpu_torch import _build, lsm, mlmc, qmc_engine, variance
from mctpu_torch.engine import EngineConfig, greeks_american
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
from mctpu_torch.math import bs_call, cholesky_lower
from mctpu_torch.types import (AmericanOption, AsianOption, BarrierBook,
                               BarrierOption,
                               BasketOption, CliquetOption, CvaMultiSpec,
                               CvaPortfolioSpec, CvaSpec, HestonOption,
                               LookbackOption, Precision, RainbowOption,
                               VanillaBook, VanillaOption, XvaSpec)
from torch_tolerance import (assert_moments_close, assert_pairs_close,
                             assert_quads_close)

pytestmark = pytest.mark.cuda

RTOL = 2e-5
SEED = -123457
NB = 6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    return torch.device("cuda")


def _contract(fn, plain, n_blocks=NB, units=None, rtol=RTOL, moments=False):
    """Kernel == plain at ``rtol`` (by the scaled pair bound when ``units``
    per block is given, the control variates' moment bound as well with
    ``moments``); two launches bitwise equal; blocks [2, NB) of offset 0
    bitwise equal blocks [0, NB-2) of offset 2."""
    got = fn(0, n_blocks)
    again = fn(0, n_blocks)
    tail = fn(2, n_blocks - 2)
    want = plain(0, n_blocks)
    got, again, tail, want = (
        tuple(x) if isinstance(x, tuple) else (x,)
        for x in (got, again, tail, want))
    torch.cuda.synchronize()
    for g, a, t, w in zip(got, again, tail, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, a)
        assert torch.equal(g[2:], t)
        if moments:
            assert_moments_close(g.cpu().numpy(), w.cpu().numpy(), units,
                                 rtol)
        elif units is None:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=rtol, atol=0)
        else:
            assert_pairs_close(g.cpu().numpy(), w.cpu().numpy(), units, rtol)


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_vanilla_kernel_matches_plain(dev, kind, antithetic, kahan):
    par = kvanilla.params(VanillaOption(100., 100., 0.04879, 0.2, 1.,
                                        kind=kind), dev)
    plan = kvanilla.make_plan(3 * NB * 2 * 32 * 128, NB, 32, antithetic,
                              kahan)
    put = kind == "put"
    _contract(
        lambda off, nb: kvanilla.partials(par, SEED, off, plan, nb, put),
        lambda off, nb: kvanilla.plain_partials(par, SEED, off, plan, nb,
                                                put))


@pytest.mark.parametrize("n_assets", [1, 3, 8, 10, 100, 129])
@pytest.mark.parametrize("antithetic", [False, True])
def test_basket_kernel_matches_plain(dev, n_assets, antithetic):
    opt = (BasketOption.default_reference(n_assets) if n_assets <= 10
           else BasketOption.equicorrelated(n_assets))
    ops = kbasket.operands(opt, cholesky_lower(opt.corr), dev)
    plan = kbasket.make_plan(1, NB, 16, antithetic, n_assets=n_assets)
    plan = kbasket.make_plan(2 * NB * plan.paths_per_iter, NB, 16,
                             antithetic, n_assets=n_assets)
    _contract(lambda off, nb: kbasket.partials(ops, SEED, off, plan, nb),
              lambda off, nb: kbasket.plain_partials(ops, SEED, off, plan,
                                                     nb))


def _k3_setup(dev, a, antithetic, rows, kahan=True):
    opt = BasketOption.equicorrelated(a)
    ops = kbasket.operands(opt, cholesky_lower(opt.corr), dev)
    plan = kbasket.make_plan(1, NB, rows, antithetic, kahan, n_assets=a)
    plan = kbasket.make_plan(2 * NB * plan.paths_per_iter, NB, rows,
                             antithetic, kahan, n_assets=a)
    assert plan.iters == 2
    return ops, plan


@pytest.mark.parametrize("a", [10, 16, 100, 128, 200])
@pytest.mark.parametrize("antithetic", [False, True])
def test_basket_packed_split_kernel_matches_plain(dev, a, antithetic):
    """K3 split per (block, iteration) and folded, at 72 rows and 2
    iterations: its register-tiled product at width 128 (10 and 16 assets:
    a_tile 16, chunks of 8 rows; 100 and 128: a_tile 128, chunks of 64 rows
    and a short last chunk of 8, whose missing units the fold skips; 128:
    j-tiles from asset 0) and the per-path code past it (200 assets, width
    256: chunks of 47 rows, 94 units, and a short last one), against the
    plain version, Kahan on plain and off antithetic."""
    ops, plan = _k3_setup(dev, a, antithetic, 72, kahan=not antithetic)
    _contract(lambda off, nb: kbasket.partials(ops, SEED, off, plan, nb),
              lambda off, nb: kbasket.plain_partials(ops, SEED, off, plan,
                                                     nb))


@pytest.mark.parametrize("a", [16, 100, 200])
@pytest.mark.parametrize("antithetic", [False, True])
def test_basket_packed_grouped_scratch_matches_one_group(dev, a, antithetic):
    """K3 under a forced small scratch cap: at 1 float every (block,
    iteration) is split and folded on its own (12 groups, each fold
    thread's Acc2 carried between them), at half the one-group scratch the
    blocks go in groups with their iterations; both equal the one-group
    launch bit for bit."""
    ops, plan = _k3_setup(dev, a, antithetic, 72)
    lib = _build.library()
    a_tile, _, width = kbasket.pack_factor(a)
    shape = (a_tile, width, NB, plan.rows, plan.iters)
    whole = lib.mctpu_basket_packed_scratch_floats(*shape, 0)
    assert lib.mctpu_basket_packed_scratch_floats(*shape, 1) < whole
    want = kbasket.partials(ops, SEED, 0, plan, NB)
    for cap in (1, whole // 2):
        got = kbasket.partials(ops, SEED, 0, plan, NB, scratch_cap=cap)
        assert torch.equal(got, want), cap


_SPEC = CvaSpec(0.03, 0.6, VanillaOption(100., 100., 0.05, 0.2, 1.), 10)
_CVA_CASES = {
    "single": (CvaPortfolioSpec.from_single(_SPEC), True, False, False),
    "odd_grid": (CvaPortfolioSpec.from_single(
        CvaSpec(0.03, 0.6, VanillaOption(100., 100., 0.05, 0.2, 1.), 7)),
        True, False, False),
    "netted": (CvaPortfolioSpec(0.03, 0.6, 100., 0.05, 0.2, 1.,
                                np.array([95., 110.]), np.array([1., -0.5]),
                                0.0, 10), True, False, False),
    "wwr": (CvaPortfolioSpec.from_single(_SPEC, wwr_b=0.8), True, False,
            False),
    "f32_ds": (CvaPortfolioSpec.from_single(_SPEC), True, True, False),
    "antithetic": (CvaPortfolioSpec.from_single(_SPEC), True, False, True),
    "f32": (CvaPortfolioSpec.from_single(_SPEC), False, False, False),
    # 2000 nodes: tables and profile slots exceed shared memory.
    "global_tables": (CvaPortfolioSpec.from_single(
        CvaSpec(0.03, 0.6, VanillaOption(100., 100., 0.05, 0.2, 1.), 2000)),
        True, True, False),
}


@pytest.mark.parametrize("case", sorted(_CVA_CASES))
def test_cva_kernel_matches_plain(dev, case):
    port, kahan, ds, antithetic = _CVA_CASES[case]
    ops = kcva.operands(port, dev)
    wwr = float(port.wwr_b) != 0.0
    plan = kcva.make_plan(2 * NB * 8 * 128, NB, 8, antithetic, kahan, ds)
    _contract(lambda off, nb: kcva.partials(ops, SEED, off, plan, nb, wwr),
              lambda off, nb: kcva.plain_partials(ops, SEED, off, plan, nb,
                                                  wwr))


def _cva_split_plan(antithetic, kahan, ds, rows, iters, n_blocks=NB):
    """K4's plan of ``iters`` iterations over ``rows`` rows: ``rows / 4``
    slices of each simulation block, folded in order."""
    per_iter = rows * 128 * (2 if antithetic else 1)
    plan = kcva.make_plan(iters * n_blocks * per_iter, n_blocks, rows,
                          antithetic, kahan, ds)
    assert plan.iters == iters
    return plan


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
@pytest.mark.parametrize("ds", [False, True])
@pytest.mark.parametrize("wwr", [False, True])
def test_cva_split_kernel_matches_plain(dev, antithetic, kahan, ds, wwr):
    """K4 in every variant (ANTI x KAHAN x DS x WWR) at rows 32 and two
    iterations, so that eight slices a block and both iterations are
    folded: against the plain version, two launches and the block-offset
    contract bitwise."""
    port = CvaPortfolioSpec.from_single(
        CvaSpec(0.03, 0.6, VanillaOption(100., 100., 0.05, 0.2, 1.), 9),
        wwr_b=0.8 if wwr else 0.0)
    ops = kcva.operands(port, dev)
    plan = _cva_split_plan(antithetic, kahan, ds, 32, 2)
    _contract(lambda off, nb: kcva.partials(ops, SEED, off, plan, nb, wwr),
              lambda off, nb: kcva.plain_partials(ops, SEED, off, plan, nb,
                                                  wwr))


@pytest.mark.parametrize("rows, iters", [(18, 2), (2048, 1)])
def test_cva_split_kernel_scratch_profile_matches_plain(dev, rows, iters):
    """K4 at 1100 nodes, past shared memory: tables in global memory and
    each CUDA block's profile slots in scratch.  At rows 18 a block's last
    slice holds 2 rows; at rows 2048 (3072 slices) there are more slices
    than the card holds at once, so the grid is capped and each CUDA block
    walks several (block, slice) items."""
    port = CvaPortfolioSpec.from_single(
        CvaSpec(0.03, 0.6, VanillaOption(100., 100., 0.05, 0.2, 1.), 1100))
    ops = kcva.operands(port, dev)
    plan = _cva_split_plan(False, True, True, rows, iters)
    _contract(lambda off, nb: kcva.partials(ops, SEED, off, plan, nb, False),
              lambda off, nb: kcva.plain_partials(ops, SEED, off, plan, nb,
                                                  False))


def _units(plan):
    return plan.iters * plan.units_per_iter


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_greeks_vanilla_kernel_matches_plain(dev, kind, antithetic, kahan):
    par = kgreeks.params(VanillaOption(100., 100., 0.04879, 0.2, 1.,
                                       kind=kind), dev)
    plan = kgreeks.make_plan(2 * NB * 2 * 32 * 128, NB, 32, antithetic, kahan)
    put = kind == "put"
    _contract(
        lambda off, nb: kgreeks.partials(par, SEED, off, plan, nb, put),
        lambda off, nb: kgreeks.plain_partials(par, SEED, off, plan, nb,
                                               put),
        units=_units(plan))


_BASKETS = {
    "one_asset": BasketOption(s=[100.], v=[0.2], w=[1.], corr=[[1.]],
                              d=[0.], k=100., r=0.04879, t=1.),
    "default_reference_3": BasketOption.default_reference(3),
    "equicorrelated_3": BasketOption.equicorrelated(3),
    "equicorrelated_8": BasketOption.equicorrelated(8),
    "default_reference_10": BasketOption.default_reference(10),
    "equicorrelated_16": BasketOption.equicorrelated(16),
    "equicorrelated_100": BasketOption.equicorrelated(100),
    "equicorrelated_129": BasketOption.equicorrelated(129),
}


@pytest.mark.parametrize("name", sorted(_BASKETS))
@pytest.mark.parametrize("antithetic", [False, True])
def test_greeks_basket_kernel_matches_plain(dev, name, antithetic):
    opt = _BASKETS[name]
    a = opt.n_assets
    chol = cholesky_lower(opt.corr)
    tilt = kgreeks.tilt_direction(chol)[:2]
    plan = kbasket.make_plan(1, NB, 16, antithetic, n_assets=a)
    plan = kbasket.make_plan(2 * NB * plan.paths_per_iter, NB, 16,
                             antithetic, n_assets=a)
    if kbasket.use_asset_major(a):
        ops = kgreeks.am_operands(opt, chol, tilt, dev)
        fn, plain = kgreeks.am_partials, kgreeks.am_plain_partials
    else:
        ops = kgreeks.packed_operands(opt, chol, tilt, dev)
        fn, plain = kgreeks.packed_partials, kgreeks.packed_plain_partials
    _contract(lambda off, nb: fn(ops, SEED, off, plan, nb),
              lambda off, nb: plain(ops, SEED, off, plan, nb),
              units=_units(plan))


def _k8_setup(dev, a, antithetic, rows, kahan=True):
    """K8's operands and a plan of NB blocks, ``rows`` rows and 2
    iterations on ``equicorrelated(a)``."""
    opt = BasketOption.equicorrelated(a)
    chol = cholesky_lower(opt.corr)
    ops = kgreeks.packed_operands(opt, chol, kgreeks.tilt_direction(chol)[:2],
                                  dev)
    plan = kbasket.make_plan(1, NB, rows, antithetic, kahan, n_assets=a)
    plan = kbasket.make_plan(2 * NB * plan.paths_per_iter, NB, rows,
                             antithetic, kahan, n_assets=a)
    assert plan.iters == 2
    return ops, plan


@pytest.mark.parametrize("a", [16, 100, 128, 200])
@pytest.mark.parametrize("antithetic", [False, True])
def test_greeks_basket_packed_kernel_matches_plain(dev, a, antithetic):
    """K8 split per (block, iteration) and folded, at 64 rows (several of
    the simple design's chunks an item): its register-tiled product at
    width 128 (16 assets: a_tile 16; 100: a_tile 128, one unit group; 128:
    j-tiles from asset 0, one block an SM) and the per-path code past it
    (200 assets, width 256), against the plain version; padded slots
    exactly 0."""
    ops, plan = _k8_setup(dev, a, antithetic, 64, kahan=not antithetic)
    _contract(lambda off, nb: kgreeks.packed_partials(ops, SEED, off, plan,
                                                      nb),
              lambda off, nb: kgreeks.packed_plain_partials(ops, SEED, off,
                                                            plan, nb),
              units=_units(plan))
    a_tile, c, _ = kbasket.pack_factor(a)
    _, vecs = kgreeks.packed_partials(ops, SEED, 0, plan, NB)
    assert (vecs.reshape(NB, 6, c, a_tile)[..., a:] == 0).all()


@pytest.mark.parametrize("a", [16, 100])
@pytest.mark.parametrize("antithetic", [False, True])
def test_greeks_basket_packed_short_last_chunk_matches_plain(dev, a,
                                                             antithetic):
    """K8 at 37 rows, which its chunks do not divide (100 assets: 25 and 12
    plain, 15, 15 and 7 antithetic; 16 assets: 24 and 13, 14, 14 and 9),
    against the plain version."""
    ops, plan = _k8_setup(dev, a, antithetic, 37)
    _contract(lambda off, nb: kgreeks.packed_partials(ops, SEED, off, plan,
                                                      nb),
              lambda off, nb: kgreeks.packed_plain_partials(ops, SEED, off,
                                                            plan, nb),
              units=_units(plan))


@pytest.mark.parametrize("a", [16, 100, 200])
@pytest.mark.parametrize("antithetic", [False, True])
def test_greeks_basket_packed_grouped_scratch_matches_one_group(
        dev, a, antithetic):
    """K8 under a forced small scratch cap: at 1 float every (block,
    iteration) is split and folded on its own (12 groups, the fold's carry
    between them), at half the one-group scratch the blocks go in groups
    with their iterations; both equal the one-group launch bit for bit."""
    ops, plan = _k8_setup(dev, a, antithetic, 40)
    lib = _build.library()
    a_tile, _, width = kbasket.pack_factor(a)
    shape = (a, a_tile, width, NB, plan.rows, plan.iters, int(antithetic))
    whole = lib.mctpu_greeks_basket_packed_scratch_floats(*shape, 0)
    assert lib.mctpu_greeks_basket_packed_scratch_floats(*shape, 1) < whole
    want = kgreeks.packed_partials(ops, SEED, 0, plan, NB)
    for cap in (1, whole // 2):
        got = kgreeks.packed_partials(ops, SEED, 0, plan, NB,
                                      scratch_cap=cap)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), cap


_GREEK_CVA_CASES = {
    # name: (portfolio, kahan, antithetic)
    "single": (CvaPortfolioSpec.from_single(_SPEC), True, False),
    "odd_grid": (CvaPortfolioSpec.from_single(
        CvaSpec(0.03, 0.6, VanillaOption(100., 100., 0.05, 0.2, 1.), 7)),
        True, False),
    "netted": (CvaPortfolioSpec(0.03, 0.6, 100., 0.05, 0.2, 1.,
                                np.array([95., 110.]), np.array([1., -0.5]),
                                0.0, 10), True, False),
    "wwr": (CvaPortfolioSpec.from_single(_SPEC, wwr_b=0.5), True, False),
    "antithetic": (CvaPortfolioSpec.from_single(_SPEC), True, True),
    "f32": (CvaPortfolioSpec.from_single(_SPEC), False, False),
    # 2100 nodes: the 12 node tables exceed shared memory.
    "global_tables": (CvaPortfolioSpec.from_single(
        CvaSpec(0.03, 0.6, VanillaOption(100., 100., 0.05, 0.2, 1.), 2100)),
        True, False),
}


@pytest.mark.parametrize("case", sorted(_GREEK_CVA_CASES))
def test_cva_greeks_kernel_matches_plain(dev, case):
    port, kahan, antithetic = _GREEK_CVA_CASES[case]
    ops = kcva.greek_operands(port, dev)
    wwr = float(port.wwr_b) != 0.0
    plan = kcva.make_plan(2 * NB * 8 * 128, NB, 8, antithetic, kahan)
    _contract(
        lambda off, nb: kcva.greek_partials(ops, SEED, off, plan, nb, wwr),
        lambda off, nb: kcva.greek_plain_partials(ops, SEED, off, plan, nb,
                                                  wwr),
        units=_units(plan), rtol=1e-4 if wwr else RTOL)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("wwr", [False, True])
def test_cva_greeks_split_kernel_matches_plain(dev, antithetic, wwr):
    """K5 on its slices at rows 10 (slices of 4, 4 and 2 rows) and two
    iterations, so that a short slice and both iterations are folded:
    against the plain version by the scaled pair bound, two launches and
    the block-offset contract bitwise."""
    port = CvaPortfolioSpec.from_single(
        CvaSpec(0.03, 0.6, VanillaOption(100., 100., 0.05, 0.2, 1.), 9),
        wwr_b=0.5 if wwr else 0.0)
    ops = kcva.greek_operands(port, dev)
    plan = _cva_split_plan(antithetic, True, False, 10, 2)
    _contract(
        lambda off, nb: kcva.greek_partials(ops, SEED, off, plan, nb, wwr),
        lambda off, nb: kcva.greek_plain_partials(ops, SEED, off, plan, nb,
                                                  wwr),
        units=_units(plan), rtol=1e-4 if wwr else RTOL)


# The single-asset walks at the medium plan's odd date count (n_obs=13, the
# trailing half pair), and at n_obs=1.
_WALK_CASES = {
    # name: (n_obs, flag, antithetic, kahan); flag = geometric / up-and-out
    "n13": (13, False, False, True),
    "n13_flag": (13, True, False, True),
    "n13_antithetic": (13, False, True, True),
    "n13_flag_antithetic_f32": (13, True, True, False),
    "n1": (1, False, False, True),
}


def _asian(n_obs, geometric):
    return AsianOption(100., 100., 0.05, 0.2, 1., n_obs=n_obs,
                       average="geometric" if geometric else "arithmetic")


def _barrier(n_obs, up):
    return BarrierOption(100., 100., 0.05, 0.2, 1., 130. if up else 80.,
                         n_obs=n_obs,
                         kind="up-and-out" if up else "down-and-out")


@pytest.mark.parametrize("case", sorted(_WALK_CASES))
@pytest.mark.parametrize("product", ["asian", "barrier"])
def test_walk_kernels_match_plain(dev, product, case):
    n_obs, flag, antithetic, kahan = _WALK_CASES[case]
    kmod, opt = ((kasian, _asian(n_obs, flag)) if product == "asian"
                 else (kbarrier, _barrier(n_obs, flag)))
    plan = kmod.make_plan(2 * NB * 32 * 128, NB, 32, antithetic, kahan)
    par = kmod.params(opt, dev)
    _contract(
        lambda off, nb: kmod.partials(par, SEED, off, plan, nb, n_obs, flag),
        lambda off, nb: kmod.plain_partials(par, SEED, off, plan, nb, n_obs,
                                            flag))
    gp = kmod.greek_params(opt, dev)
    _contract(
        lambda off, nb: kmod.greek_partials(gp, SEED, off, plan, nb, n_obs,
                                            flag),
        lambda off, nb: kmod.greek_plain_partials(gp, SEED, off, plan, nb,
                                                  n_obs, flag),
        units=_units(plan))


# K12's split walk and fold: up and down, plain and antithetic, Kahan on and
# off, n_obs 1, 49 and 50, on phase 6's 128 x 1 x 256 plan, on the MLMC 8 x
# 8 plan with many iterations and at rows that are not a multiple of 8.
_K12_SPLIT = {
    # name: (n_obs, up, antithetic, kahan, blocks, rows, iters)
    "n50_up_plan128x1x256": (50, True, False, True, 128, 256, 1),
    "n50_down_antithetic_plan128x1x256": (50, False, True, True, 128, 256, 1),
    "n1_up_plan128x1x256_f32": (1, True, False, False, 128, 256, 1),
    "n8_up_mlmc8x8_iters64": (8, True, False, True, 8, 8, 64),
    "n49_up_antithetic_f32_mlmc8x8_iters32": (49, True, True, False, 8, 8,
                                              32),
    "n49_down_rows13": (49, False, False, True, NB, 13, 3),
    "n1_down_antithetic_rows5": (1, False, True, True, NB, 5, 2),
    "n50_up_antithetic_f32_rows9": (50, True, True, False, NB, 9, 2),
}


def _k12_setup(dev, n_obs, up, antithetic, kahan, blocks, rows, iters):
    plan = kbarrier.make_plan(
        blocks * iters * rows * 128 * (2 if antithetic else 1), blocks,
        rows, antithetic, kahan)
    assert (plan.num_blocks, plan.rows, plan.iters) == (blocks, rows, iters)
    return kbarrier.params(_barrier(n_obs, up), dev), plan


@pytest.mark.parametrize("case", sorted(_K12_SPLIT))
def test_barrier_split_kernel_matches_plain(dev, case):
    """K12 (split per path element, folded in the unsplit order) against
    the plain version; two launches and the block offset bitwise."""
    n_obs, up, antithetic, kahan, blocks, rows, iters = _K12_SPLIT[case]
    par, plan = _k12_setup(dev, n_obs, up, antithetic, kahan, blocks, rows,
                           iters)
    _contract(
        lambda off, nb: kbarrier.partials(par, SEED, off, plan, nb, n_obs,
                                          up),
        lambda off, nb: kbarrier.plain_partials(par, SEED, off, plan, nb,
                                                n_obs, up),
        n_blocks=blocks)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("iters", [1, 5])
def test_barrier_split_grouped_scratch_matches_one_group(dev, antithetic,
                                                         iters):
    """K12 under a forced small scratch cap: at 1 float every (block,
    iteration) is split and folded on its own (the fold's carry, each
    thread's Acc2, between the groups), at half the one-group scratch the
    blocks go in groups; both equal the one-group launch bit for bit, and
    each capped call counts one launch."""
    par, plan = _k12_setup(dev, 13, True, antithetic, True, NB, 7, iters)
    lib = _build.library()
    whole = lib.mctpu_barrier_scratch_floats(NB, plan.rows, plan.iters, 0)
    assert lib.mctpu_barrier_scratch_floats(NB, plan.rows, plan.iters,
                                            1) < whole
    want = kbarrier.partials(par, SEED, 0, plan, NB, 13, True)
    for cap in (1, whole // 2):
        before = kbarrier.LAUNCHES["barrier"]
        got = kbarrier.partials(par, SEED, 0, plan, NB, 13, True,
                                scratch_cap=cap)
        assert kbarrier.LAUNCHES["barrier"] == before + 1
        assert torch.equal(got, want), cap


# K15-K18 at the odd step count 13 (and 1): every lookback mode, antithetic
# and plain sums; the fixed strikes away from the atom at s0.
_LOOKBACK_CASES = {
    # name: (n_obs, kind, payoff, k, antithetic, kahan)
    "floating_call": (13, "floating", "call", 0.0, False, True),
    "floating_put": (13, "floating", "put", 0.0, False, True),
    "fixed_call": (13, "fixed", "call", 105.0, False, True),
    "fixed_put": (13, "fixed", "put", 95.0, False, True),
    "floating_call_antithetic": (13, "floating", "call", 0.0, True, True),
    "fixed_put_antithetic_f32": (13, "fixed", "put", 95.0, True, False),
    "fixed_call_n1": (1, "fixed", "call", 105.0, False, True),
}


@pytest.mark.parametrize("case", sorted(_LOOKBACK_CASES))
def test_lookback_kernels_match_plain(dev, case):
    n_obs, kind, payoff, k, antithetic, kahan = _LOOKBACK_CASES[case]
    opt = LookbackOption(100., 0.05, 0.2, 1., k=k, n_obs=n_obs, kind=kind,
                         payoff=payoff)
    mode = klookback.mode_of(opt)
    plan = klookback.make_plan(2 * NB * 32 * 128, NB, 32, antithetic, kahan)
    par, gp = klookback.params(opt, dev), klookback.greek_params(opt, dev)
    _contract(
        lambda off, nb: klookback.partials(par, SEED, off, plan, nb, n_obs,
                                           mode),
        lambda off, nb: klookback.plain_partials(par, SEED, off, plan, nb,
                                                 n_obs, mode))
    _contract(
        lambda off, nb: klookback.greek_partials(gp, SEED, off, plan, nb,
                                                 n_obs, mode),
        lambda off, nb: klookback.greek_plain_partials(gp, SEED, off, plan,
                                                       nb, n_obs, mode),
        units=_units(plan))


_CLIQUET_CASES = {
    # name: (n_periods, cap, floor, antithetic, kahan)
    "n13": (13, 0.05, -0.02, False, True),
    "n13_antithetic": (13, 0.05, -0.02, True, True),
    "n13_f32": (13, 0.03, 0.0, False, False),
    "n1": (1, 0.10, -0.10, False, True),
}


@pytest.mark.parametrize("case", sorted(_CLIQUET_CASES))
def test_cliquet_kernels_match_plain(dev, case):
    n, cap, floor, antithetic, kahan = _CLIQUET_CASES[case]
    opt = CliquetOption(100., 0.03, 0.2, 1., n_periods=n, cap=cap,
                        floor=floor)
    plan = kcliquet.make_plan(2 * NB * 32 * 128, NB, 32, antithetic, kahan)
    par, gp = kcliquet.params(opt, dev), kcliquet.greek_params(opt, dev)
    _contract(
        lambda off, nb: kcliquet.partials(par, SEED, off, plan, nb, n),
        lambda off, nb: kcliquet.plain_partials(par, SEED, off, plan, nb, n))
    _contract(
        lambda off, nb: kcliquet.greek_partials(gp, SEED, off, plan, nb, n),
        lambda off, nb: kcliquet.greek_plain_partials(gp, SEED, off, plan,
                                                      nb, n),
        units=_units(plan))


@pytest.mark.parametrize("n_strikes", [1, 5, 64])
@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_ladder_kernels_match_plain(dev, n_strikes, kind, antithetic):
    opt = VanillaOption(100., 100., 0.04879, 0.2, 1., kind=kind)
    ks = kladder.strike_vector(np.linspace(50., 150., n_strikes), dev)
    plan = kladder.make_plan(2 * NB * 2 * 32 * 128, NB, 32, antithetic,
                             kind == "call")  # Kahan on for calls only
    put = kind == "put"
    par, gp = kladder.params(opt, dev), kladder.greek_params(opt, dev)
    flat = (lambda x: x.reshape(x.shape[0], -1))
    _contract(
        lambda off, nb: flat(kladder.partials(par, ks, SEED, off, plan, nb,
                                              put)),
        lambda off, nb: flat(kladder.plain_partials(par, ks, SEED, off, plan,
                                                    nb, put)))
    _contract(
        lambda off, nb: flat(kladder.greek_partials(gp, ks, SEED, off, plan,
                                                    nb, put)),
        lambda off, nb: flat(kladder.greek_plain_partials(gp, ks, SEED, off,
                                                          plan, nb, put)),
        units=_units(plan))


@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("kind", ["call", "put", "mixed"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_book_kernels_match_plain(dev, m, kind, antithetic):
    book = VanillaBook.serving(m, kind)
    plan = kbook.make_plan(2 * NB * 2 * 32 * 128, NB, 32, antithetic,
                           kind != "put")  # Kahan off for the puts
    par, cvec = kbook.params(book, dev), kbook.greek_const_rows(book, dev)
    flat = (lambda x: x.reshape(x.shape[0], -1))
    _contract(
        lambda off, nb: flat(kbook.partials(par, SEED, off, plan, nb)),
        lambda off, nb: flat(kbook.plain_partials(par, SEED, off, plan, nb)))
    _contract(
        lambda off, nb: flat(kbook.greek_partials(cvec, SEED, off, plan, nb)),
        lambda off, nb: flat(kbook.greek_plain_partials(cvec, SEED, off, plan,
                                                        nb)),
        units=_units(plan))


# K19/K20 at odd and even date counts (and the 252 of the main path); Kahan
# off under antithetic.
@pytest.mark.parametrize("n_obs", [1, 13, 252])
@pytest.mark.parametrize("antithetic", [False, True])
def test_varswap_kernels_match_plain(dev, n_obs, antithetic):
    opt = VanillaOption(100., 100., 0.05, 0.2, 1.)
    plan = kvarswap.make_plan(2 * NB * 32 * 128 * (2 if antithetic else 1),
                              NB, 32, antithetic, not antithetic)
    par = kvarswap.params(opt, n_obs, dev)
    gp = kvarswap.greek_params(opt, n_obs, dev)
    _contract(
        lambda off, nb: kvarswap.partials(par, SEED, off, plan, nb, n_obs),
        lambda off, nb: kvarswap.plain_partials(par, SEED, off, plan, nb,
                                                n_obs))
    _contract(
        lambda off, nb: kvarswap.greek_partials(gp, SEED, off, plan, nb,
                                                n_obs),
        lambda off, nb: kvarswap.greek_plain_partials(gp, SEED, off, plan, nb,
                                                      n_obs),
        units=_units(plan))


# K25/K26 on the serving book's first M instruments (a put from M=4 on) at
# an odd and an even date count; Kahan off under antithetic.
@pytest.mark.parametrize("m", [1, 5, 32])
@pytest.mark.parametrize("n_obs", [7, 50])
@pytest.mark.parametrize("antithetic", [False, True])
def test_barrier_book_kernels_match_plain(dev, m, n_obs, antithetic):
    book = dataclasses.replace(BarrierBook.serving(m), n_obs=n_obs)
    plan = kbb.make_plan(2 * NB * 32 * 128 * (2 if antithetic else 1), NB,
                         32, antithetic, not antithetic)
    par, gp = kbb.book_params(book, dev), kbb.greek_rows(book, dev)
    flat = (lambda x: x.reshape(x.shape[0], -1))
    _contract(
        lambda off, nb: flat(kbb.partials(par, SEED, off, plan, nb, n_obs)),
        lambda off, nb: flat(kbb.plain_partials(par, SEED, off, plan, nb,
                                                n_obs)))
    _contract(
        lambda off, nb: flat(kbb.greek_partials(gp, SEED, off, plan, nb,
                                                n_obs)),
        lambda off, nb: flat(kbb.greek_plain_partials(gp, SEED, off, plan,
                                                      nb, n_obs)),
        units=_units(plan))


# K27 (both schemes) and K28 on the Euler reference option, the
# Feller-violating QE option and a vol-of-vol that drives v below 0, at 1,
# an odd 13 and the default 100 steps; Kahan off under antithetic.  On the
# card each path equals the plain version's (IEEE roots and divisions, no
# FMA contraction), so the Greek tangents are held at the same bound as the
# rest.
_HESTON = {
    "opt": HestonOption(100., 100., 0.05, 1., 0.04, 2., 0.04, 0.3, -0.7),
    "steep": HestonOption(100., 100., 0.03, 1., 0.04, 1.5, 0.04, 0.5, -0.7),
    "large_xi": HestonOption(100., 100., 0.03, 1., 0.09, 2., 0.09, 1.2,
                             -0.6),
}


@pytest.mark.parametrize("name", sorted(_HESTON))
@pytest.mark.parametrize("n_steps", [1, 13, 100])
@pytest.mark.parametrize("antithetic", [False, True])
def test_heston_kernels_match_plain(dev, name, n_steps, antithetic):
    opt = _HESTON[name]
    plan = kheston.make_plan(2 * NB * 32 * 128 * (2 if antithetic else 1),
                             NB, 32, antithetic, not antithetic)
    for qe in (False, True):
        par = kheston.params(opt, n_steps, qe, dev)
        _contract(
            lambda off, nb, par=par, qe=qe: kheston.partials(
                par, SEED, off, plan, nb, n_steps, qe),
            lambda off, nb, par=par, qe=qe: kheston.plain_partials(
                par, SEED, off, plan, nb, n_steps, qe))
    gp = kheston.greek_params(opt, n_steps, dev)
    _contract(
        lambda off, nb: kheston.greek_partials(gp, SEED, off, plan, nb,
                                               n_steps),
        lambda off, nb: kheston.greek_plain_partials(gp, SEED, off, plan, nb,
                                                     n_steps),
        units=_units(plan))


# K19/K20's Heston leg at 1, 13 and the default 252 dates, 2 iterations a
# block (K19 and K20's Heston leg split walks).
@pytest.mark.parametrize("n_obs", [1, 13, 252])
@pytest.mark.parametrize("antithetic", [False, True])
def test_varswap_heston_kernels_match_plain(dev, n_obs, antithetic):
    opt = _HESTON["steep"]
    plan = kvarswap.make_plan(2 * NB * 32 * 128 * (2 if antithetic else 1),
                              NB, 32, antithetic, not antithetic)
    par = kvarswap.heston_params(opt, n_obs, dev)
    gp = kvarswap.heston_greek_params(opt, n_obs, dev)
    _contract(
        lambda off, nb: kvarswap.partials(par, SEED, off, plan, nb, n_obs),
        lambda off, nb: kvarswap.plain_partials(par, SEED, off, plan, nb,
                                                n_obs))
    _contract(
        lambda off, nb: kvarswap.greek_partials(gp, SEED, off, plan, nb,
                                                n_obs),
        lambda off, nb: kvarswap.greek_plain_partials(gp, SEED, off, plan, nb,
                                                      n_obs),
        units=_units(plan))


def test_launch_counters_count_kernel_launches(dev):
    par = kvanilla.params(VanillaOption(100., 100., 0.05, 0.2, 1.), dev)
    plan = kvanilla.make_plan(1, 2, 8, False)
    before = kvanilla.LAUNCHES["vanilla"]
    kvanilla.partials(par, 1, 0, plan, 2, False)
    kvanilla.plain_partials(par, 1, 0, plan, 2, False)
    assert kvanilla.LAUNCHES["vanilla"] == before + 1
    par = kgreeks.params(VanillaOption(100., 100., 0.05, 0.2, 1.), dev)
    before = kgreeks.LAUNCHES["greeks_vanilla"]
    kgreeks.partials(par, 1, 0, plan, 2, False)
    kgreeks.plain_partials(par, 1, 0, plan, 2, False)
    assert kgreeks.LAUNCHES["greeks_vanilla"] == before + 1
    wplan = kasian.make_plan(1, 2, 8, False)
    for kmod, name, opt in ((kasian, "asian", _asian(3, True)),
                            (kbarrier, "barrier", _barrier(3, True))):
        for fn, plain, make, key in (
                (kmod.partials, kmod.plain_partials, kmod.params, name),
                (kmod.greek_partials, kmod.greek_plain_partials,
                 kmod.greek_params, name + "_greeks")):
            par = make(opt, dev)
            before = kmod.LAUNCHES[key]
            fn(par, 1, 0, wplan, 2, 3, True)
            plain(par, 1, 0, wplan, 2, 3, True)
            assert kmod.LAUNCHES[key] == before + 1, key
    lb, cq = LookbackOption(100., 0.05, 0.2, 1., n_obs=3), CliquetOption(
        100., 0.03, 0.2, 1., n_periods=3)
    for kmod, name, opt, extra in ((klookback, "lookback", lb, (3, 0)),
                                   (kcliquet, "cliquet", cq, (3,))):
        for fn, plain, make, key in (
                (kmod.partials, kmod.plain_partials, kmod.params, name),
                (kmod.greek_partials, kmod.greek_plain_partials,
                 kmod.greek_params, name + "_greeks")):
            par = make(opt, dev)
            before = kmod.LAUNCHES[key]
            fn(par, 1, 0, wplan, 2, *extra)
            plain(par, 1, 0, wplan, 2, *extra)
            assert kmod.LAUNCHES[key] == before + 1, key
    opt = VanillaOption(100., 100., 0.05, 0.2, 1.)
    book = VanillaBook.serving(5)
    ks = kladder.strike_vector([90., 100., 110.], dev)
    for kmod, key, fn, plain, ops in (
            (kladder, "ladder", kladder.partials, kladder.plain_partials,
             (kladder.params(opt, dev), ks)),
            (kladder, "ladder_greeks", kladder.greek_partials,
             kladder.greek_plain_partials, (kladder.greek_params(opt, dev),
                                            ks)),
            (kbook, "book", kbook.partials, kbook.plain_partials,
             (kbook.params(book, dev),)),
            (kbook, "book_greeks", kbook.greek_partials,
             kbook.greek_plain_partials,
             (kbook.greek_const_rows(book, dev),))):
        extra = (False,) if kmod is kladder else ()
        before = kmod.LAUNCHES[key]
        fn(*ops, 1, 0, plan, 2, *extra)
        plain(*ops, 1, 0, plan, 2, *extra)
        assert kmod.LAUNCHES[key] == before + 1, key
    bbook = BarrierBook.serving(5)
    for kmod, key, fn, plain, par in (
            (kvarswap, "varswap", kvarswap.partials, kvarswap.plain_partials,
             kvarswap.params(opt, 3, dev)),
            (kvarswap, "varswap_greeks", kvarswap.greek_partials,
             kvarswap.greek_plain_partials,
             kvarswap.greek_params(opt, 3, dev)),
            (kbb, "barrier_book", kbb.partials, kbb.plain_partials,
             kbb.book_params(bbook, dev)),
            (kbb, "barrier_book_greeks", kbb.greek_partials,
             kbb.greek_plain_partials, kbb.greek_rows(bbook, dev)),
            (kvarswap, "varswap_heston", kvarswap.partials,
             kvarswap.plain_partials,
             kvarswap.heston_params(_HESTON["opt"], 3, dev)),
            (kvarswap, "varswap_heston_greeks", kvarswap.greek_partials,
             kvarswap.greek_plain_partials,
             kvarswap.heston_greek_params(_HESTON["opt"], 3, dev)),
            (kheston, "heston_greeks", kheston.greek_partials,
             kheston.greek_plain_partials,
             kheston.greek_params(_HESTON["opt"], 3, dev))):
        before = kmod.LAUNCHES[key]
        fn(par, 1, 0, wplan, 2, 3)
        plain(par, 1, 0, wplan, 2, 3)
        assert kmod.LAUNCHES[key] == before + 1, key
    for key, qe in (("heston", False), ("heston_qe", True)):
        par = kheston.params(_HESTON["opt"], 3, qe, dev)
        before = dict(kheston.LAUNCHES)
        kheston.partials(par, 1, 0, wplan, 2, 3, qe)
        kheston.plain_partials(par, 1, 0, wplan, 2, 3, qe)
        assert kheston.LAUNCHES[key] == before[key] + 1, key
        assert sum(kheston.LAUNCHES.values()) == sum(before.values()) + 1


def test_bad_operands_raise(dev):
    par = kvanilla.params(VanillaOption(100., 100., 0.05, 0.2, 1.), dev)
    plan = kvanilla.make_plan(1, 2, 8, False)
    with pytest.raises(ValueError):
        kvanilla.partials(par.double(), 1, 0, plan, 2, False)
    with pytest.raises(ValueError):
        kvanilla.partials(par, 1, 0, plan, 0, False)
    gpar = kgreeks.params(VanillaOption(100., 100., 0.05, 0.2, 1.), dev)
    with pytest.raises(ValueError):
        kgreeks.partials(gpar[:4], 1, 0, plan, 2, False)
    apar = kasian.params(AsianOption(100., 100., 0.05, 0.2, 1.), dev)
    with pytest.raises(ValueError):
        kasian.partials(apar, 1, 0, plan, 2, 0, False)
    with pytest.raises(ValueError):
        kbarrier.greek_partials(apar, 1, 0, plan, 2, 4, True)
    with pytest.raises(ValueError):
        klookback.greek_partials(apar, 1, 0, plan, 2, 4, 0)
    with pytest.raises(RuntimeError):  # no fifth lookback mode
        klookback.partials(apar, 1, 0, plan, 2, 4, 4)
    with pytest.raises(ValueError):
        kcliquet.greek_partials(apar, 1, 0, plan, 2, 4)
    opt = VanillaOption(100., 100., 0.05, 0.2, 1.)
    lpar = kladder.params(opt, dev)
    with pytest.raises(ValueError):  # 65 strikes
        kladder.partials(lpar, kladder.strike_vector(np.ones(65), dev), 1, 0,
                         plan, 2, False)
    with pytest.raises(ValueError):  # the price operands to K22
        kladder.greek_partials(lpar, kladder.strike_vector([100.], dev), 1,
                               0, plan, 2, False)
    table = kbook.params(VanillaBook.serving(3), dev)
    with pytest.raises(ValueError):  # K23's table to K24
        kbook.greek_partials(table, 1, 0, plan, 2)
    with pytest.raises(ValueError):  # 65 instruments
        kbook.partials(torch.ones((5, 65), device=dev), 1, 0, plan, 2)
    vpar = kvarswap.params(opt, 3, dev)
    with pytest.raises(ValueError):  # K19's scalars to K20
        kvarswap.greek_partials(vpar, 1, 0, plan, 2, 3)
    with pytest.raises(ValueError):
        kvarswap.partials(vpar, 1, 0, plan, 2, 0)
    bpar = kbb.book_params(BarrierBook.serving(3), dev)
    with pytest.raises(ValueError):  # K25's table to K26
        kbb.greek_partials(bpar, 1, 0, plan, 2, 5)
    with pytest.raises(ValueError):  # 33 instruments
        kbb.partials(torch.ones((7, 33), device=dev), 1, 0, plan, 2, 5)
    with pytest.raises(ValueError):
        kbb.partials(bpar, 1, 0, plan, 2, 0)
    hpar = kheston.params(_HESTON["opt"], 3, False, dev)
    with pytest.raises(ValueError):  # K27's scalars to K28
        kheston.greek_partials(hpar, 1, 0, plan, 2, 3)
    with pytest.raises(ValueError):
        kheston.partials(hpar, 1, 0, plan, 2, 0, False)
    with pytest.raises(ValueError):  # K19's Heston scalars to K20
        kvarswap.greek_partials(
            kvarswap.heston_params(_HESTON["opt"], 3, dev), 1, 0, plan, 2, 3)


# ---- the multi-asset walks: K30, K31, K32, K34 ------------------------------

_MW_CASES = {
    # name: (assets, n_obs, antithetic, kahan)
    "a1_n13": (1, 13, False, True),
    "a3_n13_antithetic": (3, 13, True, True),
    "a3_n50_f32": (3, 50, False, False),
    "a8_n7_antithetic_f32": (8, 7, True, False),
    "a8_n16": (8, 16, False, True),
    "a9_n13_antithetic": (9, 13, True, True),
    "a16_n13": (16, 13, False, True),
    "a16_n7_antithetic_f32": (16, 7, True, False),
    "a17_n13": (17, 13, False, True),
    "a32_n7_antithetic_f32": (32, 7, True, False),
    "a100_n5": (100, 5, False, True),
    "a100_n4_antithetic": (100, 4, True, True),
}
_MW_PRODUCTS = {"asian": ("asian", True, None),
                "up": ("barrier", True, 104.0),
                "down": ("barrier", False, 96.0)}


def _mw_setup(dev, a, n_obs, antithetic, kahan, rows=16):
    bk = BasketOption.equicorrelated(a, 0.3)
    chol = cholesky_lower(bk.corr)
    probe = kmw.make_plan(1, NB, rows, antithetic, kahan, n_assets=a)
    plan = kmw.make_plan(2 * NB * probe.paths_per_iter, NB, rows, antithetic,
                         kahan, n_assets=a)
    return bk, chol, plan


@pytest.mark.parametrize("case", sorted(_MW_CASES))
@pytest.mark.parametrize("product", sorted(_MW_PRODUCTS))
def test_multi_walk_kernels_match_plain(dev, case, product):
    """K30 (a <= 8) and K31 against the plain version, both products; K31
    at the edges of its register instances (9, 16; 17, 32) and in its
    shared-memory design (100)."""
    a, n_obs, antithetic, kahan = _MW_CASES[case]
    kind, up, h = _MW_PRODUCTS[product]
    bk, chol, plan = _mw_setup(dev, a, n_obs, antithetic, kahan)
    lt, par = (x.to(dev) for x in kmw.walk_ops(bk, chol, n_obs))
    scal = kmw.scalars(bk, h).to(dev)
    _contract(
        lambda off, nb: kmw.partials(lt, par, scal, SEED, off, plan, nb, kind,
                                     n_obs, up),
        lambda off, nb: kmw.plain_partials(lt, par, scal, SEED, off, plan, nb,
                                           kind, n_obs, up))


def _mw_greek_pairs(out):
    scal, vec = out
    return torch.cat([scal] + [vec[:, :, i] for i in range(vec.shape[2])], 1)


@pytest.mark.parametrize("case", [c for c in sorted(_MW_CASES)
                                  if _MW_CASES[c][0] <= 8])
@pytest.mark.parametrize("kernel", ["K32", "K34_up", "K34_down"])
def test_multi_walk_greek_kernels_match_plain(dev, case, kernel):
    """K32 and K34 against their plain versions, by the scaled pair bound."""
    a, n_obs, antithetic, kahan = _MW_CASES[case]
    bk, chol, plan = _mw_setup(dev, a, n_obs, antithetic, kahan)
    if kernel == "K32":
        ops = tuple(x.to(dev) for x in kmw.am_greek_ops(bk, chol, n_obs))
        fn, plain = kmw.am_greek_partials, kmw.am_greek_plain_partials
        extra = ()
    else:
        up = kernel == "K34_up"
        ops = tuple(x.to(dev) for x in kmw.am_bar_greek_ops(
            bk, chol, n_obs, 104.0 if up else 96.0))
        fn, plain = kmw.am_bar_greek_partials, kmw.am_bar_greek_plain_partials
        extra = (up,)
    _contract(
        lambda off, nb: _mw_greek_pairs(fn(*ops, SEED, off, plan, nb, n_obs,
                                           *extra)),
        lambda off, nb: _mw_greek_pairs(plain(*ops, SEED, off, plan, nb,
                                              n_obs, *extra)),
        units=plan.iters * plan.units_per_iter)


@pytest.mark.parametrize("a", [1, 3, 8])
@pytest.mark.parametrize("antithetic", [False, True])
def test_multi_walk_greek_price_equals_pricer(dev, a, antithetic):
    """K32's and K34's price sums equal K30's bit for bit: one log-spot
    chain, one thread count, one block reduction (the Asian at n_obs = 16,
    where acc * (1/n) is acc / n)."""
    n_obs = 16
    bk, chol, plan = _mw_setup(dev, a, n_obs, antithetic, True)
    lt, par = (x.to(dev) for x in kmw.walk_ops(bk, chol, n_obs))
    price = kmw.partials(lt, par, kmw.scalars(bk).to(dev), SEED, 0, plan, NB,
                         "asian", n_obs)
    gops = tuple(x.to(dev) for x in kmw.am_greek_ops(bk, chol, n_obs))
    scal, _ = kmw.am_greek_partials(*gops, SEED, 0, plan, NB, n_obs)
    assert torch.equal(scal[:, :2], price)
    price = kmw.partials(lt, par, kmw.scalars(bk, 110.0).to(dev), SEED, 0,
                         plan, NB, "barrier", n_obs, True)
    bops = tuple(x.to(dev) for x in kmw.am_bar_greek_ops(bk, chol, n_obs,
                                                         110.0))
    scal, _ = kmw.am_bar_greek_partials(*bops, SEED, 0, plan, NB, n_obs, True)
    assert torch.equal(scal[:, :2], price)


def test_multi_walk_launch_counters(dev):
    for a, names in ((3, ("basket_asian_am", "basket_barrier_am",
                          "basket_asian_greeks_am",
                          "basket_barrier_greeks_am")),
                     (16, ("basket_asian_packed", "basket_barrier_packed"))):
        bk, chol, plan = _mw_setup(dev, a, 3, False, True, rows=8)
        lt, par = (x.to(dev) for x in kmw.walk_ops(bk, chol, 3))
        calls = [
            (lambda f: f(lt, par, kmw.scalars(bk).to(dev), 1, 0, plan, 2,
                         "asian", 3), kmw.partials, kmw.plain_partials),
            (lambda f: f(lt, par, kmw.scalars(bk, 110.0).to(dev), 1, 0, plan,
                         2, "barrier", 3), kmw.partials, kmw.plain_partials)]
        if a <= 8:
            gops = tuple(x.to(dev) for x in kmw.am_greek_ops(bk, chol, 3))
            bops = tuple(x.to(dev) for x in kmw.am_bar_greek_ops(bk, chol, 3,
                                                                 110.0))
            calls += [
                (lambda f: f(*gops, 1, 0, plan, 2, 3), kmw.am_greek_partials,
                 kmw.am_greek_plain_partials),
                (lambda f: f(*bops, 1, 0, plan, 2, 3, True),
                 kmw.am_bar_greek_partials, kmw.am_bar_greek_plain_partials)]
        for name, (call, fn, plain) in zip(names, calls):
            before = dict(kmw.LAUNCHES)
            call(fn)
            call(plain)
            assert kmw.LAUNCHES[name] == before[name] + 1, name
            assert sum(kmw.LAUNCHES.values()) == sum(before.values()) + 1


# K30's split walk and fold at the 3-asset basket (512 threads) and 8 (256):
# phase 6's 128 x 1 x 256 plan at 50 dates, and rows not a multiple of 8.
_K30_SPLIT = {
    # name: (assets, n_obs, antithetic, kahan, blocks, rows, iters)
    "a3_n50_plan128x1x256": (3, 50, False, True, 128, 256, 1),
    "a3_n50_antithetic_plan128x1x256": (3, 50, True, True, 128, 256, 1),
    "a1_n49_rows13_f32": (1, 49, False, False, NB, 13, 3),
    "a8_n50_antithetic_rows9": (8, 50, True, True, NB, 9, 2),
    "a3_n1_mlmc8x8_iters16": (3, 1, False, True, 8, 8, 16),
}


@pytest.mark.parametrize("case", sorted(_K30_SPLIT))
@pytest.mark.parametrize("product", sorted(_MW_PRODUCTS))
def test_multi_walk_am_split_kernel_matches_plain(dev, case, product):
    """K30 (split per path element, folded in the unsplit order) against
    the plain version, the Asian and both knock-outs."""
    a, n_obs, antithetic, kahan, blocks, rows, iters = _K30_SPLIT[case]
    kind, up, h = _MW_PRODUCTS[product]
    bk = BasketOption.equicorrelated(a, 0.3)
    plan = kmw.make_plan(blocks * iters * rows * 128 * (2 if antithetic
                                                        else 1),
                         blocks, rows, antithetic, kahan, n_assets=a)
    assert (plan.num_blocks, plan.rows, plan.iters) == (blocks, rows, iters)
    lt, par = (x.to(dev) for x in kmw.walk_ops(bk, cholesky_lower(bk.corr),
                                               n_obs))
    scal = kmw.scalars(bk, h).to(dev)
    _contract(
        lambda off, nb: kmw.partials(lt, par, scal, SEED, off, plan, nb, kind,
                                     n_obs, up),
        lambda off, nb: kmw.plain_partials(lt, par, scal, SEED, off, plan, nb,
                                           kind, n_obs, up),
        n_blocks=blocks)


@pytest.mark.parametrize("a", [3, 8])
@pytest.mark.parametrize("antithetic", [False, True])
def test_multi_walk_am_grouped_scratch_matches_one_group(dev, a, antithetic):
    """K30 under a forced small scratch cap: at 1 float every (block,
    iteration) is split and folded on its own (BlockAccN's carry between the
    groups), at half the one-group scratch the blocks go in groups; both
    equal the one-group launch bit for bit, and each capped call counts one
    launch."""
    bk, chol, plan = _mw_setup(dev, a, 13, antithetic, True, rows=7)
    lt, par = (x.to(dev) for x in kmw.walk_ops(bk, chol, 13))
    lib = _build.library()
    whole = lib.mctpu_multi_walk_am_scratch_floats(NB, plan.rows,
                                                   plan.iters, 0)
    assert lib.mctpu_multi_walk_am_scratch_floats(NB, plan.rows, plan.iters,
                                                  1) < whole
    for kind, h in (("asian", None), ("barrier", 110.0)):
        scal = kmw.scalars(bk, h).to(dev)
        want = kmw.partials(lt, par, scal, SEED, 0, plan, NB, kind, 13)
        for cap in (1, whole // 2):
            name = f"basket_{kind}_am"
            before = kmw.LAUNCHES[name]
            got = kmw.partials(lt, par, scal, SEED, 0, plan, NB, kind, 13,
                               scratch_cap=cap)
            assert kmw.LAUNCHES[name] == before + 1
            assert torch.equal(got, want), (kind, cap)


def test_multi_walk_bad_operands_raise(dev):
    bk, chol, plan = _mw_setup(dev, 3, 3, False, True, rows=8)
    lt, par = (x.to(dev) for x in kmw.walk_ops(bk, chol, 3))
    scal = kmw.scalars(bk).to(dev)
    with pytest.raises(ValueError):
        kmw.partials(lt, par.double(), scal, 1, 0, plan, 2, "asian", 3)
    with pytest.raises(ValueError):
        kmw.partials(lt, par, scal, 1, 0, plan, 2, "asian", 0)
    gops = tuple(x.to(dev) for x in kmw.am_greek_ops(bk, chol, 3))
    with pytest.raises(ValueError):  # K30's rows handed to K32
        kmw.am_greek_partials(gops[0], lt, par, 1, 0, plan, 2, 3)


# K33: the packed basket-Asian Greeks (a > 8), and its price against K31's.
_MW_PACKED = {
    # name: (assets, n_obs, antithetic, kahan)
    "a9_n13": (9, 13, False, True),
    "a16_n12_antithetic": (16, 12, True, True),
    "a16_n7_f32": (16, 7, False, False),
    "a17_n6_antithetic_f32": (17, 6, True, False),
    "a32_n5_antithetic": (32, 5, True, True),
    "a100_n5_antithetic_f32": (100, 5, True, False),
    "a129_n4": (129, 4, False, True),
}


@pytest.mark.parametrize("case", sorted(_MW_PACKED))
def test_multi_walk_packed_greek_kernel_matches_plain(dev, case):
    """K33 against its plain version, by the scaled pair bound; its padded
    lanes exactly 0."""
    a, n_obs, antithetic, kahan = _MW_PACKED[case]
    bk, chol, plan = _mw_setup(dev, a, n_obs, antithetic, kahan)
    ops = tuple(x.to(dev) for x in kmw.packed_greek_ops(bk, chol, n_obs))
    _contract(
        lambda off, nb: _mw_greek_pairs(kmw.am_greek_partials(
            *ops, SEED, off, plan, nb, n_obs)),
        lambda off, nb: _mw_greek_pairs(kmw.packed_greek_plain_partials(
            *ops, SEED, off, plan, nb, n_obs)),
        units=plan.iters * plan.units_per_iter)
    _, vec = kmw.am_greek_partials(*ops, SEED, 0, plan, NB, n_obs)
    a_tile = kmw.pack_factor(a)[0]
    pad = vec.view(NB, 4, -1, a_tile)[..., a:]
    assert bool((pad == 0).all())


@pytest.mark.parametrize("a", [9, 16, 17, 32])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_multi_walk_packed_greek_register_kernel_matches_plain(
        dev, a, antithetic, kahan):
    """K33's register kernel (a_tile 16 at 9 and 16 assets, 32 at 17 and
    32) at 5 dates (the trailing half pair) against its plain version, by
    the scaled pair bound; its padded lanes exactly 0."""
    n_obs = 5
    bk, chol, plan = _mw_setup(dev, a, n_obs, antithetic, kahan)
    ops = tuple(x.to(dev) for x in kmw.packed_greek_ops(bk, chol, n_obs))
    _contract(
        lambda off, nb: _mw_greek_pairs(kmw.am_greek_partials(
            *ops, SEED, off, plan, nb, n_obs)),
        lambda off, nb: _mw_greek_pairs(kmw.packed_greek_plain_partials(
            *ops, SEED, off, plan, nb, n_obs)),
        units=plan.iters * plan.units_per_iter)
    _, vec = kmw.am_greek_partials(*ops, SEED, 0, plan, NB, n_obs)
    a_tile = kmw.pack_factor(a)[0]
    assert bool((vec.view(NB, 4, -1, a_tile)[..., a:] == 0).all())


@pytest.mark.parametrize("a", [9, 16, 17, 32])
@pytest.mark.parametrize("antithetic", [False, True])
def test_multi_walk_packed_greek_price_equals_pricer(dev, a, antithetic):
    """K33's price sums equal K31's bit for bit at n_obs = 16 (acc * (1/n)
    is acc / n): one walk order, one pass shape, one block reduction."""
    n_obs = 16
    bk, chol, plan = _mw_setup(dev, a, n_obs, antithetic, True)
    lt, par = (x.to(dev) for x in kmw.walk_ops(bk, chol, n_obs))
    price = kmw.partials(lt, par, kmw.scalars(bk).to(dev), SEED, 0, plan, NB,
                         "asian", n_obs)
    ops = tuple(x.to(dev) for x in kmw.packed_greek_ops(bk, chol, n_obs))
    scal, _ = kmw.am_greek_partials(*ops, SEED, 0, plan, NB, n_obs)
    assert torch.equal(scal[:, :2], price)


def test_multi_walk_packed_greek_launch_counter(dev):
    bk, chol, plan = _mw_setup(dev, 16, 3, False, True, rows=8)
    ops = tuple(x.to(dev) for x in kmw.packed_greek_ops(bk, chol, 3))
    before = dict(kmw.LAUNCHES)
    kmw.am_greek_partials(*ops, 1, 0, plan, 2, 3)
    kmw.packed_greek_plain_partials(*ops, 1, 0, plan, 2, 3)
    assert kmw.LAUNCHES["basket_asian_greeks_packed"] == \
        before["basket_asian_greeks_packed"] + 1
    assert sum(kmw.LAUNCHES.values()) == sum(before.values()) + 1
    with pytest.raises(ValueError):  # K31's rows handed to K33
        kmw.am_greek_partials(ops[0], ops[1], ops[2][:5].contiguous(), 1, 0,
                              plan, 2, 3)


# K35: the packed basket-barrier LR Greeks (a > 8), and its price against
# K31's.
@pytest.mark.parametrize("case", sorted(_MW_PACKED))
@pytest.mark.parametrize("up", [True, False])
def test_multi_walk_packed_bar_greek_kernel_matches_plain(dev, case, up):
    """K35 against its plain version, by the scaled pair bound; its padded
    lanes exactly 0."""
    a, n_obs, antithetic, kahan = _MW_PACKED[case]
    bk, chol, plan = _mw_setup(dev, a, n_obs, antithetic, kahan)
    ops = tuple(x.to(dev) for x in kmw.packed_bar_greek_ops(
        bk, chol, n_obs, 104.0 if up else 96.0))
    _contract(
        lambda off, nb: _mw_greek_pairs(kmw.bar_greek_partials(
            *ops, SEED, off, plan, nb, n_obs, up)),
        lambda off, nb: _mw_greek_pairs(kmw.packed_bar_greek_plain_partials(
            *ops, SEED, off, plan, nb, n_obs, up)),
        units=plan.iters * plan.units_per_iter)
    _, vec = kmw.bar_greek_partials(*ops, SEED, 0, plan, NB, n_obs, up)
    a_tile = kmw.pack_factor(a)[0]
    pad = vec.view(NB, 4, -1, a_tile)[..., a:]
    assert bool((pad == 0).all())


@pytest.mark.parametrize("a", [9, 16, 17, 32])
@pytest.mark.parametrize("antithetic", [False, True])
def test_multi_walk_packed_bar_greek_price_equals_pricer(dev, a, antithetic):
    """K35's price sums equal K31's bit for bit: one walk order, one pass
    shape (rows 16), one block reduction (both in registers at a_tile 16
    and 32)."""
    n_obs = 13
    bk, chol, plan = _mw_setup(dev, a, n_obs, antithetic, True)
    lt, par = (x.to(dev) for x in kmw.walk_ops(bk, chol, n_obs))
    price = kmw.partials(lt, par, kmw.scalars(bk, 106.0).to(dev), SEED, 0,
                         plan, NB, "barrier", n_obs, True)
    ops = tuple(x.to(dev) for x in kmw.packed_bar_greek_ops(bk, chol, n_obs,
                                                            106.0))
    scal, _ = kmw.bar_greek_partials(*ops, SEED, 0, plan, NB, n_obs, True)
    assert torch.equal(scal[:, :2], price)


def test_multi_walk_packed_bar_greek_launch_counter(dev):
    bk, chol, plan = _mw_setup(dev, 16, 3, False, True, rows=8)
    ops = tuple(x.to(dev) for x in kmw.packed_bar_greek_ops(bk, chol, 3,
                                                            110.0))
    before = dict(kmw.LAUNCHES)
    kmw.bar_greek_partials(*ops, 1, 0, plan, 2, 3, True)
    kmw.packed_bar_greek_plain_partials(*ops, 1, 0, plan, 2, 3, True)
    assert kmw.LAUNCHES["basket_barrier_greeks_packed"] == \
        before["basket_barrier_greeks_packed"] + 1
    assert sum(kmw.LAUNCHES.values()) == sum(before.values()) + 1
    with pytest.raises(ValueError):  # a short scal
        kmw.bar_greek_partials(ops[0][:3].contiguous(), *ops[1:], 1, 0, plan,
                               2, 3, True)


@pytest.mark.parametrize("rows", [24, 40])
@pytest.mark.parametrize("case", ["a9_n13", "a16_n12_antithetic",
                                  "a32_n5_antithetic"])
def test_multi_walk_packed_bar_greek_passes_match_plain(dev, case, rows):
    """K35 at rows whose power-of-two pass (8) leaves 3 or 5 passes, so the
    halving tree's last levels over the passes carry an odd row, against
    its plain version."""
    a, n_obs, antithetic, kahan = _MW_PACKED[case]
    bk, chol, plan = _mw_setup(dev, a, n_obs, antithetic, kahan, rows=rows)
    ops = tuple(x.to(dev) for x in kmw.packed_bar_greek_ops(bk, chol, n_obs,
                                                            104.0))
    _contract(
        lambda off, nb: _mw_greek_pairs(kmw.bar_greek_partials(
            *ops, SEED, off, plan, nb, n_obs, True)),
        lambda off, nb: _mw_greek_pairs(kmw.packed_bar_greek_plain_partials(
            *ops, SEED, off, plan, nb, n_obs, True)),
        units=plan.iters * plan.units_per_iter)


@pytest.mark.parametrize("rows", [24, 35])
@pytest.mark.parametrize("case", ["a16_n7_f32", "a32_n5_antithetic",
                                  "a100_n5_antithetic_f32"])
def test_multi_walk_packed_uneven_rows_match_plain(dev, case, rows):
    """K31 (both products) and K33 against their plain versions at rows
    that are not a power of two: K31 splits them evenly over its passes
    (at 35 rows of 16 assets its last pass holds a row fewer; 32 assets
    take one pass of all the rows, 96 or 140 of its threads), K33 takes a
    power of two of rows a pass."""
    a, n_obs, antithetic, kahan = _MW_PACKED[case]
    bk, chol, plan = _mw_setup(dev, a, n_obs, antithetic, kahan, rows=rows)
    lt, par = (x.to(dev) for x in kmw.walk_ops(bk, chol, n_obs))
    for kind, up, h in _MW_PRODUCTS.values():
        scal = kmw.scalars(bk, h).to(dev)
        _contract(
            lambda off, nb: kmw.partials(lt, par, scal, SEED, off, plan, nb,
                                         kind, n_obs, up),
            lambda off, nb: kmw.plain_partials(lt, par, scal, SEED, off,
                                               plan, nb, kind, n_obs, up))
    ops = tuple(x.to(dev) for x in kmw.packed_greek_ops(bk, chol, n_obs))
    _contract(
        lambda off, nb: _mw_greek_pairs(kmw.am_greek_partials(
            *ops, SEED, off, plan, nb, n_obs)),
        lambda off, nb: _mw_greek_pairs(kmw.packed_greek_plain_partials(
            *ops, SEED, off, plan, nb, n_obs)),
        units=plan.iters * plan.units_per_iter)


# K36, K37, K38: the rainbow call.
_RB_STRIKE = {1: 100.0, 2: 95.0, 3: 90.0, 8: 85.0, 9: 80.0, 16: 75.0,
              100: 60.0, 129: 60.0}


def _rainbow(a, kind):
    """Spots 90..110, vols 0.15..0.35, equicorrelation 0.3; the min call's
    strike lowered with the basket so that paths finish in the money."""
    j = np.arange(a)
    return RainbowOption.equicorrelated(
        90.0 + 20.0 * ((j * 7) % 11) / 10.0, 0.15 + 0.05 * (j % 5), 0.3,
        100.0 if kind == "max" else _RB_STRIKE[a], 0.05, kind=kind)


def _rb_plan(a, antithetic, kahan, rows=16):
    probe = krainbow.make_plan(1, NB, rows, antithetic, kahan, n_assets=a)
    return krainbow.make_plan(2 * NB * probe.paths_per_iter, NB, rows,
                              antithetic, kahan, n_assets=a)


@pytest.mark.parametrize("a", sorted(_RB_STRIKE))
@pytest.mark.parametrize("kind", ["max", "min"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_rainbow_kernels_match_plain(dev, a, kind, antithetic):
    """K36 (a <= 8) and K37 against the plain version; Kahan off for the
    antithetic cases."""
    opt = _rainbow(a, kind)
    ops = krainbow.operands(opt, cholesky_lower(opt.corr), dev)
    plan = _rb_plan(a, antithetic, not antithetic)
    _contract(lambda off, nb: krainbow.partials(ops, SEED, off, plan, nb),
              lambda off, nb: krainbow.plain_partials(ops, SEED, off, plan,
                                                      nb))


@pytest.mark.parametrize("a", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["max", "min"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_rainbow_greeks_kernel_matches_plain(dev, a, kind, antithetic):
    """K38 against its plain version by the scaled pair bound, and its price
    sums equal K36's bit for bit."""
    opt = _rainbow(a, kind)
    chol = cholesky_lower(opt.corr)
    gops = krainbow.greek_operands(opt, chol, dev)
    plan = _rb_plan(a, antithetic, antithetic)
    _contract(
        lambda off, nb: krainbow.greek_partials(gops, SEED, off, plan, nb),
        lambda off, nb: krainbow.greek_plain_partials(gops, SEED, off, plan,
                                                      nb),
        units=plan.iters * plan.units_per_iter)
    price = krainbow.partials(krainbow.operands(opt, chol, dev), SEED, 0,
                              plan, NB)
    greek = krainbow.greek_partials(gops, SEED, 0, plan, NB)
    assert torch.equal(greek[:, :2], price)


def test_rainbow_launch_counters_and_bad_operands(dev):
    for a, name in ((3, "rainbow_am"), (16, "rainbow_packed")):
        opt = _rainbow(a, "max")
        ops = krainbow.operands(opt, cholesky_lower(opt.corr), dev)
        plan = _rb_plan(a, False, True, rows=8)
        before = dict(krainbow.LAUNCHES)
        krainbow.partials(ops, 1, 0, plan, 2)
        krainbow.plain_partials(ops, 1, 0, plan, 2)
        assert krainbow.LAUNCHES[name] == before[name] + 1, name
        assert sum(krainbow.LAUNCHES.values()) == sum(before.values()) + 1
        with pytest.raises(ValueError):
            krainbow.partials(dataclasses.replace(ops, par=ops.par.double()),
                              1, 0, plan, 2)
    opt = _rainbow(3, "min")
    gops = krainbow.greek_operands(opt, cholesky_lower(opt.corr), dev)
    plan = _rb_plan(3, False, True, rows=8)
    before = krainbow.LAUNCHES["rainbow_greeks"]
    krainbow.greek_partials(gops, 1, 0, plan, 2)
    krainbow.greek_plain_partials(gops, 1, 0, plan, 2)
    assert krainbow.LAUNCHES["rainbow_greeks"] == before + 1
    with pytest.raises(ValueError):
        krainbow.greek_partials(
            dataclasses.replace(gops, inv_s0=gops.inv_s0[:2].contiguous()), 1,
            0, plan, 2)
    wide = _rainbow(9, "max")
    with pytest.raises(ValueError, match="1..8"):
        krainbow.greek_partials(krainbow.greek_operands(
            wide, cholesky_lower(wide.corr), dev), 1, 0, plan, 2)


# ---- the netting-set CVA and xVA: K39-K44 ------------------------------------

def _netting_set(m: int, n_grid: int, mixed: bool) -> CvaMultiSpec:
    """``m`` calls at correlation 0.5: the JAX exotic CLI's all-long legs
    (s = k = 100, v = 0.2, w = 1/m), or the mixed-sign pair's legs (s
    100/95, v 0.2/0.3, k 100/90, w 1/-0.6) alternated over the set."""
    corr = np.full((m, m), 0.5) + 0.5 * np.eye(m)
    odd = np.arange(m) % 2 == 1
    if not mixed:
        full = np.full(m, 100.0)
        return CvaMultiSpec(0.03, 0.6, full, np.full(m, 0.2), corr, 0.05, 1.0,
                            full, np.full(m, 1.0 / m), n_grid)
    pick = lambda a, b: np.where(odd, b, a)  # noqa: E731
    return CvaMultiSpec(0.03, 0.6, pick(100.0, 95.0), pick(0.2, 0.3), corr,
                        0.05, 1.0, pick(100.0, 90.0), pick(1.0, -0.6),
                        n_grid)


_CM_CASES = {
    # name: (underlyings, mixed, n_grid, antithetic, kahan)
    "m1_g13": (1, False, 13, False, True),
    "m2_mixed_g13_antithetic": (2, True, 13, True, True),
    "m3_g7_f32": (3, False, 7, False, False),
    "m8_mixed_g13_antithetic_f32": (8, True, 13, True, False),
    "m9_mixed_g13": (9, True, 13, False, True),
    "m16_g12_antithetic": (16, False, 12, True, True),
    "m17_mixed_g13_antithetic_f32": (17, True, 13, True, False),
    "m32_g12": (32, False, 12, False, True),
    "m100_mixed_g5_f32": (100, True, 5, False, False),
}


def _cm_setup(dev, m, mixed, n_grid, antithetic, kahan, rows=16,
              greeks=False):
    spec = _netting_set(m, n_grid, mixed)
    ops = kcm.operands(spec, cholesky_lower(spec.corr), dev, greeks)
    probe = kcm.make_plan(1, NB, rows, antithetic, kahan, n_underlyings=m)
    plan = kcm.make_plan(2 * NB * probe.paths_per_iter, NB, rows, antithetic,
                         kahan, n_underlyings=m)
    return ops, plan


@pytest.mark.parametrize("case", sorted(_CM_CASES))
def test_cva_multi_kernels_match_plain(dev, case):
    """K40 (m <= 8) and K39 against the plain version: the price pairs and
    the EE profile (summed per warp, then across warps, against the plain
    version's sum over the block) at rtol."""
    ops, plan = _cm_setup(dev, *_CM_CASES[case])
    _contract(lambda off, nb: kcm.partials(ops, SEED, off, plan, nb),
              lambda off, nb: kcm.plain_partials(ops, SEED, off, plan, nb))


@pytest.mark.parametrize("case", sorted(_CM_CASES))
def test_cva_multi_greek_kernel_matches_plain(dev, case):
    """K42 (m <= 8) and K41 against their plain versions, by the scaled
    pair bound (K41's padded lanes exactly 0); K42's CVA sums equal K40's
    bit for bit, K41's K39's at rtol 1e-5 (two forms of the leg)."""
    m = _CM_CASES[case][0]
    ops, plan = _cm_setup(dev, *_CM_CASES[case], greeks=True)
    _contract(
        lambda off, nb: _mw_greek_pairs(kcm.greek_partials(ops, SEED, off,
                                                           plan, nb)),
        lambda off, nb: _mw_greek_pairs(kcm.greek_plain_partials(
            ops, SEED, off, plan, nb)),
        units=plan.iters * plan.units_per_iter)
    scal, vec = kcm.greek_partials(ops, SEED, 0, plan, NB)
    pops, _ = _cm_setup(dev, *_CM_CASES[case])
    price, _ = kcm.partials(pops, SEED, 0, plan, NB)
    if m <= 8:
        assert torch.equal(scal[:, :2], price)
    else:
        a_tile, c, _ = kbasket.pack_factor(m)
        assert (vec.reshape(NB, 4, c, a_tile)[..., m:] == 0).all()
        np.testing.assert_allclose(scal[:, :2].cpu().numpy(),
                                   price.cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("m, rows", [(9, 35), (16, 35), (17, 69), (32, 69)])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("antithetic", [False, True])
def test_cva_multi_register_kernel_uneven_rows_match_plain(dev, m, rows,
                                                           mixed,
                                                           antithetic):
    """K39's register instances (a_tile 16 at 9 and 16 underlyings, 32 at
    17 and 32) at rows that leave a pass with lanes past the tile's rows
    (35 rows: two passes of 18 at a_tile 16; 69: two of 35 at a_tile 32),
    mixed and all-long legs, against the plain version: the price pairs and
    the EE profile at rtol (the idle lanes add 0 to their warps' profile
    sums)."""
    ops, plan = _cm_setup(dev, m, mixed, 13, antithetic, not antithetic,
                          rows=rows)
    _contract(lambda off, nb: kcm.partials(ops, SEED, off, plan, nb),
              lambda off, nb: kcm.plain_partials(ops, SEED, off, plan, nb))


@pytest.mark.parametrize("m, rows", [(9, 35), (16, 35), (17, 69), (32, 69)])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("antithetic", [False, True])
def test_cva_multi_greek_register_kernel_uneven_rows_match_plain(
        dev, m, rows, mixed, antithetic):
    """K41's register instances (a_tile 16 at 9 and 16 underlyings, 32 at
    17 and 32) at rows that are no power of two (35 and 69: one-row passes
    of c paths), mixed and all-long legs, against the plain version by the
    scaled pair bound; the padded lanes exactly 0; its CVA sums within
    1e-5 of K39's (the two forms of a leg)."""
    ops, plan = _cm_setup(dev, m, mixed, 13, antithetic, not antithetic,
                          rows=rows, greeks=True)
    _contract(
        lambda off, nb: _mw_greek_pairs(kcm.greek_partials(ops, SEED, off,
                                                           plan, nb)),
        lambda off, nb: _mw_greek_pairs(kcm.greek_plain_partials(
            ops, SEED, off, plan, nb)),
        units=plan.iters * plan.units_per_iter)
    scal, vec = kcm.greek_partials(ops, SEED, 0, plan, NB)
    a_tile, c, _ = kbasket.pack_factor(m)
    assert (vec.reshape(NB, 4, c, a_tile)[..., m:] == 0).all()
    pops, _ = _cm_setup(dev, m, mixed, 13, antithetic, not antithetic,
                        rows=rows)
    price, _ = kcm.partials(pops, SEED, 0, plan, NB)
    np.testing.assert_allclose(scal[:, :2].cpu().numpy(),
                               price.cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("m, rows", [(5, 16), (3, 10)])
@pytest.mark.parametrize("kahan", [False, True])
def test_cva_multi_split_kernel_matches_plain_and_ties(dev, m, rows, kahan):
    """K40's split and fold at two iterations, antithetic: at m = 5 (the
    unsplit kernel's 256 threads) and at m = 3, rows 10, where the last
    pass of 512 threads leaves half the warps idle.  Against the plain
    version; K42's CVA sums (the unsplit order) equal K40's bit for bit,
    and so do K43's CVA sums and EPE profile at no own default and no
    funding."""
    ops, plan = _cm_setup(dev, m, True, 13, True, kahan, rows=rows)
    assert plan.iters == 2
    _contract(lambda off, nb: kcm.partials(ops, SEED, off, plan, nb),
              lambda off, nb: kcm.plain_partials(ops, SEED, off, plan, nb))
    price, prof = kcm.partials(ops, SEED, 0, plan, NB)
    gops, _ = _cm_setup(dev, m, True, 13, True, kahan, rows=rows,
                        greeks=True)
    assert torch.equal(kcm.greek_partials(gops, SEED, 0, plan, NB)[0][:, :2],
                       price)
    spec = XvaSpec(_netting_set(m, 13, True), own_intensity=0.0,
                   own_lgd=0.5, funding_spread=0.0)
    xops = kcm.xva_operands(spec, cholesky_lower(spec.netting.corr), dev)
    xs, xp = kcm.xva_partials(xops, SEED, 0, plan, NB)
    assert torch.equal(xs[:, :2], price) and torch.equal(xp[:, 0], prof)


@pytest.mark.parametrize("antithetic", [False, True])
def test_cva_multi_grouped_scratch_matches_one_group(dev, antithetic):
    """K40 under a forced small scratch cap: at 1 float every (block,
    iteration) is split and folded on its own (12 groups), at half the
    one-group scratch the blocks go in groups with their iterations; both
    equal the one-group launch bit for bit."""
    ops, plan = _cm_setup(dev, 3, False, 13, antithetic, True, rows=10)
    lib = _build.library()
    shape = (3, 13, NB, plan.rows, plan.iters, int(antithetic))
    whole = lib.mctpu_cva_multi_am_scratch_floats(*shape, 0)
    assert lib.mctpu_cva_multi_am_scratch_floats(*shape, 1) < whole
    want = kcm.partials(ops, SEED, 0, plan, NB)
    for cap in (1, whole // 2):
        got = kcm.partials(ops, SEED, 0, plan, NB, scratch_cap=cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), cap


def test_cva_multi_launch_counters_and_bad_operands(dev):
    for m, names in ((3, ("cva_multi_am", "cva_multi_greeks_am")),
                     (9, ("cva_multi_packed", "cva_multi_greeks_packed"))):
        ops, plan = _cm_setup(dev, m, False, 3, False, True, rows=8)
        gops, _ = _cm_setup(dev, m, False, 3, False, True, rows=8,
                            greeks=True)
        for name, (fn, plain, o) in zip(names, (
                (kcm.partials, kcm.plain_partials, ops),
                (kcm.greek_partials, kcm.greek_plain_partials, gops))):
            before = dict(kcm.LAUNCHES)
            fn(o, 1, 0, plan, 2)
            plain(o, 1, 0, plan, 2)
            assert kcm.LAUNCHES[name] == before[name] + 1, name
            assert sum(kcm.LAUNCHES.values()) == sum(before.values()) + 1
    with pytest.raises(ValueError):
        kcm.partials(dataclasses.replace(ops, par=ops.par.double()), 1, 0,
                     plan, 2)
    with pytest.raises(ValueError, match="greeks=True"):
        kcm.greek_partials(ops, 1, 0, plan, 2)


_XVA_CASES = {
    # name: (underlyings, mixed, n_grid, antithetic, kahan); past 8 the
    # runtime-m kernels
    "m1_g13": (1, False, 13, False, True),
    "m2_mixed_g13_antithetic": (2, True, 13, True, True),
    "m3_g7_f32": (3, False, 7, False, False),
    "m8_mixed_g13_antithetic_f32": (8, True, 13, True, False),
    "m9_mixed_g13": (9, True, 13, False, True),
    "m16_g12_antithetic": (16, False, 12, True, True),
    "m17_mixed_g13_antithetic_f32": (17, True, 13, True, False),
    "m100_mixed_g7": (100, True, 7, False, True),
}


def _xva_setup(dev, m, mixed, n_grid, antithetic, kahan, greeks=False,
               own=0.02, spread=0.01, rows=16):
    spec = XvaSpec(_netting_set(m, n_grid, mixed), own_intensity=own,
                   own_lgd=0.5, funding_spread=spread)
    ops = kcm.xva_operands(spec, cholesky_lower(spec.netting.corr), dev,
                           greeks)
    plan = kcm.make_plan(2 * NB * rows * 128, NB, rows, antithetic, kahan,
                         n_underlyings=1)
    return ops, plan


def _xva_two_iters(plan):
    """``plan`` at two iterations, its blocks and rows kept."""
    return kcm.make_plan(2 * NB * plan.paths_per_iter, NB, plan.rows,
                         plan.antithetic, plan.kahan, n_underlyings=1)


@pytest.mark.parametrize("case", sorted(_XVA_CASES))
def test_xva_kernels_match_plain(dev, case):
    """K43 (m <= 8) and its runtime-m kernel against the plain version: the
    leg pairs and both profiles at rtol."""
    ops, plan = _xva_setup(dev, *_XVA_CASES[case])
    _contract(lambda off, nb: kcm.xva_partials(ops, SEED, off, plan, nb),
              lambda off, nb: kcm.xva_plain_partials(ops, SEED, off, plan,
                                                     nb))


@pytest.mark.parametrize("case", sorted(_XVA_CASES))
def test_xva_greek_kernels_match_plain(dev, case):
    """K44 (m <= 8) and its runtime-m kernel against the plain version, by
    the scaled pair bound."""
    ops, plan = _xva_setup(dev, *_XVA_CASES[case], greeks=True)
    _contract(
        lambda off, nb: _mw_greek_pairs(kcm.xva_greek_partials(
            ops, SEED, off, plan, nb)),
        lambda off, nb: _mw_greek_pairs(kcm.xva_greek_plain_partials(
            ops, SEED, off, plan, nb)),
        units=plan.iters * plan.units_per_iter)


@pytest.mark.parametrize("antithetic", [False, True])
def test_xva_ties_cva_multi_and_runtime_m_kernels(dev, antithetic):
    """At own_intensity = 0 and funding_spread = 0 K43's CVA sums and EPE
    profile are K40's bit for bit; the runtime-m kernels forced at m = 3
    match K43's and K44's M = 3 kernels at the kernel-vs-plain tolerance
    (the same arithmetic, another block reduction's thread count)."""
    ops, plan = _xva_setup(dev, 3, False, 13, antithetic, True, own=0.0,
                           spread=0.0)
    cops, _ = _cm_setup(dev, 3, False, 13, antithetic, True)
    xs, xp = kcm.xva_partials(ops, SEED, 0, plan, NB)
    cs, cp = kcm.partials(cops, SEED, 0, plan, NB)
    assert torch.equal(xs[:, :2], cs) and torch.equal(xp[:, 0], cp)
    ops, _ = _xva_setup(dev, 3, True, 13, antithetic, True)
    for a, b in zip(kcm.xva_partials(ops, SEED, 0, plan, NB),
                    kcm.xva_partials(ops, SEED, 0, plan, NB, wide=True)):
        np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                   rtol=RTOL, atol=0)
    gops, _ = _xva_setup(dev, 3, True, 13, antithetic, True, greeks=True)
    assert_pairs_close(
        _mw_greek_pairs(kcm.xva_greek_partials(gops, SEED, 0, plan, NB,
                                               wide=True)).cpu().numpy(),
        _mw_greek_pairs(kcm.xva_greek_partials(gops, SEED, 0, plan,
                                               NB)).cpu().numpy(),
        plan.iters * plan.units_per_iter, RTOL)


@pytest.mark.parametrize("m, rows", [(1, 10), (3, 10), (8, 11)])
@pytest.mark.parametrize("antithetic", [False, True])
def test_xva_split_kernel_uneven_rows_matches_plain(dev, m, rows,
                                                    antithetic):
    """K43's split and fold at two iterations and rows whose last pass
    leaves warps of the unsplit kernel idle (10 rows at 512 threads, 11 at
    256), mixed legs, against the plain version: the leg pairs and both
    profiles at rtol."""
    ops, plan = _xva_setup(dev, m, True, 13, antithetic, not antithetic,
                           rows=rows)
    plan = _xva_two_iters(plan)
    assert plan.iters == 2
    _contract(lambda off, nb: kcm.xva_partials(ops, SEED, off, plan, nb),
              lambda off, nb: kcm.xva_plain_partials(ops, SEED, off, plan,
                                                     nb))


@pytest.mark.parametrize("antithetic", [False, True])
def test_xva_grouped_scratch_matches_one_group(dev, antithetic):
    """K43 under a forced small scratch cap: at 1 float every (block,
    iteration) is split and folded on its own (12 groups), at half the
    one-group scratch the blocks go in groups with their iterations; both
    equal the one-group launch bit for bit."""
    ops, plan = _xva_setup(dev, 3, True, 13, antithetic, True, rows=10)
    plan = _xva_two_iters(plan)
    lib = _build.library()
    shape = (3, 13, 0, 0, NB, plan.rows, plan.iters, int(antithetic))
    whole = lib.mctpu_xva_scratch_floats(*shape, 0)
    assert lib.mctpu_xva_scratch_floats(*shape, 1) < whole
    want = kcm.xva_partials(ops, SEED, 0, plan, NB)
    for cap in (1, whole // 2):
        got = kcm.xva_partials(ops, SEED, 0, plan, NB, scratch_cap=cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), cap


@pytest.mark.parametrize("m, rows", [(3, 10), (8, 11), (9, 13), (17, 13),
                                     (33, 13)])
@pytest.mark.parametrize("antithetic", [False, True])
def test_xva_greek_split_grouped_scratch_matches_plain(dev, m, rows,
                                                       antithetic):
    """K44 (its split and fold at m <= 8, its runtime-m slices past it) at
    two iterations and rows that leave a short last pass or slice, mixed
    legs, against the plain version by the scaled pair bound; under a
    forced small scratch cap (1 float: every (block, iteration) its own
    group, the fold's carry between them; half the one-group scratch) bit
    for bit the one-group launch."""
    ops, plan = _xva_setup(dev, m, True, 5, antithetic, not antithetic,
                           greeks=True, rows=rows)
    plan = _xva_two_iters(plan)
    _contract(
        lambda off, nb: _mw_greek_pairs(kcm.xva_greek_partials(
            ops, SEED, off, plan, nb)),
        lambda off, nb: _mw_greek_pairs(kcm.xva_greek_plain_partials(
            ops, SEED, off, plan, nb)), units=_units(plan))
    lib = _build.library()
    shape = (m, 5, 1, int(m > 8), NB, plan.rows, plan.iters,
             int(antithetic))
    whole = lib.mctpu_xva_scratch_floats(*shape, 0)
    want = kcm.xva_greek_partials(ops, SEED, 0, plan, NB)
    for cap in (1, whole // 2):
        got = kcm.xva_greek_partials(ops, SEED, 0, plan, NB,
                                     scratch_cap=cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), cap


def test_xva_runtime_m_capped_grid_matches_plain(dev):
    """K43's runtime-m kernel past its register tiles (33 underlyings) on
    2048 (block, slice) items, more than the card holds at once, so each
    CUDA block of the capped grid takes several: against the plain version,
    two launches bitwise, the block offsets."""
    ops, _ = _xva_setup(dev, 33, True, 3, False, True)
    plan = kcm.make_plan(256 * 64 * 128, 256, 64, False, True,
                         n_underlyings=1)
    _contract(lambda off, nb: kcm.xva_partials(ops, SEED, off, plan, nb),
              lambda off, nb: kcm.xva_plain_partials(ops, SEED, off, plan,
                                                     nb), n_blocks=256)


def test_xva_runtime_m_long_grid_matches_plain(dev):
    """K43's runtime-m kernel at 1601 nodes, where a CUDA block's profile
    slots outgrow shared memory and lie in its scratch: against the plain
    version, two launches bitwise, the block offsets."""
    ops, _ = _xva_setup(dev, 9, True, 1601, False, True)
    plan = kcm.make_plan(3 * 8 * 128, 3, 8, False, True, n_underlyings=1)
    _contract(lambda off, nb: kcm.xva_partials(ops, SEED, off, plan, nb),
              lambda off, nb: kcm.xva_plain_partials(ops, SEED, off, plan,
                                                     nb), n_blocks=3)


def test_xva_launch_counters_and_bad_operands(dev):
    for m, wide in ((3, False), (9, True)):
        ops, plan = _xva_setup(dev, m, True, 3, False, True)
        gops, _ = _xva_setup(dev, m, True, 3, False, True, greeks=True)
        suffix = "wide" if wide else "am"
        for name, (fn, plain, o) in (
                (f"xva_{suffix}", (kcm.xva_partials, kcm.xva_plain_partials,
                                   ops)),
                (f"xva_greeks_{suffix}", (kcm.xva_greek_partials,
                                          kcm.xva_greek_plain_partials,
                                          gops))):
            before = dict(kcm.LAUNCHES)
            fn(o, 1, 0, plan, 2)
            plain(o, 1, 0, plan, 2)
            assert kcm.LAUNCHES[name] == before[name] + 1, name
            assert sum(kcm.LAUNCHES.values()) == sum(before.values()) + 1
    with pytest.raises(ValueError, match="nodes"):
        kcm.xva_partials(gops, 1, 0, plan, 2)
    with pytest.raises(ValueError, match="nodes"):
        kcm.xva_greek_partials(ops, 1, 0, plan, 2)
    with pytest.raises(ValueError):
        kcm.xva_partials(dataclasses.replace(ops, par=ops.par.double()), 1,
                         0, plan, 2)


# ---- K45-K48: the control variates -----------------------------------------

def _cv_contract(dev, opt, antithetic, kahan=True, rows=16):
    """K45-K48 against their plain versions on ``opt``'s CV launch at NB
    blocks of ``rows`` rows, 2 iterations, at the a-priori float32
    centers."""
    prec = Precision.F32_KAHAN if kahan else Precision.F32
    setup = variance.cv_setup(opt, 1, EngineConfig(
        num_blocks=NB, rows=rows, precision=prec, antithetic=antithetic,
        auto_shrink=False))
    plan = dataclasses.replace(setup.plan, iters=2)
    ops = setup.operands(kvr.center32(setup.center))
    _contract(lambda off, nb: setup.partials(ops, SEED, off, plan, nb),
              lambda off, nb: setup.plain_partials(ops, SEED, off, plan, nb),
              units=plan.iters * plan.units_per_iter, moments=True)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_vanilla_cv_kernel_matches_plain(dev, antithetic, kahan):
    for k in (100.0, 20.0):  # at the money; deep in the money (d near 0)
        _cv_contract(dev, VanillaOption(100., k, 0.04879, 0.2, 1.),
                     antithetic, kahan)


@pytest.mark.parametrize("n_obs", [1, 8, 13, 50])
@pytest.mark.parametrize("antithetic", [False, True])
def test_asian_cv_kernel_matches_plain(dev, n_obs, antithetic):
    _cv_contract(dev, AsianOption(100., 100., 0.05, 0.2, 1., n_obs=n_obs),
                 antithetic, kahan=n_obs != 8)


@pytest.mark.parametrize("n_assets", [1, 3, 8, 9, 16, 17, 32, 64, 100,
                                      300])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_basket_cv_kernel_matches_plain(dev, n_assets, antithetic, kahan):
    """K47 up to 8 assets; K48's split kernel and fold beyond, its tiled
    product at every a_tile (16 at 9 and 16 assets, 32 at 17 and 32, 64,
    128 at 100) and past width 128 (300 assets, width 384: the per-path
    code)."""
    opt = BasketOption.equicorrelated(n_assets, 0.3)
    if n_assets == 3:  # a Brownian offset on every asset
        opt = dataclasses.replace(opt, d=np.full(3, 0.3))
    _cv_contract(dev, opt, antithetic, kahan)


@pytest.mark.parametrize("n_assets", [17, 100])
@pytest.mark.parametrize("antithetic", [False, True])
def test_basket_cv_short_last_chunk_matches_plain(dev, n_assets, antithetic):
    """K48 at 100 rows, which its chunks do not divide: at 17 assets six
    chunks of 16 rows and one of 4, at 100 assets one of 64 and one of 36
    (units past the chunk's in its tile's warps, summing threads idle)."""
    _cv_contract(dev, BasketOption.equicorrelated(n_assets, 0.3), antithetic,
                 rows=100)


@pytest.mark.parametrize("antithetic", [False, True])
def test_basket_cv_pilot_plan_matches_plain(dev, antithetic):
    """K48 on the pilot's plan of a 100-asset call (8 blocks of rows 16, at
    least 3 iterations, one CUDA block each): against the plain version,
    two launches bit-equal and the block-offset contract."""
    setup = variance.cv_setup(BasketOption.equicorrelated(100, 0.3),
                              1 << 20, EngineConfig(num_blocks=32, rows=16,
                                                    antithetic=antithetic,
                                                    auto_shrink=False))
    plan = variance._pilot_plan(setup.plan, 0.1)
    assert plan.num_blocks == 8 and plan.iters >= 3
    ops = setup.operands(kvr.center32(setup.center))
    _contract(lambda off, nb: setup.partials(ops, SEED, off, plan, nb),
              lambda off, nb: setup.plain_partials(ops, SEED, off, plan, nb),
              n_blocks=plan.num_blocks,
              units=plan.iters * plan.units_per_iter, moments=True)


def test_cv_pricers_launch_their_kernels(dev):
    """Each CV pricer runs two launches (pilot and main) of its kernel on
    the card."""
    cfg = EngineConfig(num_blocks=16, rows=16)
    calls = (
        ("vanilla_cv", variance.price_vanilla_cv,
         VanillaOption(100., 100., 0.04879, 0.2, 1.)),
        ("asian_cv", variance.price_asian_cv,
         AsianOption(100., 100., 0.05, 0.2, 1., n_obs=12)),
        ("basket_cv_am", variance.price_basket_cv,
         BasketOption.equicorrelated(3, 0.3)),
        ("basket_cv_packed", variance.price_basket_cv,
         BasketOption.equicorrelated(16, 0.3)))
    for name, fn, opt in calls:
        before = kvr.LAUNCHES[name]
        res = fn(opt, 1 << 18, SEED, cfg)
        assert kvr.LAUNCHES[name] == before + 2, name
        assert np.isfinite(float(res.price)) and float(res.std_error) > 0


# ---- K49: importance sampling; K50, K51: the American walk ----------------

@pytest.mark.parametrize("k,theta", [(100.0, 0.0), (200.0, None),
                                     (150.0, 3.0)])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_vanilla_is_kernel_matches_plain(dev, k, theta, antithetic, kahan):
    opt = VanillaOption(100., k, 0.05, 0.2, 1.)
    th = variance.optimal_tilt(opt) if theta is None else theta
    par = kvr.is_params(opt, th, dev)
    plan = kvanilla.make_plan(NB * 2 * 2 * 16 * 128, NB, 16, antithetic,
                              kahan)
    _contract(lambda off, nb: kvr.is_partials(par, SEED, off, plan, nb),
              lambda off, nb: kvr.is_plain_partials(par, SEED, off, plan,
                                                    nb))


def _lsm_ops(dev, n_steps, payoff):
    opt = AmericanOption(100., 100., 0.05, 0.2, 1., n_steps=n_steps,
                         payoff=payoff)
    beta = lsm.fit_exercise_rule(opt.s, opt.k, opt.r, opt.v, opt.t, 5,
                                 1 << 14, n_steps, payoff, device=dev)
    return opt, klsm.operands(opt, beta, dev)


@pytest.mark.parametrize("n_steps", [1, 13, 50])
@pytest.mark.parametrize("payoff", ["put", "call"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_lsm_kernels_match_plain(dev, n_steps, payoff, antithetic):
    """K50 and K51 against their plain versions (K51's pairs by the scaled
    bound), and K51's price sums equal K50's bit for bit."""
    _, ops = _lsm_ops(dev, n_steps, payoff)
    put = payoff == "put"
    for kahan in (False, True):
        plan = klsm.make_plan(NB * 2 * 16 * 128, NB, 16, antithetic, kahan)
        _contract(lambda off, nb: klsm.partials(ops, SEED, off, plan, nb,
                                                put),
                  lambda off, nb: klsm.plain_partials(ops, SEED, off, plan,
                                                      nb, put))
        _contract(lambda off, nb: klsm.greek_partials(ops, SEED, off, plan,
                                                      nb, put),
                  lambda off, nb: klsm.greek_plain_partials(ops, SEED, off,
                                                            plan, nb, put),
                  units=plan.iters * plan.units_per_iter)
        assert torch.equal(
            klsm.greek_partials(ops, SEED, 0, plan, NB, put)[:, :2],
            klsm.partials(ops, SEED, 0, plan, NB, put))


def test_american_launch_counters_and_price_tie(dev):
    """price_american (engine tier) launches K50 once, greeks_american K51
    once, price_vanilla_is K49 once; the Greeks price is the pricer's bit
    for bit."""
    cfg = EngineConfig(num_blocks=16, rows=16)
    opt = AmericanOption(100., 100., 0.05, 0.2, 1., n_steps=12)
    before = dict(klsm.LAUNCHES)
    p = lsm.price_american(opt, 1 << 16, SEED, antithetic=False, config=cfg)
    g = greeks_american(opt, 1 << 16, SEED, cfg)
    assert klsm.LAUNCHES["lsm"] == before["lsm"] + 1
    assert klsm.LAUNCHES["lsm_greeks"] == before["lsm_greeks"] + 1
    assert float(g.price.sum_p) == float(p.sum_p)
    assert float(g.price.sum_p2) == float(p.sum_p2)
    before = kvr.LAUNCHES["vanilla_is"]
    res = variance.price_vanilla_is(VanillaOption(100., 200., 0.05, 0.2, 1.),
                                    1 << 18, SEED, cfg)
    assert kvr.LAUNCHES["vanilla_is"] == before + 1
    assert np.isfinite(float(res.price)) and float(res.std_error) > 0


def test_american_bad_operands_raise(dev):
    _, ops = _lsm_ops(dev, 5, "put")
    plan = klsm.make_plan(1, 2, 8, False)
    with pytest.raises(ValueError):
        klsm.partials(dataclasses.replace(ops, beta=ops.beta[:4]), 1, 0,
                      plan, 2, True)
    with pytest.raises(ValueError):
        klsm.greek_partials(dataclasses.replace(ops, scal=ops.scal.double()),
                            1, 0, plan, 2, True)
    with pytest.raises(ValueError):
        klsm.partials(ops, 1, 0, plan, 0, True)
    with pytest.raises(ValueError):
        kvr.is_partials(kvr.is_params(VanillaOption(100., 100., 0.05, 0.2,
                                                    1.), 0.5, dev)[:4],
                        1, 0, plan, 2)


# The MLMC level kernels (K29, K11, K14) at levels 1, 2 and 4 of their CLI
# n0, by the scaled pair bound: d is a payoff difference whose block sum can
# cancel.
@pytest.mark.parametrize("level", [1, 2, 4])
@pytest.mark.parametrize("antithetic", [False, True])
def test_mlmc_level_kernels_match_plain(dev, level, antithetic):
    plan = kheston.make_plan(2 * NB * 32 * 128 * (2 if antithetic else 1),
                             NB, 32, antithetic, not antithetic)
    for name in ("opt", "large_xi"):
        nf = 8 * 2 ** level
        lp = kheston.level_params(_HESTON[name], nf, dev)
        _contract(
            lambda off, nb, lp=lp: kheston.level_partials(lp, SEED, off, plan,
                                                          nb, nf),
            lambda off, nb, lp=lp: kheston.level_plain_partials(
                lp, SEED, off, plan, nb, nf), units=_units(plan))
    for geo in (False, True):
        nf = 4 * 2 ** level
        ap = kasian.level_params(AsianOption(100., 100., 0.05, 0.2, 1.,
                                             n_obs=4), nf, dev)
        _contract(
            lambda off, nb: kasian.level_partials(ap, SEED, off, plan, nb, nf,
                                                  geo),
            lambda off, nb: kasian.level_plain_partials(ap, SEED, off, plan,
                                                        nb, nf, geo),
            units=_units(plan))
    for kind, h in (("up-and-out", 115.), ("down-and-out", 90.)):
        nf = 8 * 2 ** level
        bp = kbarrier.level_params(BarrierOption(100., 100., 0.05, 0.2, 1.,
                                                 barrier=h, n_obs=8,
                                                 kind=kind), nf, dev)
        up = kind == "up-and-out"
        _contract(
            lambda off, nb: kbarrier.level_partials(bp, SEED, off, plan, nb,
                                                    nf, up),
            lambda off, nb: kbarrier.level_plain_partials(bp, SEED, off, plan,
                                                          nb, nf, up),
            units=_units(plan))


@pytest.mark.parametrize("antithetic", [False, True])
def test_heston_level_split_mlmc_plan_and_grouped_scratch(dev, antithetic):
    """K29 (split per path element, folded in the unsplit order) on the
    MLMC 8 x 8 plan's shape (8 blocks, 16 iterations, rows 8) against the
    plain version; under a forced small scratch cap bit for bit the
    one-group launch, each capped call counting one launch."""
    lp = kheston.level_params(_HESTON["opt"], 32, dev)
    plan = kheston.make_plan(8 * 16 * 8 * 128 * (2 if antithetic else 1), 8,
                             8, antithetic)
    assert (plan.num_blocks, plan.iters) == (8, 16)
    _contract(
        lambda off, nb: kheston.level_partials(lp, SEED, off, plan, nb, 32),
        lambda off, nb: kheston.level_plain_partials(lp, SEED, off, plan, nb,
                                                     32),
        n_blocks=8, units=_units(plan))
    lib = _build.library()
    whole = lib.mctpu_heston_level_scratch_floats(8, 8, 16, 0)
    assert lib.mctpu_heston_level_scratch_floats(8, 8, 16, 1) < whole
    want = kheston.level_partials(lp, SEED, 0, plan, 8, 32)
    for cap in (1, whole // 2):
        before = kheston.LAUNCHES["heston_level"]
        got = kheston.level_partials(lp, SEED, 0, plan, 8, 32,
                                     scratch_cap=cap)
        assert torch.equal(got, want), cap
        assert kheston.LAUNCHES["heston_level"] == before + 1


@pytest.mark.parametrize("antithetic", [False, True])
def test_asian_level_split_mlmc_plan_and_grouped_scratch(dev, antithetic):
    """K11 (split per path element, folded in the unsplit order) at level 4
    of n0 = 4 (64 dates), arithmetic and geometric, on the MLMC 8 x 8
    plan's shape (8 blocks, 16 iterations, rows 8) against the plain
    version; under a forced small scratch cap bit for bit the one-group
    launch, each capped call counting one launch."""
    plan = kasian.make_plan(8 * 16 * 8 * 128 * (2 if antithetic else 1), 8,
                            8, antithetic)
    assert (plan.num_blocks, plan.iters) == (8, 16)
    lib = _build.library()
    whole = lib.mctpu_asian_level_scratch_floats(8, 8, 16, 0)
    assert lib.mctpu_asian_level_scratch_floats(8, 8, 16, 1) < whole
    for geo in (False, True):
        lp = kasian.level_params(_asian(4, geo), 64, dev)
        _contract(
            lambda off, nb: kasian.level_partials(lp, SEED, off, plan, nb,
                                                  64, geo),
            lambda off, nb: kasian.level_plain_partials(lp, SEED, off, plan,
                                                        nb, 64, geo),
            n_blocks=8, units=_units(plan))
        want = kasian.level_partials(lp, SEED, 0, plan, 8, 64, geo)
        for cap in (1, whole // 2):
            before = kasian.LAUNCHES["asian_level"]
            got = kasian.level_partials(lp, SEED, 0, plan, 8, 64, geo,
                                        scratch_cap=cap)
            assert torch.equal(got, want), cap
            assert kasian.LAUNCHES["asian_level"] == before + 1


# K10 (arithmetic and geometric, 13 dates), K11 (arithmetic and geometric,
# level 2 of n0 = 4: 16 dates), K27 (Euler and QE, 8 steps: level 0 of
# mctpu's MLMC default), K19 (GBM and Heston, 13 dates) and K15 (every
# lookback mode, 13 dates; the fixed strikes off the atom at s0), split per
# path element and folded in the unsplit order.
_SPLIT_WALKS = ("K10 arithmetic", "K10 geometric", "K11 arithmetic",
                "K11 geometric", "K27 Euler", "K27 QE", "K19 GBM",
                "K19 Heston", "K15 floating call", "K15 floating put",
                "K15 fixed call", "K15 fixed put")
# name: (blocks, iters, rows, kahan): the MLMC 8 x 8 plan's shape, and 2
# iterations on 1 and 3 rows (the fold's 512- or 1024-thread stride partly
# empty).
_SPLIT_SHAPES = {"mlmc8x8_iters16": (8, 16, 8, True),
                 "rows1_iters2_f32": (NB, 2, 1, False),
                 "rows3_iters2": (NB, 2, 3, True)}


def _split_walk(dev, name):
    """``(fn(off, nb, plan, cap=0), plain(off, nb, plan), launch key,
    scratch-floats entry, greek)`` of a split walk."""
    if name.startswith("K15"):
        _, kind, payoff = name.split()
        opt = LookbackOption(100., 0.05, 0.2, 1., n_obs=13, kind=kind,
                             payoff=payoff,
                             k={"call": 105., "put": 95.}[payoff]
                             if kind == "fixed" else 0.)
        mode, par = klookback.mode_of(opt), klookback.params(opt, dev)
        return (lambda off, nb, plan, cap=0: klookback.partials(
                    par, SEED, off, plan, nb, 13, mode, scratch_cap=cap),
                lambda off, nb, plan: klookback.plain_partials(
                    par, SEED, off, plan, nb, 13, mode),
                "lookback", "mctpu_lookback_scratch_floats", False)
    if name.startswith("K10"):
        geo = name.endswith("geometric")
        gp = kasian.greek_params(_asian(13, geo), dev)
        return (lambda off, nb, plan, cap=0: kasian.greek_partials(
                    gp, SEED, off, plan, nb, 13, geo, scratch_cap=cap),
                lambda off, nb, plan: kasian.greek_plain_partials(
                    gp, SEED, off, plan, nb, 13, geo),
                "asian_greeks", "mctpu_asian_greeks_scratch_floats", True)
    if name.startswith("K11"):
        geo = name.endswith("geometric")
        lp = kasian.level_params(_asian(4, geo), 16, dev)
        return (lambda off, nb, plan, cap=0: kasian.level_partials(
                    lp, SEED, off, plan, nb, 16, geo, scratch_cap=cap),
                lambda off, nb, plan: kasian.level_plain_partials(
                    lp, SEED, off, plan, nb, 16, geo),
                "asian_level", "mctpu_asian_level_scratch_floats", True)
    if name.startswith("K19"):
        heston = name.endswith("Heston")
        par = (kvarswap.heston_params(_HESTON["steep"], 13, dev) if heston
               else kvarswap.params(VanillaOption(100., 100., 0.05, 0.2, 1.),
                                    13, dev))
        return (lambda off, nb, plan, cap=0: kvarswap.partials(
                    par, SEED, off, plan, nb, 13, scratch_cap=cap),
                lambda off, nb, plan: kvarswap.plain_partials(
                    par, SEED, off, plan, nb, 13),
                "varswap_heston" if heston else "varswap",
                "mctpu_varswap_scratch_floats", False)
    qe = name.endswith("QE")
    par = kheston.params(_HESTON["opt"], 8, qe, dev)
    return (lambda off, nb, plan, cap=0: kheston.partials(
                par, SEED, off, plan, nb, 8, qe, scratch_cap=cap),
            lambda off, nb, plan: kheston.plain_partials(par, SEED, off, plan,
                                                         nb, 8, qe),
            "heston_qe" if qe else "heston", "mctpu_heston_scratch_floats",
            False)


def _split_counts(name):
    if name.startswith("K15"):
        return klookback.LAUNCHES
    if name.startswith("K19"):
        return kvarswap.LAUNCHES
    return kasian.LAUNCHES if name.startswith("K1") else kheston.LAUNCHES


@pytest.mark.parametrize("shape", sorted(_SPLIT_SHAPES))
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("name", _SPLIT_WALKS)
def test_asian_greeks_and_heston_split_match_plain(dev, name, antithetic,
                                                   shape):
    """K10, K11, K15, K19 and K27 (split per path element, folded in the
    unsplit order) against their plain versions (K10's and K11's pairs by the
    scaled bound), on the MLMC 8 x 8 plan's shape and on short rows; two
    launches and the block offset bitwise; each call counts one launch."""
    blocks, iters, rows, kahan = _SPLIT_SHAPES[shape]
    fn, plain, key, _, greek = _split_walk(dev, name)
    plan = kheston.make_plan(
        blocks * iters * rows * 128 * (2 if antithetic else 1), blocks, rows,
        antithetic, kahan)
    assert (plan.num_blocks, plan.iters, plan.rows) == (blocks, iters, rows)
    _contract(lambda off, nb: fn(off, nb, plan),
              lambda off, nb: plain(off, nb, plan), n_blocks=blocks,
              units=_units(plan) if greek else None)
    counts = _split_counts(name)
    before = dict(counts)
    fn(0, blocks, plan)
    assert counts[key] == before[key] + 1
    assert sum(counts.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("name", _SPLIT_WALKS)
def test_asian_greeks_and_heston_split_grouped_scratch(dev, name,
                                                       antithetic):
    """K10, K11, K15, K19 and K27 under a forced small scratch cap: at 1
    float every (block, iteration) is split and folded on its own (the fold's
    carry between the groups: K10's BlockAccN pairs, the others' Acc2s), at
    half the one-group scratch the blocks go in groups; both equal the
    one-group launch bit for bit, and each capped call counts one launch."""
    fn, _, key, entry, _ = _split_walk(dev, name)
    plan = kheston.make_plan(NB * 3 * 7 * 128 * (2 if antithetic else 1), NB,
                             7, antithetic)
    assert plan.iters == 3
    floats = getattr(_build.library(), entry)
    whole = floats(NB, plan.rows, plan.iters, 0)
    assert floats(NB, plan.rows, plan.iters, 1) < whole
    want = fn(0, NB, plan)
    counts = _split_counts(name)
    for cap in (1, whole // 2):
        before = counts[key]
        got = fn(0, NB, plan, cap)
        assert counts[key] == before + 1
        assert torch.equal(got, want), cap


# K20's Heston leg and K34 are split walks whose folds add several outputs
# an element once an iteration (K34's in add_greek_sums' row order).
@pytest.mark.parametrize("shape", sorted(_SPLIT_SHAPES))
@pytest.mark.parametrize("antithetic", [False, True])
def test_varswap_heston_greeks_split_match_plain(dev, shape, antithetic):
    """K20's Heston leg at 13 dates on the MLMC 8 x 8 plan's shape and on
    short rows against its plain version by the scaled pair bound; two
    launches and the block offset bitwise; a call counts one launch."""
    blocks, iters, rows, kahan = _SPLIT_SHAPES[shape]
    plan = kvarswap.make_plan(
        blocks * iters * rows * 128 * (2 if antithetic else 1), blocks, rows,
        antithetic, kahan)
    assert (plan.num_blocks, plan.iters, plan.rows) == (blocks, iters, rows)
    gp = kvarswap.heston_greek_params(_HESTON["steep"], 13, dev)
    _contract(lambda off, nb: kvarswap.greek_partials(gp, SEED, off, plan, nb,
                                                      13),
              lambda off, nb: kvarswap.greek_plain_partials(gp, SEED, off,
                                                            plan, nb, 13),
              n_blocks=blocks, units=_units(plan))
    before = dict(kvarswap.LAUNCHES)
    kvarswap.greek_partials(gp, SEED, 0, plan, blocks, 13)
    assert (kvarswap.LAUNCHES["varswap_heston_greeks"]
            == before["varswap_heston_greeks"] + 1)
    assert sum(kvarswap.LAUNCHES.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("n_obs", [1, 13, 252])
@pytest.mark.parametrize("antithetic", [False, True])
def test_varswap_heston_greeks_grouped_scratch(dev, n_obs, antithetic):
    """K20's Heston leg under a forced small scratch cap: at 1 float every
    (block, iteration) is split and folded on its own (the fold's BlockAccN
    slots carried between the groups), at half the one-group scratch the
    blocks go in groups; both equal the one-group launch bit for bit, and
    each capped call counts one launch."""
    plan = kvarswap.make_plan(NB * 3 * 7 * 128 * (2 if antithetic else 1),
                              NB, 7, antithetic, not antithetic)
    assert plan.iters == 3
    gp = kvarswap.heston_greek_params(_HESTON["steep"], n_obs, dev)
    floats = _build.library().mctpu_varswap_greeks_scratch_floats
    whole = floats(NB, plan.rows, plan.iters, 0)
    assert floats(NB, plan.rows, plan.iters, 1) < whole
    want = kvarswap.greek_partials(gp, SEED, 0, plan, NB, n_obs)
    for cap in (1, whole // 2):
        before = kvarswap.LAUNCHES["varswap_heston_greeks"]
        got = kvarswap.greek_partials(gp, SEED, 0, plan, NB, n_obs,
                                      scratch_cap=cap)
        assert kvarswap.LAUNCHES["varswap_heston_greeks"] == before + 1
        assert torch.equal(got, want), cap


def _k34_setup(dev, a, n_obs, antithetic, kahan, up, iters, rows=7):
    bk = BasketOption.equicorrelated(a, 0.3)
    chol = cholesky_lower(bk.corr)
    plan = kmw.make_plan(NB * iters * rows * 128 * (2 if antithetic else 1),
                         NB, rows, antithetic, kahan, n_assets=a)
    assert plan.iters == iters
    ops = tuple(x.to(dev) for x in kmw.am_bar_greek_ops(
        bk, chol, n_obs, 104.0 if up else 96.0))
    return ops, plan


@pytest.mark.parametrize("a", [1, 3, 8])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("up", [True, False])
def test_bar_greeks_am_split_matches_plain(dev, a, antithetic, up):
    """K34 at 13 dates, 2 iterations on 7 rows (the fold's stride partly
    empty), plain and antithetic, both directions, against its plain
    version by the scaled pair bound; two launches and the block offset
    bitwise; a call counts one launch."""
    ops, plan = _k34_setup(dev, a, 13, antithetic, not antithetic, up, 2)
    _contract(
        lambda off, nb: _mw_greek_pairs(kmw.am_bar_greek_partials(
            *ops, SEED, off, plan, nb, 13, up)),
        lambda off, nb: _mw_greek_pairs(kmw.am_bar_greek_plain_partials(
            *ops, SEED, off, plan, nb, 13, up)),
        units=plan.iters * plan.units_per_iter)
    before = dict(kmw.LAUNCHES)
    kmw.am_bar_greek_partials(*ops, SEED, 0, plan, NB, 13, up)
    assert (kmw.LAUNCHES["basket_barrier_greeks_am"]
            == before["basket_barrier_greeks_am"] + 1)
    assert sum(kmw.LAUNCHES.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("a", [3, 8])
@pytest.mark.parametrize("antithetic", [False, True])
def test_bar_greeks_am_grouped_scratch(dev, a, antithetic):
    """K34 under a forced small scratch cap (1 float: every (block,
    iteration) its own group, the fold's slots carried between them; half
    the one-group scratch: blocks in groups) equals the one-group launch
    bit for bit, up- and down-and-out."""
    for up in (True, False):
        ops, plan = _k34_setup(dev, a, 13, antithetic, True, up, 3)
        floats = _build.library().mctpu_multi_walk_bar_greeks_am_scratch_floats
        whole = floats(a, NB, plan.rows, plan.iters, 0)
        assert floats(a, NB, plan.rows, plan.iters, 1) < whole
        want = kmw.am_bar_greek_partials(*ops, SEED, 0, plan, NB, 13, up)
        for cap in (1, whole // 2):
            got = kmw.am_bar_greek_partials(*ops, SEED, 0, plan, NB, 13, up,
                                            scratch_cap=cap)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), cap


def test_price_heston_mlmc_against_cf_and_launches(dev):
    """The JAX exotic CLI's --product mlmc on the card (512 x 256, eps =
    0.02): within 3 eps of the characteristic-function price; level 0 runs
    K27 and every correction level K29."""
    from mctpu_torch.models.heston import cf_call_price
    opt = _HESTON["opt"]
    before = dict(kheston.LAUNCHES)
    res = mlmc.price_heston_mlmc(opt, 0.02, SEED, EngineConfig())
    assert abs(res.price - cf_call_price(opt)) < 3 * 0.02
    assert len(res.levels) >= 3
    assert kheston.LAUNCHES["heston"] > before["heston"]
    assert kheston.LAUNCHES["heston_level"] > before["heston_level"]
    assert res == mlmc.price_heston_mlmc(opt, 0.02, SEED, EngineConfig())


def test_mlmc_bad_operands_raise(dev):
    plan = kheston.make_plan(1, 2, 8, False)
    lp = kheston.level_params(_HESTON["opt"], 16, dev)
    with pytest.raises(ValueError):
        kheston.level_partials(lp[:12], 1, 0, plan, 2, 16)
    with pytest.raises(ValueError):
        kheston.level_partials(lp, 1, 0, plan, 2, 15)
    with pytest.raises(ValueError):
        kasian.level_partials(lp[:4].double(), 1, 0, plan, 2, 16, False)
    with pytest.raises(ValueError):
        kbarrier.level_partials(lp[:5], 1, 0, plan, 0, 16, True)


# ---------------------------------------------------------------- K52-K55

_RQMC_KEY = qmc_engine.rqmc_key(SEED)


def _rqmc_contract(fn, plain, units=None, n_blocks=NB):
    """Folded quads equal at RTOL (K53's by the scaled pair bound); two
    launches and the block-offset contract bitwise on the raw quads."""
    got, again, tail = fn(0, n_blocks), fn(0, n_blocks), fn(2, n_blocks - 2)
    want = plain(0, n_blocks)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert torch.equal(got[2:], tail)
    assert_quads_close(got, want, RTOL, units)


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("rows", [8, 24])
def test_rqmc_vanilla_and_greek_kernels_match_plain(dev, kind, rows):
    opt = VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
    plan = qmc_engine.rqmc_plan(3 * rows * 128, NB, rows)
    put = kind == "put"
    vops = krqmc.vanilla_operands(opt, dev)
    _rqmc_contract(
        lambda off, n: krqmc.vanilla_partials(vops, _RQMC_KEY, off, plan, n,
                                              put),
        lambda off, n: krqmc.vanilla_plain_partials(vops, _RQMC_KEY, off,
                                                    plan, n, put))
    gops = krqmc.greek_operands(opt, dev)
    _rqmc_contract(
        lambda off, n: krqmc.greek_partials(gops, _RQMC_KEY, off, plan, n,
                                            put),
        lambda off, n: krqmc.greek_plain_partials(gops, _RQMC_KEY, off, plan,
                                                  n, put),
        units=plan.paths_per_block)


# K54's tiled design at 65-128 assets on rows 1, 3 and 37 (chunks of 1, 3
# and 37 points: chunk bases off the 32-point groups, a round of fewer than
# four groups) and on rows 163 (a full round and a short one), and past
# 128 at 129 and 300 assets.
@pytest.mark.parametrize("n_assets,rows", [
    (1, 8), (3, 8), (12, 8), (40, 8), (100, 8), (300, 12), (65, 1), (65, 3),
    (65, 37), (100, 1), (100, 3), (100, 37), (100, 163), (128, 1), (128, 3),
    (128, 37), (129, 37), (300, 37)])
def test_rqmc_basket_kernel_matches_plain(dev, n_assets, rows):
    opt = BasketOption.equicorrelated(n_assets, 0.3)
    c = kbasket.pack_factor(n_assets)[1]
    plan = qmc_engine.rqmc_plan(3 * rows * c, NB, rows, pts_per_chunk=rows * c)
    ops = krqmc.basket_operands(opt, cholesky_lower(opt.corr), dev)
    _rqmc_contract(
        lambda off, n: krqmc.basket_partials(ops, _RQMC_KEY, off, plan, n),
        lambda off, n: krqmc.basket_plain_partials(ops, _RQMC_KEY, off, plan,
                                                   n))


@pytest.mark.parametrize("n_obs,rows", [(1, 8), (7, 24), (12, 8), (12, 24),
                                        (50, 163), (252, 32), (300, 8)])
@pytest.mark.parametrize("average", ["arithmetic", "geometric"])
def test_rqmc_asian_kernel_matches_plain(dev, n_obs, rows, average):
    opt = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=n_obs,
                      average=average)
    plan = qmc_engine.rqmc_plan(3 * rows * 128, NB, rows)
    ops = krqmc.asian_operands(opt, dev)
    geo = average == "geometric"
    _rqmc_contract(
        lambda off, n: krqmc.asian_partials(ops, _RQMC_KEY, off, plan, n,
                                            geo),
        lambda off, n: krqmc.asian_plain_partials(ops, _RQMC_KEY, off, plan,
                                                  n, geo))


# K55 split over the chunks' batches and folded in the one-block-a-chunk
# order: at 1 float of scratch every (replicate, chunk) goes alone, at half
# the one-group scratch the replicates go in groups; both equal the one-group
# launch bit for bit (so do the tile rows' order and the carry).
@pytest.mark.parametrize("n_obs,rows", [(1, 8), (12, 24), (50, 163),
                                        (252, 32), (300, 8)])
@pytest.mark.parametrize("average", ["arithmetic", "geometric"])
def test_rqmc_asian_grouped_scratch_matches_one_group(dev, n_obs, rows,
                                                      average):
    opt = AsianOption(100.0, 100.0, 0.05, 0.2, 1.0, n_obs=n_obs,
                      average=average)
    plan = qmc_engine.rqmc_plan(3 * rows * 128, NB, rows)
    assert plan.iters == 3
    ops = krqmc.asian_operands(opt, dev)
    geo = average == "geometric"
    floats = _build.library().mctpu_rqmc_asian_scratch_floats
    whole = floats(NB, plan.paths_per_iter, plan.iters, 0)
    assert whole == NB * 3 * rows * 128
    assert floats(NB, plan.paths_per_iter, plan.iters, 1) == rows * 128
    want = krqmc.asian_partials(ops, _RQMC_KEY, 0, plan, NB, geo)
    for cap in (1, whole // 2):
        before = krqmc.LAUNCHES["rqmc_asian"]
        got = krqmc.asian_partials(ops, _RQMC_KEY, 0, plan, NB, geo,
                                   scratch_cap=cap)
        assert krqmc.LAUNCHES["rqmc_asian"] == before + 1
        assert torch.equal(got, want), cap


def test_price_vanilla_rqmc_against_bs_and_launches(dev):
    """The JAX exotic CLI's --product rqmc call on the card: 16 replicates
    of 131072 points on 512 x 256, within 4 standard errors (the floored
    1e-5 of the price) of Black-Scholes, through K52."""
    opt = VanillaOption(100.0, 100.0, 0.05, 0.2, 1.0)
    before = krqmc.LAUNCHES["rqmc_vanilla"]
    res = qmc_engine.price_vanilla_rqmc(opt, 131072, SEED)
    assert krqmc.LAUNCHES["rqmc_vanilla"] == before + 1
    bs = float(bs_call(100.0, 100.0, 0.05, 0.2, 1.0))
    assert abs(float(res.price) - bs) < 4 * float(res.std_error)
    assert (res.n, res.n_paths) == (16, 16 * 131072)
    again = qmc_engine.price_vanilla_rqmc(opt, 131072, SEED)
    assert float(again.price) == float(res.price)


def test_rqmc_bad_operands_raise(dev):
    plan = qmc_engine.rqmc_plan(1024, 2, 8)
    ops = krqmc.vanilla_operands(VanillaOption(100.0, 100.0, 0.05, 0.2,
                                               1.0), dev)
    bad = dataclasses.replace(ops, par=ops.par[:3].contiguous())
    with pytest.raises(ValueError, match="par"):
        krqmc.vanilla_partials(bad, _RQMC_KEY, 0, plan, 2, False)
    bad = dataclasses.replace(ops, v=ops.v.cpu())
    with pytest.raises(ValueError, match="v must be"):
        krqmc.vanilla_partials(bad, _RQMC_KEY, 0, plan, 2, False)
    with pytest.raises(RuntimeError, match="launch failed"):
        krqmc.vanilla_partials(ops, _RQMC_KEY, 0, plan, 70000, False)
