"""The port's main path as a whole against mctpu.engine (CPU).

``mctpu_torch.price_*`` on ``device="cpu"`` (the kernels' plain versions)
against ``mctpu.engine.price_*`` on interpret-mode Pallas, with the same
launch configuration, the same key (the port takes its int32 seed word) and
records carried across by ``from_reference``.  Path counts must be equal;
prices, standard errors and the exposure profile agree at ``rtol=2e-5``
(same draws; other summation orders and libm within an ulp).
"""
import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import mctpu_torch
from mctpu import engine as jengine
from mctpu import rng as jrng
from mctpu import types as jtypes
from mctpu_torch import engine as tengine
from mctpu_torch.types import Precision, from_reference

RTOL = 2e-5
KEY = jax.random.key(31)
SEED = int(jrng.key_to_seed(KEY))
JCFG = jengine.EngineConfig(backend="pallas", interpret=True, num_blocks=4,
                            rows=8)
TCFG = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu")
OPT = jtypes.VanillaOption(s=100.0, k=100.0, r=0.048790, v=0.2, t=1.0)


def _same_estimate(got, want, price="price"):
    assert (got.n, got.n_paths) == (want.n, want.n_paths)
    for field in (price, "std_error", "ci"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=RTOL)


@pytest.mark.parametrize("kind", ["call", "put"])
def test_price_vanilla_matches_mctpu(kind):
    opt = jtypes.VanillaOption(100.0, 100.0, 0.048790, 0.2, 1.0, kind=kind)
    want = jengine.price_vanilla(opt, 1 << 15, KEY, JCFG)
    got = mctpu_torch.price_vanilla(from_reference(opt), 1 << 15, SEED, TCFG)
    _same_estimate(got, want)
    np.testing.assert_allclose(float(got.sum_p), float(want.sum_p), rtol=RTOL)


@pytest.mark.parametrize("opt", [jtypes.BasketOption.default_reference(3),
                                 jtypes.BasketOption.default_reference(10)],
                         ids=["a3_asset_major", "a10_packed"])
def test_price_basket_matches_mctpu(opt):
    want = jengine.price_basket(opt, 1 << 14, KEY, JCFG)
    got = mctpu_torch.price_basket(from_reference(opt), 1 << 14, SEED, TCFG)
    _same_estimate(got, want)


def test_price_cva_matches_mctpu():
    spec = jtypes.CvaSpec(intensity=0.03, lgd=0.6,
                          option=jtypes.VanillaOption(100.0, 100.0, 0.05,
                                                      0.2, 1.0),
                          n_grid=10)
    want = jengine.price_cva(spec, 1 << 13, KEY, JCFG)
    got = mctpu_torch.price_cva(from_reference(spec), 1 << 13, SEED, TCFG)
    _same_estimate(got, want, price="cva")
    np.testing.assert_allclose(got.expected_exposure.numpy(),
                               np.asarray(want.expected_exposure), rtol=RTOL)
    np.testing.assert_allclose(got.default_leg.numpy(),
                               np.asarray(want.default_leg), rtol=1e-12)


@pytest.mark.parametrize("n_paths", [1, 1000, 1 << 14, 1 << 20, 1 << 28])
@pytest.mark.parametrize("per_row", [128, 256, 512, 2, 32])
@pytest.mark.parametrize("blocks,rows", [(512, 256), (4, 8), (48, 64)])
def test_layout_for_matches_mctpu(n_paths, per_row, blocks, rows):
    j = jengine.EngineConfig(num_blocks=blocks, rows=rows)
    t = tengine.EngineConfig(num_blocks=blocks, rows=rows, device="cpu")
    assert t.layout_for(n_paths, per_row) == j.layout_for(n_paths, per_row)


def test_from_reference_carries_records():
    spec = jtypes.CvaSpec(0.03, 0.6, OPT, n_grid=25)
    port = from_reference(jtypes.CvaPortfolioSpec.from_single(spec, 0.5))
    assert port.n_grid == 25 and port.wwr_b == 0.5 and port.n_options == 1
    assert from_reference(spec).option == from_reference(OPT)
    b = from_reference(jtypes.BasketOption.default_reference(3))
    np.testing.assert_array_equal(
        b.corr, jtypes.BasketOption.default_reference(3).corr)
    assert from_reference(jtypes.Precision.F32_DS) is Precision.F32_DS


@pytest.mark.parametrize("opt", [
    jtypes.AsianOption(100.0, 95.0, 0.05, 0.2, 1.0, n_obs=50,
                       average="geometric"),
    jtypes.BarrierOption(100.0, 95.0, 0.05, 0.2, 1.0, barrier=80.0,
                         n_obs=13, kind="down-and-out"),
    jtypes.LookbackOption(100.0, 0.05, 0.2, 1.0, k=95.0, n_obs=13,
                          kind="fixed", payoff="put"),
    jtypes.CliquetOption(100.0, 0.03, 0.2, 1.0, n_periods=13, cap=0.05,
                         floor=-0.02)],
    ids=["asian", "barrier", "lookback", "cliquet"])
def test_from_reference_keeps_int_fields(opt):
    got = from_reference(opt)
    assert type(got).__name__ == type(opt).__name__
    steps = "n_periods" if hasattr(opt, "n_periods") else "n_obs"
    assert type(getattr(got, steps)) is int
    for f in dataclasses.fields(opt):
        assert getattr(got, f.name) == getattr(opt, f.name), f.name
    assert isinstance(got.s, float)


def test_import_does_not_load_jax():
    code = ("import sys, mctpu_torch, mctpu_torch.lsm, "
            "mctpu_torch.variance; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'mctpu' not in sys.modules, 'mctpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_f64_raises():
    cfg = tengine.EngineConfig(num_blocks=4, rows=8, device="cpu",
                               precision=Precision.F64)
    with pytest.raises(NotImplementedError):
        mctpu_torch.price_vanilla(from_reference(OPT), 1 << 12, SEED, cfg)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mctpu_torch.price_vanilla(from_reference(OPT), 1 << 12, SEED)


def test_invalid_inputs_raise():
    with pytest.raises(ValueError):
        mctpu_torch.price_vanilla(
            mctpu_torch.VanillaOption(100.0, 100.0, 0.05, 0.2, -1.0), 1 << 12,
            SEED, TCFG)
    with pytest.raises(ValueError):
        tengine.EngineConfig(device="meta").torch_device()
