"""pad_conv3x3's plain version, which is the wrapper's CPU route, against the
TPU scripts' own Pallas kernels run in Pallas interpret mode on the CPU:
``scripts/bisect_im2col.py`` (variants tap9, im2col, row3, ztrick) and
``scripts/bisect_kernel_cost.py`` (modes full, mxu_only, shift_only,
dma_only). The scripts read their module-level H, W, C when they trace, so
the tests set them small with monkeypatch and wrap ``pl.pallas_call`` with
``interpret=True``; nothing under ``scripts/`` changes.

Sizes: H, W, C = 20, 16, 8 and a ragged H = 21 (2·8 + 5), row tile R = 8.
Tolerances: float32 1e-4 absolute (sums of 72 terms, |y| ~ 2, in another
order); bfloat16 one bf16 ulp (rtol 2⁻⁷): both sides sum in float32 and
round once. ztrick rounds each tap's product to the input dtype, a TPU
layout trick, so it is held in float32 only.

The probes' library yardsticks (``bisect_kernel_cost.library_mode``, one
PyTorch call after a reflect pad per mode) against the plain version, in
float32: ``dma_only`` exactly; the others within 1e-4 absolute (the same
sums of up to 72 terms, |y| ~ 2, in another order; ``mxu_only`` sums w
over the taps first).
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from vst_torch.kernels.pad_conv3x3 import MODES, pad_conv3x3, pad_conv3x3_plain
from vst_torch.probes.bisect_kernel_cost import library_arg, library_mode

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(20, 16, 8), (21, 16, 8)]


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


IM2COL = _script("bisect_im2col")
KERNEL_COST = _script("bisect_kernel_cost")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    return monkeypatch


def _inputs(H, W, C, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, H, W, C).astype(np.float32),
            (rng.randn(3, 3, C, C) * 0.2).astype(np.float32))


def _pallas(module, variant, dtype, x, w, monkeypatch):
    _, H, W, C = x.shape
    for name, value in (("H", H), ("W", W), ("C", C)):
        monkeypatch.setattr(module, name, value)
    jdtype = DTYPES[dtype][0]
    y = module.make(variant, jdtype, R=8)(jnp.asarray(x).astype(jdtype), jnp.asarray(w))
    return np.asarray(y.astype(jnp.float32))


def _port(mode, dtype, x, w):
    tdtype = DTYPES[dtype][1]
    y = pad_conv3x3_plain(torch.from_numpy(x).to(tdtype), torch.from_numpy(w).to(tdtype), mode)
    assert y.dtype == tdtype
    return y.float().numpy()


def _assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=0, rtol=2.0 ** -7)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"H{s[0]}")
@pytest.mark.parametrize("variant,dtype", [("tap9", "float32"), ("tap9", "bfloat16"),
                                           ("im2col", "float32"), ("im2col", "bfloat16"),
                                           ("row3", "float32"), ("ztrick", "float32")])
def test_plain_matches_bisect_im2col(interpret, shape, variant, dtype):
    x, w = _inputs(*shape)
    want = _pallas(IM2COL, variant, dtype, x, w, interpret)
    _assert_close(_port("full", dtype, x, w), want, dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"H{s[0]}")
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_bisect_kernel_cost(interpret, shape, mode, dtype):
    x, w = _inputs(*shape, seed=1)
    want = _pallas(KERNEL_COST, mode, dtype, x, w, interpret)
    _assert_close(_port(mode, dtype, x, w), want, dtype)


@pytest.mark.parametrize("mode", MODES)
def test_wrapper_on_cpu_is_the_plain_version(mode):
    x, w = (torch.from_numpy(a) for a in _inputs(5, 7, 16, seed=2))
    before = sum(pad_conv3x3.launches.values())
    torch.testing.assert_close(pad_conv3x3(x, w, mode), pad_conv3x3_plain(x, w, mode),
                               atol=0, rtol=0)
    assert sum(pad_conv3x3.launches.values()) == before  # no kernel on the CPU


def test_wrapper_checks_its_inputs():
    x, w = (torch.from_numpy(a) for a in _inputs(5, 7, 16))
    with pytest.raises(ValueError):
        pad_conv3x3(x, w, "tap9")
    with pytest.raises(TypeError):
        pad_conv3x3(x, w.double())
    with pytest.raises(ValueError):
        pad_conv3x3(x[:, :, :, :12].contiguous(), w[:, :, :12].contiguous())
    with pytest.raises(ValueError):
        pad_conv3x3(x[:, :1].contiguous(), w)
    with pytest.raises(ValueError):
        pad_conv3x3(x.transpose(1, 2), w)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"H{s[0]}")
@pytest.mark.parametrize("mode", MODES)
def test_library_yardstick_matches_plain(shape, mode):
    x, w = (torch.from_numpy(a) for a in _inputs(*shape, seed=3))
    got = library_mode(x, library_arg(w, mode), mode)
    want = pad_conv3x3_plain(x, w, mode)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=0 if mode == "dma_only" else 1e-4, rtol=0)
