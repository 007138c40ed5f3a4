"""gemm_rate's plain version, which is the wrapper's CPU route, against the
TPU script's own Pallas kernel (``scripts/bisect_mxu.py:make``) run in
Pallas interpret mode on the CPU. The script reads its module-level M and
REPS when it traces, so the tests set M, REPS = 64, 4 with monkeypatch and
wrap ``pl.pallas_call`` with ``interpret=True``; nothing under
``scripts/`` changes.

w is scaled by 1/√K, so |y| ≲ 20. Tolerances: float32 1e-4 absolute (4
reps of K ≤ 256 products in another order); bfloat16 one bf16 ulp (rtol
2⁻⁷): both sides sum in float32 and round once. Also the probe's one-call
cuBLAS yardstick (one product of depth reps·K) against the plain version,
the build helper's refusal without nvcc, and its build tag, which follows
the shared headers ``csrc/*.cuh`` as well as the source.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from vst_torch.kernels import _nvcc
from vst_torch.kernels.gemm_rate import gemm_rate, gemm_rate_plain
from vst_torch.probes.bisect_mxu import library_operands

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
M, REPS = 64, 4


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MXU = _script("bisect_mxu")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(MXU, "M", M)
    monkeypatch.setattr(MXU, "REPS", REPS)


def _inputs(K, N, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, K).astype(np.float32),
            (rng.randn(K, N) / np.sqrt(K)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,N", [(128, 128), (32, 64), (256, 32)])
def test_plain_matches_bisect_mxu(interpret, K, N, dtype):
    jdtype, tdtype = DTYPES[dtype]
    x, w = _inputs(K, N)
    want = np.asarray(MXU.make(K, N, jdtype)(jnp.asarray(x).astype(jdtype),
                                             jnp.asarray(w).astype(jdtype)).astype(jnp.float32))
    got = gemm_rate_plain(torch.from_numpy(x).to(tdtype), torch.from_numpy(w).to(tdtype), REPS)
    assert got.dtype == tdtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=0, rtol=2.0 ** -7)


def test_wrapper_on_cpu_is_the_plain_version():
    x, w = (torch.from_numpy(a) for a in _inputs(32, 16, seed=1))
    before = sum(gemm_rate.launches.values())
    torch.testing.assert_close(gemm_rate(x, w, 3), gemm_rate_plain(x, w, 3), atol=0, rtol=0)
    assert sum(gemm_rate.launches.values()) == before  # no kernel on the CPU


def test_wrapper_checks_its_inputs():
    x, w = (torch.from_numpy(a) for a in _inputs(32, 16))
    with pytest.raises(ValueError):
        gemm_rate(x, w.T.contiguous())
    with pytest.raises(TypeError):
        gemm_rate(x, w.bfloat16())
    with pytest.raises(ValueError):
        gemm_rate(x[:, :12].contiguous(), w[:12].contiguous())
    with pytest.raises(ValueError):
        gemm_rate(x, w, reps=-1)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_nvcc.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _nvcc.nvcc()
    assert _nvcc.library_path("gemm_rate").parent == _nvcc.BUILD_DIR
    assert _nvcc.library_path("gemm_rate") != _nvcc.library_path("pad_conv3x3")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,N,reps", [(128, 128, 4), (24, 40, 3), (64, 16, 1)])
def test_one_call_yardstick_matches_plain(K, N, reps, dtype):
    """x repeated along K times w repeated along K is Σ_{reps} x @ w in one
    product: float32 within 1e-4 absolute (|y| ≲ 20, another order of the
    same sum); bfloat16 within one bf16 ulp (both round one float32 sum)."""
    tdtype = DTYPES[dtype][1]
    x, w = (torch.from_numpy(a).to(tdtype) for a in _inputs(K, N))
    xs, ws = library_operands(x, w, reps)
    assert xs.shape == (M, reps * K) and ws.shape == (reps * K, N)
    got = torch.matmul(xs, ws)
    want = gemm_rate_plain(x, w, reps)
    assert got.dtype == want.dtype == tdtype
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=2.0 ** -7)


def test_build_tag_follows_shared_headers(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_nvcc, "CSRC", tmp_path)
    first = _nvcc.library_path("k")
    assert _nvcc.library_path("k") == first  # same sources, same tag
    header.write_text("// v2\n")
    second = _nvcc.library_path("k")
    assert second != first  # an edited header builds anew
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _nvcc.library_path("k") not in (first, second)  # so does an edited source
