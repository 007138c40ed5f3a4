"""Wrapper of the Hopper matrix-product rate probe
(``vst_torch/csrc/gemm_rate.cu``), which replaces the TPU kernel of
``scripts/bisect_mxu.py:make``: Σ_{reps} x @ w inside one kernel, into one
float32 accumulator.

``gemm_rate(x, w, reps)`` computes ``gemm_rate_plain``: for CPU tensors by
calling it, for CUDA tensors by launching the kernel, built with ``nvcc`` at
first use (``vst_torch.kernels._nvcc``). A build or launch that fails raises.
``gemm_rate.launches`` counts kernel launches by dtype.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from vst_torch.kernels import _nvcc
from vst_torch.kernels.pad_conv3x3 import DTYPES, dtype_name

_ENTRY_POINTS = {"gemm_rate_launch": (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])}


def build() -> str:
    """Compile (once per source version) and load the kernel library.
    Returns nvcc's report from this process's build, or an empty string."""
    return _nvcc.load("gemm_rate", _ENTRY_POINTS)[1]


def gemm_rate_plain(x: torch.Tensor, w: torch.Tensor, reps: int = 64) -> torch.Tensor:
    """Σ_{reps} x @ w, the product taken anew each rep in float32 and added
    to one float32 accumulator (``bisect_mxu.py``'s ``fori_loop``), cast to
    x's dtype at the end."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for _ in range(reps):
        acc = acc + (x.float() @ w.float())
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, reps: int) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x must be (M, K) and w (K, N), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"gemm_rate takes float32 or bfloat16 x and w of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if x.device != w.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x and w on one cpu or cuda device, got {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm_rate takes contiguous x and w")
    if int(reps) != reps or reps < 0:
        raise ValueError(f"reps must be a non-negative int, got {reps}")
    if x.shape[1] % 8 or w.shape[1] % 8:
        raise ValueError(f"gemm_rate needs K and N in multiples of 8, got {tuple(w.shape)}")


def _launch(x: torch.Tensor, w: torch.Tensor, reps: int) -> torch.Tensor:
    _nvcc.check_aligned(x, w)
    lib, _ = _nvcc.load("gemm_rate", _ENTRY_POINTS)
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gemm_rate_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, reps,
                                   int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"gemm_rate kernel launch failed: cudaError {err}")
    gemm_rate.launches[dtype_name(x.dtype)] += 1
    return y


def gemm_rate(x: torch.Tensor, w: torch.Tensor, reps: int = 64) -> torch.Tensor:
    """x (M, K), w (K, N), contiguous, both float32 or both bfloat16, K and N
    multiples of 8. Returns Σ_{reps} x @ w, (M, N) in x's dtype."""
    _check(x, w, reps)
    if x.is_cuda:
        return _launch(x, w, int(reps))
    return gemm_rate_plain(x, w, int(reps))


gemm_rate.launches = collections.Counter()
