"""Wrapper of the Hopper reflect-pad + 3×3 convolution
(``vst_torch/csrc/pad_conv3x3.cu``), which replaces the TPU kernels of
``scripts/bisect_im2col.py:make`` and ``scripts/bisect_kernel_cost.py:make``:
the FastStyleNet residual-trunk conv and the three timing-only modes that
split its cost.

``pad_conv3x3(x, w, mode)`` computes ``pad_conv3x3_plain``: for CPU tensors
by calling it, for CUDA tensors by launching the kernel, built with ``nvcc``
at first use (``vst_torch.kernels._nvcc``). A build or launch that fails
raises. ``pad_conv3x3.launches`` counts kernel launches by (mode, dtype).
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from vst_torch.kernels import _nvcc

MODES = ("full", "mxu_only", "shift_only", "dma_only")
DTYPES = (torch.float32, torch.bfloat16)
_ENTRY_POINTS = {"pad_conv3x3_launch": (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])}


def build() -> str:
    """Compile (once per source version) and load the kernel library.
    Returns nvcc's report from this process's build, or an empty string."""
    return _nvcc.load("pad_conv3x3", _ENTRY_POINTS)[1]


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def out_channels(w: torch.Tensor, mode: str) -> int:
    """C_out of y: w's for the modes with a product, C_in for the others."""
    return w.shape[3] if mode in ("full", "mxu_only") else w.shape[2]


def pad_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """The plain version. With xp = reflect_pad_1(x), x (N, H, W, C_in):

    - ``full``: Σ_{dy,dx} xp[:, dy:dy+H, dx:dx+W] @ w[dy, dx]
      (``bisect_im2col.py`` tap9 / im2col / row3, ``bisect_kernel_cost.py``
      full);
    - ``mxu_only``: Σ_{dy,dx} xp[:, :H, :W] @ w[dy, dx];
    - ``shift_only``: Σ_{dy,dx} xp[:, dy:dy+H, dx:dx+W];
    - ``dma_only``: xp[:, :H, :W].

    Sums in float32, taken tap by tap in (dy, dx) order, cast to x's dtype
    once at the end, as the TPU kernels' ``preferred_element_type=f32``.
    """
    H, W = x.shape[1:3]
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
    if mode == "dma_only":
        return xp[:, :H, :W].contiguous()
    acc = torch.zeros((*x.shape[:3], out_channels(w, mode)), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, :H, :W] if mode == "mxu_only" else xp[:, dy:dy + H, dx:dx + W]
            if mode == "shift_only":
                acc = acc + tap.float()
            else:
                acc = acc + torch.matmul(tap.float(), w[dy, dx].float())
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"x must be (N, H, W, C_in) and w (3, 3, C_in, C_out), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"pad_conv3x3 takes float32 or bfloat16 x and w of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if x.device != w.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x and w on one cpu or cuda device, got {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("pad_conv3x3 takes contiguous (channels-last) x and contiguous w")
    if min(x.shape[1:3]) < 2 or x.shape[3] % 8 or w.shape[3] % 8:
        raise ValueError(f"pad_conv3x3 needs H, W >= 2 and channels in multiples of 8, "
                         f"got x {tuple(x.shape)}, w {tuple(w.shape)}")


def _launch(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    _nvcc.check_aligned(x, w)
    lib, _ = _nvcc.load("pad_conv3x3", _ENTRY_POINTS)
    N, H, W, cin = x.shape
    cout = out_channels(w, mode)
    y = torch.empty((N, H, W, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pad_conv3x3_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W, cin,
                                     cout, MODES.index(mode), int(x.dtype == torch.bfloat16),
                                     stream)
    if err != 0:
        raise RuntimeError(f"pad_conv3x3 kernel launch failed: cudaError {err}")
    pad_conv3x3.launches[(mode, dtype_name(x.dtype))] += 1
    return y


def pad_conv3x3(x: torch.Tensor, w: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """x (N, H, W, C_in) contiguous channels-last, w (3, 3, C_in, C_out), both
    float32 or both bfloat16; H, W ≥ 2, channels multiples of 8. Returns
    (N, H, W, C_out) in x's dtype (C_out = C_in for ``shift_only`` and
    ``dma_only``). See ``pad_conv3x3_plain`` for the modes."""
    _check(x, w, mode)
    if x.is_cuda:
        return _launch(x, w, mode)
    return pad_conv3x3_plain(x, w, mode)


pad_conv3x3.launches = collections.Counter()
