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
import functools

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
    # each attribute read once: this runs on every launch
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    xs, ws = x.shape, w.shape
    if len(xs) != 4 or len(ws) != 4 or ws[0] != 3 or ws[1] != 3 or ws[2] != xs[3]:
        raise ValueError(f"x must be (N, H, W, C_in) and w (3, 3, C_in, C_out), "
                         f"got {tuple(xs)} and {tuple(ws)}")
    dtype = x.dtype
    if dtype not in DTYPES or w.dtype != dtype:
        raise TypeError(f"pad_conv3x3 takes float32 or bfloat16 x and w of one dtype, "
                        f"got {dtype} and {w.dtype}")
    device = x.device
    if w.device != device or device.type not in ("cpu", "cuda"):
        raise ValueError(f"x and w on one cpu or cuda device, got {device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("pad_conv3x3 takes contiguous (channels-last) x and contiguous w")
    if xs[1] < 2 or xs[2] < 2 or xs[3] % 8 or ws[3] % 8:
        raise ValueError(f"pad_conv3x3 needs H, W >= 2 and channels in multiples of 8, "
                         f"got x {tuple(xs)}, w {tuple(ws)}")


# per (mode, dtype): the kernel's mode index, its bf16 flag and the launch-count key
_LAUNCH = {(mode, dtype): (index, int(dtype == torch.bfloat16), (mode, dtype_name(dtype)))
           for index, mode in enumerate(MODES) for dtype in DTYPES}


def launch_args(x: torch.Tensor, w: torch.Tensor, mode: str):
    """For x and w that passed ``_check``: the kernel's integer arguments
    (N, H, W, C_in, C_out, mode index, bf16 flag) and the launch-count key.
    The kernel indexes in 64 bits, so no size is refused here."""
    index, bf16, key = _LAUNCH[mode, x.dtype]
    N, H, W, cin = x.shape
    return (N, H, W, cin, out_channels(w, mode), index, bf16), key


@functools.cache
def _kernel():
    """The kernel's C entry point, built, loaded and resolved once."""
    return _nvcc.load("pad_conv3x3", _ENTRY_POINTS)[0].pad_conv3x3_launch


def _launch(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    # the kernel runs on the current device, which a stream handle of 0 (the
    # default stream) does not name
    if x.get_device() != torch.cuda.current_device():
        raise ValueError(f"pad_conv3x3: x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}; launch under torch.cuda.device")
    _nvcc.check_aligned(x, w)
    args, key = launch_args(x, w, mode)
    y = torch.empty_like(x) if args[4] == args[3] else x.new_empty((*args[:3], args[4]))
    err = _kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(), *args,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pad_conv3x3 kernel launch failed: cudaError {err}")
    pad_conv3x3.launches[key] += 1
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
