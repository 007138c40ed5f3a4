"""Wrapper of the Hopper correlation-window lookup
(``vst_torch/csrc/corr_lookup.cu``), which replaces the TPU kernel
``vst/kernels/pallas_corr.py`` (``_kernel`` / ``pallas_lookup_level``).

``corr_lookup(pyramid, coords, radius)`` computes
``vst_torch.flow.corr.lookup_pyramid``: for CPU tensors by calling it, for
CUDA tensors by launching the kernel, which it builds with ``nvcc`` at first
use into ``vst_torch/_build/`` (listed in ``.gitignore``) and loads with
ctypes. A build or launch that fails raises. ``corr_lookup.launches``
counts kernel launches (and, while a profiler runs, the counter
``vst.corr_lookup.launches`` of ``vst_torch.core.trace``);
``corr_lookup.plain_backwards`` counts the backward
passes (below), which launch no kernel of their own; while a profiler runs,
each records the span ``vst.corr_lookup.backward`` (on autograd's device
thread on CUDA, so with no enclosing span) and the counter
``vst.corr_lookup.backwards``. The kernel is compiled for the radii of
``KERNEL_RADII`` (RAFT small uses 3, RAFT full 4); on CUDA another radius
raises, on the CPU every radius is computed.

Backward: the TPU kernel had no backward kernel of its own
(``pallas_corr.py:_lookup_bwd``), so the backward recomputes through the
plain version's autograd, on whichever device the inputs lie.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from vst_torch.core.trace import count, span
from vst_torch.flow.corr import lookup_pyramid
from vst_torch.kernels import _nvcc

MAX_LEVELS = 4
KERNEL_RADII = (3, 4)
_ENTRY_POINTS = {"corr_lookup_launch": (
    [ctypes.c_void_p] * 4
    + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
       ctypes.c_int, ctypes.c_void_p])}


def build() -> str:
    """Compile (once per source version) and load the kernel library.

    Returns nvcc's report (registers, spills) from this process's build, or
    an empty string when the library was already built or loaded.
    """
    return _nvcc.load("corr_lookup", _ENTRY_POINTS)[1]


def check_radius(radius: int, device: torch.device) -> None:
    """Raise unless ``radius`` is one the computation on ``device`` takes:
    any non-negative int on the CPU, one of ``KERNEL_RADII`` on CUDA."""
    if int(radius) != radius or radius < 0:
        raise ValueError(f"radius must be a non-negative int, got {radius}")
    if device.type == "cuda" and radius not in KERNEL_RADII:
        raise ValueError(f"the corr_lookup kernel takes radius {KERNEL_RADII}, got {radius}")


def _check(pyramid: Sequence[torch.Tensor], coords: torch.Tensor, radius: int) -> None:
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"corr_lookup takes 1..{MAX_LEVELS} levels, got {len(pyramid)}")
    if coords.dim() != 4 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (B, 2, H, W), got {tuple(coords.shape)}")
    B, _, H, W = coords.shape
    q = B * H * W
    for t in (coords, *pyramid):
        if t.dtype != torch.float32:
            raise TypeError(f"corr_lookup takes float32, got {t.dtype}")
        if t.device != coords.device:
            raise ValueError(f"inputs on {t.device} and {coords.device}")
        if not t.is_contiguous():
            raise ValueError("corr_lookup takes contiguous tensors")
    if coords.device.type not in ("cpu", "cuda"):
        raise ValueError(f"corr_lookup runs on cpu or cuda, got {coords.device}")
    check_radius(radius, coords.device)
    for lvl in pyramid:
        if lvl.dim() != 4 or lvl.shape[0] != q or lvl.shape[1] != 1:
            raise ValueError(
                f"pyramid levels must be ({q}, 1, h, w), got {tuple(lvl.shape)}")


@functools.cache
def _kernel():
    """The kernel's C entry point, built, loaded and resolved once."""
    return _nvcc.load("corr_lookup", _ENTRY_POINTS)[0].corr_lookup_launch


def _launch(pyramid: Sequence[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    # the kernel runs on the current device, which a stream handle of 0 (the
    # default stream) does not name
    if coords.get_device() != torch.cuda.current_device():
        raise ValueError(f"corr_lookup: inputs are on {coords.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}; launch under torch.cuda.device")
    B, _, H, W = coords.shape
    n = 2 * radius + 1
    out = torch.empty((B, H, W, len(pyramid) * n * n), dtype=torch.float32,
                      device=coords.device)
    ptrs = [lvl.data_ptr() for lvl in pyramid] + [None] * (MAX_LEVELS - len(pyramid))
    heights = (ctypes.c_int * MAX_LEVELS)(*[lvl.shape[2] for lvl in pyramid])
    widths = (ctypes.c_int * MAX_LEVELS)(*[lvl.shape[3] for lvl in pyramid])
    err = _kernel()(*ptrs, heights, widths, len(pyramid), coords.data_ptr(), out.data_ptr(),
                    B * H * W, H * W, radius, torch.cuda.current_stream(coords.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup kernel launch failed: cudaError {err}")
    corr_lookup.launches += 1
    count("vst.corr_lookup.launches")
    return out.permute(0, 3, 1, 2)


class _CorrLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, coords, *pyramid):
        ctx.radius = radius
        ctx.save_for_backward(coords, *pyramid)
        if coords.is_cuda:
            return _launch(pyramid, coords, radius)
        return lookup_pyramid(pyramid, coords, radius)

    @staticmethod
    def backward(ctx, grad):
        corr_lookup.plain_backwards += 1
        count("vst.corr_lookup.backwards")
        coords, *pyramid = ctx.saved_tensors
        with span("vst.corr_lookup.backward"), torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in
                      zip([coords, *pyramid], ctx.needs_input_grad[1:])]
            out = lookup_pyramid(inputs[1:], inputs[0], ctx.radius)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
            return (None, *[next(grads) if t.requires_grad else None for t in inputs])


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """Drop-in for ``lookup_pyramid``: pyramid levels (B·H·W, 1, h_l, w_l)
    and coords (B, 2, H, W), all contiguous float32 on one device; on CUDA
    the radius is one of ``KERNEL_RADII``. Returns
    (B, L·(2r+1)², H, W), an NCHW view of a channel-last tensor."""
    _check(pyramid, coords, radius)
    if coords.is_cuda and not (torch.is_grad_enabled() and (
            coords.requires_grad or any(t.requires_grad for t in pyramid))):
        # no graph to record: the autograd.Function's own cost showed in the
        # lookup's host-launched time (chip_smoke.py phase 2 on the H100:
        # 0.070 ms through it, 0.062-0.063 without)
        return _launch(pyramid, coords, int(radius))
    return _CorrLookup.apply(int(radius), coords, *pyramid)


corr_lookup.launches = 0
corr_lookup.plain_backwards = 0
