"""Wrapper of RAFT's fused SepConvGRU half-step (``vst_torch/csrc/sepconv_gru.cu``):
two float32 implicit-GEMM kernels a half-step, which replace the half-step's
three gate convolutions, its two concatenations and its pointwise math. No
TPU kernel had this job: ``vst/flow/raft.py:206`` (``SepConvGRU``) leaves it
to XLA.

A half-step with taps along ``axis`` (0: the 1×5 pass, 1: the 5×1 pass) is

    z = σ(conv_z([h, x])),  r = σ(conv_r([h, x])),
    h' = (1 − z)·h + z·tanh(conv_q([r·h, x]))

(``update.py:47-58``). ``half_step_plain`` is that math as plain PyTorch, on
any three convolutions (``SepConvGRU``'s own, in any compute dtype);
``gru_zr_plain`` and ``gru_q_plain`` are its two parts.

``sepconv_gru(h, x, convz, convr, convq)`` runs the half-step:
``half_step_plain`` on CPU tensors; on CUDA tensors it packs the three
convolutions as the kernels read them (``pack_gates``, a fresh copy each
call) and launches ``gru_zr`` (z and r·h), then ``gru_q`` (h'), built with
``nvcc`` at first use (``vst_torch.kernels._nvcc``). The kernels have no
backward: on CUDA, under autograd that records (``records_grad``), a
dtype other than float32, or a build or launch that fails, it raises.
``sepconv_gru.launches`` counts the launches of both kernels (and, while a
profiler runs, the counter ``vst.gru.launches`` of ``vst_torch.core.trace``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Tuple

import torch

from vst_torch.core.trace import count
from vst_torch.kernels import _nvcc

HIDDEN = 128  # channels of h, z, r and q the kernels take
TAPS = 5
CHUNK = 16  # x's channels come in chunks of 16
AXES = ((1, 5), (5, 1))  # the kernel size of each tap axis
_ENTRY_POINTS = {
    "gru_zr_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "gru_q_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


class Gates(NamedTuple):
    """A half-step's gate convolutions as the kernels read them: weights
    (5 taps, C_h + C_x input channels, output channels) with the output
    channels contiguous, z's then r's in ``wzr``."""

    axis: int
    wzr: torch.Tensor  # (5, C_h + C_x, 2 C_h)
    bzr: torch.Tensor  # (2 C_h,)
    wq: torch.Tensor  # (5, C_h + C_x, C_h)
    bq: torch.Tensor  # (C_h,)


def build() -> str:
    """Compile (once per source version) and load the kernel library.
    Returns nvcc's report from this process's build, or an empty string."""
    return _nvcc.load("sepconv_gru", _ENTRY_POINTS)[1]


def _taps_major(weight: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, kh, kw) with kh·kw = 5 taps → (5, C_in, C_out)."""
    return weight.reshape(weight.shape[0], weight.shape[1], TAPS).permute(2, 1, 0)


def pack_gates(convz: torch.nn.Conv2d, convr: torch.nn.Conv2d,
               convq: torch.nn.Conv2d) -> Gates:
    """A half-step's three convolutions (1×5 or 5×1, zero padding 2 along
    the taps, with biases) packed into ``Gates``: plain tensor ops outside
    autograd, packed anew on every call, so nothing is kept that could go
    stale."""
    axis = AXES.index(tuple(convz.kernel_size))
    with torch.no_grad():
        wzr = torch.cat([_taps_major(convz.weight), _taps_major(convr.weight)], 2)
        bzr = torch.cat([convz.bias, convr.bias])
        return Gates(axis, wzr, bzr, _taps_major(convq.weight).contiguous(),
                     convq.bias.detach())


def gru_zr_plain(h: torch.Tensor, x: torch.Tensor, convz: Callable,
                 convr: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, r·h) of a half-step: the gates compute in x's dtype, r·h in r's."""
    hx = torch.cat([h.to(x.dtype), x], 1)
    z = torch.sigmoid(convz(hx))
    r = torch.sigmoid(convr(hx))
    return z, r * h.to(r.dtype)


def gru_q_plain(h: torch.Tensor, x: torch.Tensor, z: torch.Tensor, rh: torch.Tensor,
                convq: Callable) -> torch.Tensor:
    """h' = (1 − z)·h + z·tanh(conv_q([r·h, x])), the blend in h's dtype."""
    q = torch.tanh(convq(torch.cat([rh, x], 1)))
    return (1 - z.to(h.dtype)) * h + z.to(h.dtype) * q.to(h.dtype)


def half_step_plain(h: torch.Tensor, x: torch.Tensor, convz: Callable, convr: Callable,
                    convq: Callable) -> torch.Tensor:
    """One SepConvGRU half-step as plain PyTorch, the hidden state in h's
    dtype (``vst/flow/raft.py:216-232``)."""
    return gru_q_plain(h, x, *gru_zr_plain(h, x, convz, convr), convq)


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records what is computed from ``tensors``: grad
    enabled and one of them requiring grad. The kernels have no backward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check(h: torch.Tensor, x: torch.Tensor, gates: Gates, *state: torch.Tensor) -> None:
    if h.dim() != 4 or h.shape[1] != HIDDEN or x.dim() != 4 or x.shape[0] != h.shape[0] \
            or x.shape[2:] != h.shape[2:] or x.shape[1] % CHUNK or x.shape[1] == 0:
        raise ValueError(f"h must be (B, {HIDDEN}, H, W) and x (B, C_x, H, W) with C_x a "
                         f"multiple of {CHUNK}, got {tuple(h.shape)} and {tuple(x.shape)}")
    k = HIDDEN + x.shape[1]
    shapes = ((TAPS, k, 2 * HIDDEN), (2 * HIDDEN,), (TAPS, k, HIDDEN), (HIDDEN,))
    if gates.axis not in (0, 1) or any(t.shape != s for t, s in zip(gates[1:], shapes)):
        raise ValueError(f"gates do not fit x's {x.shape[1]} channels (pack_gates)")
    for t in (h, x, *gates[1:], *state):
        if t.dtype != torch.float32:
            raise TypeError(f"the SepConvGRU kernels take float32, got {t.dtype}")
        if t.device != h.device:
            raise ValueError(f"inputs on {t.device} and {h.device}")
        if not t.is_contiguous():
            raise ValueError("the SepConvGRU kernels take contiguous tensors")
    for t in state:
        if t.shape != h.shape:
            raise ValueError(f"z and r·h must be h's shape {tuple(h.shape)}, got {tuple(t.shape)}")
    if not h.is_cuda:
        raise ValueError(f"the SepConvGRU kernels run on CUDA tensors, got {h.device}")


@functools.cache
def _kernels():
    """The kernels' C entry points, built, loaded and resolved once."""
    lib = _nvcc.load("sepconv_gru", _ENTRY_POINTS)[0]
    return lib.gru_zr_launch, lib.gru_q_launch


def _prepare(h: torch.Tensor, x: torch.Tensor, gates: Gates, *tensors: torch.Tensor):
    # the kernels run on the current device, which a stream handle of 0 (the
    # default stream) does not name
    if h.get_device() != torch.cuda.current_device():
        raise ValueError(f"sepconv_gru: inputs are on {h.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}; launch under torch.cuda.device")
    _nvcc.check_aligned(h, x, *gates[1:], *tensors)
    B, _, H, W = h.shape
    return (B, H, W, x.shape[1], gates.axis, torch.cuda.current_stream(h.device).cuda_stream)


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    sepconv_gru.launches += 1
    count("vst.gru.launches")


def gru_zr(h: torch.Tensor, x: torch.Tensor, gates: Gates) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, r·h) of the half-step ``gates`` packs, one launch of the
    ``gru_zr`` kernel. h (B, 128, H, W), x (B, C_x, H, W), float32,
    contiguous, on CUDA."""
    _check(h, x, gates)
    args = _prepare(h, x, gates)
    z, rh = torch.empty_like(h), torch.empty_like(h)
    _launched(_kernels()[0](h.data_ptr(), x.data_ptr(), gates.wzr.data_ptr(),
                            gates.bzr.data_ptr(), z.data_ptr(), rh.data_ptr(), *args), "gru_zr")
    return z, rh


def gru_q(h: torch.Tensor, x: torch.Tensor, z: torch.Tensor, rh: torch.Tensor,
          gates: Gates) -> torch.Tensor:
    """The new hidden state from ``gru_zr``'s (z, r·h), one launch of the
    ``gru_q`` kernel."""
    _check(h, x, gates, z, rh)
    args = _prepare(h, x, gates, z, rh)
    out = torch.empty_like(h)
    _launched(_kernels()[1](h.data_ptr(), x.data_ptr(), rh.data_ptr(), z.data_ptr(),
                            gates.wq.data_ptr(), gates.bq.data_ptr(), out.data_ptr(), *args),
              "gru_q")
    return out


def sepconv_gru(h: torch.Tensor, x: torch.Tensor, convz: torch.nn.Conv2d,
                convr: torch.nn.Conv2d, convq: torch.nn.Conv2d) -> torch.Tensor:
    """One half-step of the three convolutions: ``half_step_plain`` on CPU
    tensors, the two kernels on CUDA tensors (module docstring)."""
    if not h.is_cuda:
        return half_step_plain(h, x, convz, convr, convq)
    convs = (convz, convr, convq)
    if records_grad(h, x, *(p for c in convs for p in c.parameters())):
        raise RuntimeError("the SepConvGRU kernels have no backward: run them with autograd "
                           "not recording, or half_step_plain")
    gates = pack_gates(*convs)
    return gru_q(h, x, *gru_zr(h, x, gates), gates)


sepconv_gru.launches = 0
