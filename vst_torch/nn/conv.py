"""Convolution blocks (NCHW), port of ``vst/nn/conv.py``.

vst routes the 9×9 stride-1 convs through a space-to-depth rewrite
(``_S2DConv``, ``vst/kernels/s2d_conv.py``) and the nearest-up2 decoder
convs through a subpixel fold (``_SubpixelUpConv``,
``vst/kernels/layout.py``). Both are exact jnp/lax rewrites shaped for the
TPU's matrix unit, not Pallas kernels; the port computes the plain
reflect-pad + conv and nearest-up2 + reflect-pad + conv they rewrite.
Key names follow ``methods/learning-based/network.py`` (``conv2d``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from vst_torch.ops.image import reflect_pad, resize_nearest

# vst's TorchConv is flax's Conv with torch's default init and symmetric
# zero padding: that is nn.Conv2d itself.
TorchConv = nn.Conv2d


@contextlib.contextmanager
def without_cudnn():
    """Run CUDA convolutions on PyTorch's own path (im2col + cuBLAS) rather
    than cuDNN, restoring the flag on exit. For RAFT: with TF32 off, cuDNN 9
    picks engines for its 3×3 convs over 256 channels at batch 4 × 54×128
    that run its update block about 70× slower than this path on an H100
    (chip_smoke.py's raft phase; PERF.md)."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


class ConvLayer(nn.Module):
    """Reflection pad ⌊k/2⌋, then a VALID conv (``network.py:97-108``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1):
        super().__init__()
        self.pad = kernel_size // 2
        self.conv2d = TorchConv(in_channels, out_channels, kernel_size, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2d(reflect_pad(x, self.pad))


class UpsampleConvLayer(ConvLayer):
    """Nearest upsample, then a ConvLayer (``network.py:173-191``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, upsample: int | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride)
        self.upsample = upsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.upsample:
            x = resize_nearest(x, self.upsample)
        return super().forward(x)


class ConvTanh(ConvLayer):
    """Output head (``network.py:111-118``): tanh(conv(x)/255)·150 + 127.5."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(super().forward(x) / 255.0) * 150.0 + 255.0 / 2.0
