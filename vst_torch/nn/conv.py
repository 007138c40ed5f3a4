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


class TorchConv(nn.Conv2d):
    """vst's ``TorchConv`` (``vst/nn/conv.py:14-48``): flax's Conv with torch's
    default init and symmetric zero padding, which is ``nn.Conv2d``, with
    flax's compute ``dtype`` as ``compute_dtype``. With it set, the parameters
    keep their dtype and the input, kernel and bias are cast to
    ``compute_dtype``, which the output keeps; with ``compute_dtype=None`` it
    is ``nn.Conv2d`` itself."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvT(nn.ConvTranspose2d):
    """vst's ``_ConvT`` (``vst/models/cyclegan.py:55-80``), shared by the
    CycleGAN and StarGAN v1 nets: flax ``ConvTranspose`` with
    ``transpose_kernel=True`` and padding (k−1−p, k−1−p+op), which is
    ``nn.ConvTranspose2d(k, stride 2, p, output_padding=op)``; kernel
    N(0, 0.02), bias 0."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, torch_pad: int = 1,
                 out_pad: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=2, padding=torch_pad,
                         output_padding=out_pad)
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02)
            self.bias.zero_()


@contextlib.contextmanager
def cudnn_enabled(enabled: bool):
    """Run CUDA convolutions on cuDNN or, with ``enabled=False``, on
    PyTorch's own path (im2col + cuBLAS), restoring the flag on exit."""
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = before


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
