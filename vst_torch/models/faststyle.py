"""FastStyleNet — the Johnson feed-forward transformer, port of
``vst/models/faststyle.py`` (``methods/learning-based/network.py:263-298``).

3 down convs (9×9 s1, 3×3 s2, 3×3 s2) → 5 residual blocks with learned
strength gates → 2 nearest-upsample convs → ConvTanh. With n_styles > 1 the
conv/deconv stages use the conditional instance norm; the residual blocks
always use the plain affine one. Module names are the reference's, so its
``state_dict`` keys are what ``faststyle_params_from_torch`` reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vst_torch.nn.conv import ConvLayer, ConvTanh, UpsampleConvLayer
from vst_torch.nn.norm import ConditionalInstanceNorm, InstanceNorm


def _style_norm(c: int, n_styles: int) -> nn.Module:
    return InstanceNorm(c) if n_styles == 1 else ConditionalInstanceNorm(c, n_styles)


def _apply_norm(norm: nn.Module, x: torch.Tensor, style_id) -> torch.Tensor:
    if isinstance(norm, ConditionalInstanceNorm):
        return norm(x, style_id)
    return norm(x)


class ConvInstRelu(ConvLayer):
    """ConvLayer → (conditional) instance norm → ReLU (``network.py:147-171``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, n_styles):
        super().__init__(in_channels, out_channels, kernel_size, stride)
        self.instance = _style_norm(out_channels, n_styles)

    def forward(self, x, style_id=0):
        return F.relu(_apply_norm(self.instance, super().forward(x), style_id))


class UpsampleConvInstRelu(UpsampleConvLayer):
    """UpsampleConvLayer → (conditional) instance norm → ReLU
    (``network.py:193-217``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, n_styles,
                 upsample=2):
        super().__init__(in_channels, out_channels, kernel_size, stride, upsample)
        self.instance = _style_norm(out_channels, n_styles)

    def forward(self, x, style_id=0):
        return F.relu(_apply_norm(self.instance, super().forward(x), style_id))


class ResidualBlock(nn.Module):
    """``network.py:219-261``: two reflect-pad convs with affine instance
    norms and the gated residual ``2|s·w|/(1+|s·w|)·out + x``, where w is
    the learned ``layer_strength`` and s the runtime style strength."""

    def __init__(self, channels: int = 128, kernel_size: int = 3):
        super().__init__()
        self.conv1 = ConvLayer(channels, channels, kernel_size)
        self.in1 = InstanceNorm(channels)
        self.conv2 = ConvLayer(channels, channels, kernel_size)
        self.in2 = InstanceNorm(channels)
        self.layer_strength = nn.Parameter(torch.ones(1))

    def forward(self, x, style_strength=1.0):
        s = (style_strength * self.layer_strength).abs()
        s = 2.0 * s / (1.0 + s)
        out = F.relu(self.in1(self.conv1(x)))
        out = self.in2(self.conv2(out))
        return s * out + x


class FastStyleNet(nn.Module):
    """Returns (features, styled) like the reference; input (B, num_inp, H, W)
    in the caller's pixel range, output roughly [−22.5, 277.5]."""

    def __init__(self, num_inp: int = 3, n_styles: int = 1):
        super().__init__()
        self.n_styles = n_styles
        self.conv1 = ConvInstRelu(num_inp, 32, 9, 1, n_styles)
        self.conv2 = ConvInstRelu(32, 64, 3, 2, n_styles)
        self.conv3 = ConvInstRelu(64, 128, 3, 2, n_styles)
        for j in range(1, 6):
            setattr(self, f"res{j}", ResidualBlock(128))
        self.deconv1 = UpsampleConvInstRelu(128, 64, 3, 1, n_styles)
        self.deconv2 = UpsampleConvInstRelu(64, 32, 3, 1, n_styles)
        self.deconv3 = ConvTanh(32, 3, 9, 1)

    def forward(self, x, style_strength=1.0, style_id=0):
        x = self.conv1(x, style_id)
        x = self.conv2(x, style_id)
        x = self.conv3(x, style_id)
        for j in range(1, 6):
            x = getattr(self, f"res{j}")(x, style_strength)
        features = x
        x = self.deconv1(x, style_id)
        x = self.deconv2(x, style_id)
        return features, self.deconv3(x)
