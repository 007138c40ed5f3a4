"""Initialisers for the parameters the port builds itself.

``nn.Conv2d`` already draws torch's default init (kaiming_uniform with
a=√5, bias U(−1/√fan_in, 1/√fan_in)), which is what vst's
``conv_kernel_torch_default`` reproduces in flax; the port's convs are
``nn.Conv2d`` and need nothing more.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def conditional_embed_(weight: torch.Tensor) -> torch.Tensor:
    """(num_styles, 2C) style table of ``ConditionalBatchNorm2d``
    (``network.py:120-145``): γ ~ N(1, 0.02) in the first C columns, β = 0."""
    c = weight.shape[1] // 2
    weight[:, :c].normal_(1.0, 0.02)
    weight[:, c:].zero_()
    return weight


@torch.no_grad()
def kaiming_normal_fan_out_(weight: torch.Tensor) -> torch.Tensor:
    """``nn.init.kaiming_normal_(mode='fan_out', nonlinearity='relu')``, the
    RAFT encoders' conv init (``utils/raft/raft/extractor.py:150-157``)."""
    cout, _, kh, kw = weight.shape
    return weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)))
