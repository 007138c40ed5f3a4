"""Instance norms (NCHW), port of ``vst/nn/norm.py``: the one-pass
``instance_norm``, the affine ``InstanceNorm``, the multi-style
``ConditionalInstanceNorm`` and StarGAN v2's ``AdaIN``.
"""

from __future__ import annotations

import torch
from torch import nn

from vst_torch.nn.init import conditional_embed_


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over (H, W), as
    ``nn.InstanceNorm2d`` (biased variance, eps inside the root).

    Keeps vst's one-pass statistics: var = E[x²] − E[x]², clamped at 0
    against float32 cancellation. ``F.instance_norm`` centres first, which
    rounds differently. The statistics are float32 for a bfloat16 or
    float32 x and float64 for a float64 x.
    """
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(2, 3), keepdim=True)
    m2 = xf.square().mean(dim=(2, 3), keepdim=True)
    var = (m2 - mean.square()).clamp_min(0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d(C, affine=True)`` with one-pass statistics, keys
    ``weight`` / ``bias``. (RAFT's norm without affine parameters is
    :func:`instance_norm` itself.)"""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.eps) * self.weight[:, None, None] + self.bias[:, None, None]


class ConditionalInstanceNorm(nn.Module):
    """Multi-style norm, the reference's ``ConditionalBatchNorm2d``
    (``network.py:120-145``): an affine instance norm (``bn``) followed by a
    per-style (γ, β) row of the ``embed`` table (num_styles, 2C), γ first.
    ``style_id`` is one scalar for the whole batch; ids outside the table
    are clipped into it, as vst's ``jnp.take(mode="clip")``."""

    def __init__(self, num_features: int, num_styles: int, eps: float = 1e-5):
        super().__init__()
        self.bn = InstanceNorm(num_features, eps=eps)
        self.embed = nn.Embedding(num_styles, 2 * num_features)
        conditional_embed_(self.embed.weight)

    def forward(self, x: torch.Tensor, style_id) -> torch.Tensor:
        c = x.shape[1]
        table = self.embed.weight
        # index_select with a device index: no host round trip per call
        sid = torch.as_tensor(style_id, device=table.device).long().reshape(1)
        gb = table.index_select(0, sid.clamp(0, table.shape[0] - 1))[0]
        return gb[:c, None, None] * self.bn(x) + gb[c:, None, None]


class AdaIN(nn.Module):
    """Adaptive instance norm, vst's ``AdaIN`` (``vst/nn/norm.py:92-111``;
    StarGAN v2's ``model.py:67-77``): an instance norm without parameters,
    then per sample (1 + γ)·x̂ + β, (γ, β) = ``fc(s)`` split in two. ``fc``
    has torch's default weight init, which is vst's
    ``dense_kernel_torch_default``, and a zero bias, which is flax's."""

    def __init__(self, style_dim: int, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.fc = nn.Linear(style_dim, 2 * num_features)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.fc(s)[:, :, None, None].chunk(2, dim=1)
        return (1.0 + gamma) * instance_norm(x, self.eps) + beta
