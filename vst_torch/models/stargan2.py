"""StarGAN v2's nets (NCHW), port of ``vst/models/stargan2.py:29-287``
(``StarGANv2Adv/core/model.py``).

Generator (encoder ``ResBlk``s, then ``AdainResBlk``s conditioned on a
style code), ``MappingNetwork`` (a latent z → one style code a domain),
``StyleEncoder`` and the multi-domain ``Discriminator``. Residual paths
scale by 1/√2 (``model.py:64``). Each net picks its domain's row with the
domain ids clipped into range, as vst's ``take_along_axis(mode="clip")``
(the reference would raise).

Module names are the reference's ``state_dict`` keys, so vst's
``generator/mapping/style_encoder/discriminator_params_from_torch``
(``vst/models/stargan2.py:341-450``) load the port's weights;
``vst_torch.convert`` has the inverses. ``decode`` is the reference's stack:
the two bottleneck blocks first, then the upsampling blocks from the
coarsest (``model.py:152-165``).

Initialisation is the reference's ``he_init`` (``core/utils.py:53-60``):
kaiming normal, fan-in, on every conv and linear weight; zero biases.

With ``w_hpf > 0`` the generator has one more down / up level, its
``AdainResBlk``s return the residual alone, and, given the FAN's masks
(``vst_torch.models.wing.get_heatmap``), the decoder adds a high-pass of the
masked encoder activations at 32, 64 and 128 pixels (``model.py:132-186``).
The thesis runs ``w_hpf = 0`` (``PARITY.md:65``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vst_torch.nn.norm import AdaIN, InstanceNorm
from vst_torch.ops.image import avg_pool2d, resize_bilinear, resize_nearest

SQRT2 = math.sqrt(2.0)


@torch.no_grad()
def he_init_(net: nn.Module) -> nn.Module:
    """``core/utils.py:53-60`` on every conv and linear of ``net``."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_normal_(m.weight, mode="fan_in", nonlinearity="relu")
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return net


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _select(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row ``y[b]`` of ``out[b]`` (B, D, ...) per sample, ids clipped into
    [0, D)."""
    idx = y.long().clamp(0, out.shape[1] - 1)
    return out[torch.arange(out.shape[0], device=out.device), idx]


def _dims(img_size: int, max_conv_dim: int, repeat_num: int):
    dims = [2 ** 14 // img_size]
    for _ in range(repeat_num):
        dims.append(min(dims[-1] * 2, max_conv_dim))
    return dims


class ResBlk(nn.Module):
    """``model.py:23-64``: pre-activation residual, optional instance norms
    and 2×2 average-pool downsample, a learned 1×1 shortcut on a change of
    width, out / √2."""

    def __init__(self, dim_in: int, dim_out: int, normalize: bool = False,
                 downsample: bool = False):
        super().__init__()
        self.normalize = normalize
        self.downsample = downsample
        self.conv1 = nn.Conv2d(dim_in, dim_in, 3, 1, 1)
        self.conv2 = nn.Conv2d(dim_in, dim_out, 3, 1, 1)
        if normalize:
            self.norm1 = InstanceNorm(dim_in)
            self.norm2 = InstanceNorm(dim_in)
        self.conv1x1 = nn.Conv2d(dim_in, dim_out, 1, 1, 0, bias=False) if dim_in != dim_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = x if self.conv1x1 is None else self.conv1x1(x)
        if self.downsample:
            sc = avg_pool2d(sc, 2, 2)
        h = self.norm1(x) if self.normalize else x
        h = self.conv1(_lrelu(h))
        if self.downsample:
            h = avg_pool2d(h, 2, 2)
        if self.normalize:
            h = self.norm2(h)
        h = self.conv2(_lrelu(h))
        return (sc + h) / SQRT2


class AdainResBlk(nn.Module):
    """``model.py:80-117``: AdaIN-modulated residual, optional nearest 2×
    upsample, a learned 1×1 shortcut on a change of width, out / √2; with
    ``w_hpf > 0`` the residual alone (no shortcut, no / √2), though the
    reference still creates ``conv1x1``, so its checkpoints load."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int = 64, w_hpf: int = 0,
                 upsample: bool = False):
        super().__init__()
        self.w_hpf = w_hpf
        self.upsample = upsample
        self.conv1 = nn.Conv2d(dim_in, dim_out, 3, 1, 1)
        self.conv2 = nn.Conv2d(dim_out, dim_out, 3, 1, 1)
        self.norm1 = AdaIN(style_dim, dim_in)
        self.norm2 = AdaIN(style_dim, dim_out)
        self.conv1x1 = nn.Conv2d(dim_in, dim_out, 1, 1, 0, bias=False) if dim_in != dim_out else None

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        h = _lrelu(self.norm1(x, s))
        if self.upsample:
            h = resize_nearest(h, 2)
        h = self.conv1(h)
        h = self.conv2(_lrelu(self.norm2(h, s)))
        if self.w_hpf > 0:
            return h
        sc = resize_nearest(x, 2) if self.upsample else x
        if self.conv1x1 is not None:
            sc = self.conv1x1(sc)
        return (h + sc) / SQRT2


def laplacian(w_hpf: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """The 3×3 high-pass filter / w_hpf (``model.py:120-125``)."""
    return torch.tensor([[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]],
                        dtype=dtype, device=device) / w_hpf


def _depthwise(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    C = x.shape[1]
    return F.conv2d(x, filt.to(x.dtype).expand(C, 1, 3, 3), padding=1, groups=C)


def high_pass(x: torch.Tensor, w_hpf: float) -> torch.Tensor:
    """``model.py:120-129``: a depthwise 3×3 Laplacian / w_hpf, zero padded."""
    return _depthwise(x, laplacian(w_hpf, x.dtype, x.device))


class HighPass(nn.Module):
    """``model.py:120-129`` as the reference's module: the filter is the
    buffer ``filter``, so a reference generator's ``hpf.filter`` loads."""

    def __init__(self, w_hpf: float):
        super().__init__()
        self.register_buffer("filter", laplacian(w_hpf))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _depthwise(x, self.filter)


HPF_SIZES = (32, 64, 128)  # the activations' heights that take the masked high-pass


class Generator(nn.Module):
    """``model.py:132-186``: from_rgb, ``encode`` (downsampling ResBlks, then
    two bottleneck ResBlks), ``decode`` (two bottleneck AdainResBlks, then
    the upsampling ones), to_rgb (affine instance norm, leaky ReLU, 1×1
    conv). H and W must be multiples of 2^(log2(img_size) − 4), one more
    power of 2 with ``w_hpf > 0``, which adds a level and ``hpf``."""

    def __init__(self, img_size: int = 256, style_dim: int = 64, max_conv_dim: int = 512,
                 w_hpf: int = 0):
        super().__init__()
        repeat_num = int(math.log2(img_size)) - 4 + (1 if w_hpf > 0 else 0)
        dims = _dims(img_size, max_conv_dim, repeat_num)
        self.from_rgb = nn.Conv2d(3, dims[0], 3, 1, 1)
        self.encode = nn.ModuleList(
            [ResBlk(dims[i], dims[i + 1], normalize=True, downsample=True)
             for i in range(repeat_num)]
            + [ResBlk(dims[-1], dims[-1], normalize=True) for _ in range(2)])
        self.decode = nn.ModuleList(
            [AdainResBlk(dims[-1], dims[-1], style_dim, w_hpf) for _ in range(2)]
            + [AdainResBlk(dims[repeat_num - i], dims[repeat_num - 1 - i], style_dim, w_hpf,
                           upsample=True) for i in range(repeat_num)])
        self.to_rgb = nn.Sequential(InstanceNorm(dims[0]), nn.LeakyReLU(0.2),
                                    nn.Conv2d(dims[0], 3, 1, 1, 0))
        he_init_(self)
        if w_hpf > 0:
            self.hpf = HighPass(w_hpf)

    def forward(self, x: torch.Tensor, s: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``masks``: the FAN's (mask, mask2), each (B, 1, H', W'), or None;
        they need ``w_hpf > 0``. Each downsampling block's input at a height
        of 32, 64 or 128 is kept, and after the upsampling block that reaches
        that height, high_pass(mask · kept) is added, the mask (``masks[0]``
        at 32, ``masks[1]`` above) resized bilinearly to the activation. As
        vst, the bottleneck blocks take no part (the reference also checks
        them, which differs only where they run at one of those heights)."""
        if masks is not None and not hasattr(self, "hpf"):
            raise ValueError("masks need a generator built with w_hpf > 0")
        n_down = len(self.encode) - 2
        h = self.from_rgb(x)
        cache = {}
        for i, block in enumerate(self.encode):
            if masks is not None and i < n_down and h.shape[2] in HPF_SIZES:
                cache[h.shape[2]] = h
            h = block(h)
        for i, block in enumerate(self.decode):
            h = block(h, s)
            if masks is not None and i >= 2 and h.shape[2] in HPF_SIZES:
                mask = masks[0] if h.shape[2] == 32 else masks[1]
                mask = resize_bilinear(mask, h.shape[2:])
                h = h + self.hpf(mask * cache[h.shape[2]])
        return self.to_rgb(h)


class MappingNetwork(nn.Module):
    """``model.py:189-218``: a shared 4-layer MLP (512 wide), then a 4-layer
    head a domain; returns the head of ``y``."""

    def __init__(self, latent_dim: int = 16, style_dim: int = 64, num_domains: int = 2):
        super().__init__()
        layers = [nn.Linear(latent_dim, 512), nn.ReLU()]
        for _ in range(3):
            layers += [nn.Linear(512, 512), nn.ReLU()]
        self.shared = nn.Sequential(*layers)
        self.unshared = nn.ModuleList(
            nn.Sequential(nn.Linear(512, 512), nn.ReLU(), nn.Linear(512, 512), nn.ReLU(),
                          nn.Linear(512, 512), nn.ReLU(), nn.Linear(512, style_dim))
            for _ in range(num_domains))
        he_init_(self)

    def forward(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.shared(z)
        return _select(torch.stack([head(h) for head in self.unshared], 1), y)


def _trunk(img_size: int, max_conv_dim: int):
    """The StyleEncoder's and Discriminator's shared layers: from_rgb, the
    downsampling ResBlks, leaky ReLU, a 4×4 VALID conv, leaky ReLU."""
    repeat_num = int(math.log2(img_size)) - 2
    dims = _dims(img_size, max_conv_dim, repeat_num)
    return ([nn.Conv2d(3, dims[0], 3, 1, 1)]
            + [ResBlk(dims[i], dims[i + 1], downsample=True) for i in range(repeat_num)]
            + [nn.LeakyReLU(0.2), nn.Conv2d(dims[-1], dims[-1], 4, 1, 0), nn.LeakyReLU(0.2)],
            dims[-1])


class StyleEncoder(nn.Module):
    """``model.py:221-252``: ``shared`` trunk, then one linear head a
    domain; returns the style code of ``y``."""

    def __init__(self, img_size: int = 256, style_dim: int = 64, num_domains: int = 2,
                 max_conv_dim: int = 512):
        super().__init__()
        layers, dim = _trunk(img_size, max_conv_dim)
        self.shared = nn.Sequential(*layers)
        self.unshared = nn.ModuleList(nn.Linear(dim, style_dim) for _ in range(num_domains))
        he_init_(self)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.shared(x).flatten(1)
        return _select(torch.stack([head(h) for head in self.unshared], 1), y)


class Discriminator(nn.Module):
    """``model.py:255-279``: the trunk and a 1×1 conv to one logit a domain;
    returns the logit of ``y`` per sample."""

    def __init__(self, img_size: int = 256, num_domains: int = 2, max_conv_dim: int = 512):
        super().__init__()
        layers, dim = _trunk(img_size, max_conv_dim)
        self.main = nn.Sequential(*layers, nn.Conv2d(dim, num_domains, 1, 1, 0))
        he_init_(self)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return _select(self.main(x).flatten(1), y)
