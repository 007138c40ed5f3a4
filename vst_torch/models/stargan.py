"""StarGAN v1's nets (NCHW), port of ``vst/models/stargan.py``
(``methods/GAN-based/StarGAN/model.py``).

One generator for all domains, conditioned on a domain label tiled over the
image and concatenated to it (``model.py:56-63``); the discriminator returns
PatchGAN source logits and domain logits (``:86-90``).

Module names are the reference's ``state_dict`` keys (``main.{i}``,
``conv1``, ``conv2``); vst has no torch converter for v1, so
``vst_torch.convert.stargan_{generator,discriminator}_state_dict_from_jax``
is the only bridge. Two places where vst, which the port follows, differs
from the reference:

* the instance norms use per-sample statistics, training mode, always; the
  reference's ``track_running_stats=True`` would use running statistics in
  eval mode, and its files carry ``running_mean`` / ``running_var``, which
  the port has no buffers for;
* the transposed convs carry a bias (vst's ``_ConvT``,
  ``vst/models/cyclegan.py:55-80``, zero at init); the reference's have none.

Init as vst's: convs torch's default (vst's ``conv_kernel_torch_default``);
the transposed convs N(0, 0.02) with zero bias; norms 1 and 0.
"""

from __future__ import annotations

import torch
from torch import nn

from vst_torch.nn.conv import ConvT
from vst_torch.nn.norm import InstanceNorm


class ResidualBlock(nn.Module):
    """``model.py:7-20``: conv, norm, ReLU, conv, norm, plus the input; the
    convs have no bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv2d(dim, dim, 3, 1, 1, bias=False), InstanceNorm(dim), nn.ReLU(),
            nn.Conv2d(dim, dim, 3, 1, 1, bias=False), InstanceNorm(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.main(x)


class Generator(nn.Module):
    """``model.py:23-63``. forward(x (B, 3, H, W) in [−1, 1], c (B, c_dim)
    one-hot or soft labels) → tanh image; H, W multiples of 4."""

    def __init__(self, conv_dim: int = 64, c_dim: int = 5, repeat_num: int = 6):
        super().__init__()
        layers = [nn.Conv2d(3 + c_dim, conv_dim, 7, 1, 3, bias=False), InstanceNorm(conv_dim),
                  nn.ReLU()]
        dim = conv_dim
        for _ in range(2):
            layers += [nn.Conv2d(dim, dim * 2, 4, 2, 1, bias=False), InstanceNorm(dim * 2),
                       nn.ReLU()]
            dim *= 2
        layers += [ResidualBlock(dim) for _ in range(repeat_num)]
        for _ in range(2):
            layers += [ConvT(dim, dim // 2, kernel=4, torch_pad=1, out_pad=0),
                       InstanceNorm(dim // 2), nn.ReLU()]
            dim //= 2
        layers += [nn.Conv2d(dim, 3, 7, 1, 3, bias=False), nn.Tanh()]
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        c_map = c.to(x.dtype)[:, :, None, None].expand(-1, -1, *x.shape[2:])
        return self.main(torch.cat([x, c_map], 1))


class Discriminator(nn.Module):
    """``model.py:66-90``: ``repeat_num`` stride-2 4×4 convs with leaky ReLU
    (0.01), then ``conv1`` (3×3, the source logits) and ``conv2`` (a
    (image_size / 2^repeat_num)² VALID conv, the domain logits).
    forward → (out_src (B, 1, h, w), out_cls (B, c_dim))."""

    def __init__(self, image_size: int = 128, conv_dim: int = 64, c_dim: int = 5,
                 repeat_num: int = 6):
        super().__init__()
        layers = [nn.Conv2d(3, conv_dim, 4, 2, 1), nn.LeakyReLU(0.01)]
        dim = conv_dim
        for _ in range(1, repeat_num):
            layers += [nn.Conv2d(dim, dim * 2, 4, 2, 1), nn.LeakyReLU(0.01)]
            dim *= 2
        self.main = nn.Sequential(*layers)
        self.conv1 = nn.Conv2d(dim, 1, 3, 1, 1, bias=False)
        self.conv2 = nn.Conv2d(dim, c_dim, image_size // 2 ** repeat_num, bias=False)

    def forward(self, x: torch.Tensor):
        h = self.main(x)
        out_cls = self.conv2(h)
        return self.conv1(h), out_cls.view(out_cls.shape[0], out_cls.shape[1])
