"""The CycleGAN family's nets (NCHW), port of ``vst/models/cyclegan.py``
(``methods/GAN-based/CycleGAN/models/networks.py``).

``define_G`` builds the resnet_9blocks (the default), resnet_6blocks,
unet_256 and unet_128 generators; ``define_D`` the basic 70×70 PatchGAN, the
n_layers and the pixel discriminators. Norms are 'instance' by default
(no affine parameters), convs carry a bias, init N(0, 0.02) with zero bias
(``networks.py:67-99``). Images are in [−1, 1] (tanh output). Also here: the
GAN losses, the gradient penalty, the ImagePool and ConGAN's fusion block.

Module names are the reference's ``state_dict`` keys: junyanz's
``nn.Sequential`` indices (the pads, activations and norms hold their
places, with or without parameters), e.g. ResnetGenerator's convs at
``model.1``, ``model.4``, ``model.7``, its blocks at ``model.10`` …
``model.18`` (``conv_block.1`` / ``conv_block.5``), transposed convs at
``model.19`` / ``model.22`` and the head at ``model.26`` (9 blocks); the
70×70 PatchGAN's convs at ``model.0``, ``2``, ``5``, ``8``, ``11``; the U-Net
nests ``model.model.…``. vst has no torch converter for this family:
``vst_torch.convert.cyclegan_*_state_dict_from_jax`` is the only bridge.
Where vst, which the port follows, differs from the reference:

* every conv has a bias; the reference drops it in front of a batch norm;
* the U-Net's skip carries the block's input; the reference's in-place
  ``LeakyReLU(0.2, True)`` turns it into leaky_relu(input) before the concat;
* the 'batch' norm is eval mode on stored statistics, and the statistics
  are *parameters* (vst declares them with ``self.param``), so an optimizer
  over the net trains them. No command selects 'batch'.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
from torch import nn

from vst_torch.nn.conv import ConvLayer, ConvT
from vst_torch.nn.norm import InstanceNorm, instance_norm


class Conv(nn.Conv2d):
    """vst's ``_Conv`` (``:33-52``): symmetric zero pad, kernel N(0, 0.02),
    bias 0."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 pad: int = 0):
        super().__init__(in_channels, out_channels, kernel, stride, pad)
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02)
            self.bias.zero_()


class Norm(nn.Module):
    """vst's ``_Norm`` (``:83-102``): 'instance' (``instance_norm``, no
    parameters, as junyanz's ``affine=False``), 'none', or 'batch': eval mode,
    (x − running_mean) / √(running_var + 1e-5) · weight + bias, all four
    ``nn.Parameter``s as in vst (so Adam trains the statistics too);
    weight N(1, 0.02), bias 0, statistics 0 and 1."""

    def __init__(self, kind: str, channels: int):
        super().__init__()
        if kind not in ("instance", "none", "batch"):
            raise ValueError(kind)
        self.kind = kind
        if kind == "batch":
            self.weight = nn.Parameter(1.0 + 0.02 * torch.randn(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
            self.running_mean = nn.Parameter(torch.zeros(channels))
            self.running_var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "instance":
            return instance_norm(x)
        if self.kind == "none":
            return x
        shape = (1, -1, 1, 1)
        return ((x - self.running_mean.view(shape)) / torch.sqrt(self.running_var.view(shape) + 1e-5)
                * self.weight.view(shape) + self.bias.view(shape))


class ResnetBlock(nn.Module):
    """``networks.py`` ResnetBlock: reflect pad, conv, norm, ReLU, reflect
    pad, conv, norm, plus the input (``conv_block.1`` and ``.5``)."""

    def __init__(self, dim: int, norm: str = "instance"):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), Conv(dim, dim, 3), Norm(norm, dim), nn.ReLU(),
            nn.ReflectionPad2d(1), Conv(dim, dim, 3), Norm(norm, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """c7s1-ngf, d2ngf, d4ngf, ``n_blocks`` resnet blocks, u2ngf, ungf,
    c7s1-out, tanh (``networks.py:316-379``). ``output_nc`` is 3 for images,
    2 for MoGAN's motion translators, which also take 2 channels in."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64, n_blocks: int = 9,
                 norm: str = "instance"):
        super().__init__()
        layers = [nn.ReflectionPad2d(3), Conv(input_nc, ngf, 7), Norm(norm, ngf), nn.ReLU()]
        for mult in (1, 2):
            layers += [Conv(ngf * mult, ngf * mult * 2, 3, stride=2, pad=1),
                       Norm(norm, ngf * mult * 2), nn.ReLU()]
        layers += [ResnetBlock(ngf * 4, norm) for _ in range(n_blocks)]
        for mult in (4, 2):
            layers += [ConvT(ngf * mult, ngf * mult // 2), Norm(norm, ngf * mult // 2), nn.ReLU()]
        layers += [nn.ReflectionPad2d(3), Conv(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class UnetSkipConnectionBlock(nn.Module):
    """One level of the U-Net (``networks.py:450-510``): [leaky ReLU 0.2,]
    a 4×4 stride-2 conv [, norm], the inner levels, ReLU, a 4×4 transposed
    conv, then tanh (outermost) or a norm and the concat with the block's
    input on the channel axis. The innermost level has no down norm."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "instance"):
        super().__init__()
        self.outermost = outermost
        down = Conv(outer_nc if input_nc is None else input_nc, inner_nc, 4, stride=2, pad=1)
        up = ConvT(inner_nc if innermost else inner_nc * 2, outer_nc, kernel=4, out_pad=0)
        if outermost:
            layers = [down, submodule, nn.ReLU(), up, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(), up, Norm(norm, outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), down, Norm(norm, inner_nc), submodule, nn.ReLU(), up,
                      Norm(norm, outer_nc)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UnetGenerator(nn.Module):
    """U-Net generator (``networks.py:436-447``): ``num_downs`` nested levels
    (8 for unet_256, 7 for unet_128, 5 at least); channels ngf → 2ngf → 4ngf
    → 8ngf, then the inner levels at 8ngf. H and W multiples of
    2^num_downs."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, num_downs: int = 8, ngf: int = 64,
                 norm: str = "instance"):
        super().__init__()
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True, norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=block, norm=norm)
        for mult in (4, 2, 1):
            block = UnetSkipConnectionBlock(ngf * mult, ngf * mult * 2, submodule=block, norm=norm)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, input_nc=input_nc, submodule=block,
                                             outermost=True, norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class NLayerDiscriminator(nn.Module):
    """PatchGAN (``networks.py:513-551``): C(ndf) without norm, then
    ``n_layers`` − 1 stride-2 convs and one stride-1 conv at up to 8·ndf,
    each with a norm and leaky ReLU 0.2, then a 1-channel conv: patch
    logits. ``n_layers`` = 3 is the 70×70 'basic' D."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance"):
        super().__init__()
        layers = [Conv(input_nc, ndf, 4, stride=2, pad=1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            layers += [Conv(ndf * prev, ndf * mult, 4, stride=2 if n < n_layers else 1, pad=1),
                       Norm(norm, ndf * mult), nn.LeakyReLU(0.2)]
        layers += [Conv(ndf * mult, 1, 4, stride=1, pad=1)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class PixelDiscriminator(nn.Module):
    """1×1 PatchGAN (``networks.py:554-579``), keys ``net.0``, ``net.2``,
    ``net.3`` (the norm), ``net.5``."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, norm: str = "instance"):
        super().__init__()
        self.net = nn.Sequential(
            Conv(input_nc, ndf, 1), nn.LeakyReLU(0.2), Conv(ndf, ndf * 2, 1),
            Norm(norm, ndf * 2), nn.LeakyReLU(0.2), Conv(ndf * 2, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


def define_G(netG: str = "resnet_9blocks", output_nc: int = 3, ngf: int = 64,
             norm: str = "instance") -> nn.Module:
    """``networks.py:119-162``: resnet_9blocks, resnet_6blocks (any
    ``resnet_{n}blocks``: the same layout with n blocks), unet_256, unet_128.
    The net takes ``output_nc`` channels in, as vst's (whose convs take
    their input's channels) are used."""
    m = re.fullmatch(r"resnet_(\d+)blocks", netG)
    if m:
        return ResnetGenerator(output_nc, output_nc, ngf, int(m.group(1)), norm)
    if netG in ("unet_256", "unet_128"):
        return UnetGenerator(output_nc, output_nc, 8 if netG == "unet_256" else 7, ngf, norm)
    raise ValueError(netG)


def define_D(netD: str = "basic", ndf: int = 64, n_layers: int = 3,
             norm: str = "instance") -> nn.Module:
    """``networks.py:165-204``: basic (3 layers), n_layers, pixel."""
    if netD == "basic":
        return NLayerDiscriminator(3, ndf, 3, norm)
    if netD == "n_layers":
        return NLayerDiscriminator(3, ndf, n_layers, norm)
    if netD == "pixel":
        return PixelDiscriminator(3, ndf, norm)
    raise ValueError(netD)


# -- GAN losses (networks.py:209-313) --------------------------------------------

def gan_loss(pred: torch.Tensor, target_is_real: bool, mode: str = "lsgan") -> torch.Tensor:
    """GANLoss: lsgan = MSE against 1 / 0; vanilla = BCE with logits (vst's
    stable form); wgangp = −mean(pred) for real, +mean(pred) for fake. The
    prediction is upcast to float32 first (float64 stays float64)."""
    pred = pred.to(torch.promote_types(pred.dtype, torch.float32))
    if mode == "lsgan":
        return (pred - (1.0 if target_is_real else 0.0)).square().mean()
    if mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        return (pred.clamp_min(0) - pred * target + torch.log1p(torch.exp(-pred.abs()))).mean()
    if mode == "wgangp":
        return -pred.mean() if target_is_real else pred.mean()
    raise ValueError(mode)


def gradient_penalty(net_d: nn.Module, real: torch.Tensor, fake: torch.Tensor,
                     alpha: Optional[torch.Tensor] = None, mode: str = "mixed",
                     constant: float = 1.0, lambda_gp: float = 10.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """cal_gradient_penalty (``networks.py:278-313``): the gradient of Σ D at
    x (the reals, the fakes, or α·real + (1 − α)·fake, α (B, 1, 1, 1) given
    or drawn from ``generator``), its L2 norm over each sample with the
    +1e-16 inside, mean((‖g‖ − c)²)·λ. Differentiable in D's parameters."""
    if mode == "real":
        x = real
    elif mode == "fake":
        x = fake
    else:
        if alpha is None:
            alpha = torch.rand((real.shape[0], 1, 1, 1), generator=generator,
                               device=real.device, dtype=real.dtype)
        x = alpha * real + (1 - alpha) * fake
    x = x.detach().requires_grad_(True)
    g, = torch.autograd.grad(net_d(x).sum(), x, create_graph=True)
    norm = (g.reshape(real.shape[0], -1) + 1e-16).square().sum(1).sqrt()
    return (norm - constant).square().mean() * lambda_gp


# -- ImagePool (util/image_pool.py:5-54) ------------------------------------------

Pool = Dict[str, object]


def image_pool_init(pool_size: int, image_shape, dtype=torch.float32, device="cpu") -> Pool:
    """The pool's state: ``buffer`` (max(pool_size, 1), C, H, W) on the
    device and ``count``, a host int (how full it is)."""
    return {"buffer": torch.zeros((max(pool_size, 1),) + tuple(image_shape), dtype=dtype,
                                  device=device),
            "count": 0}


def image_pool_query(state: Pool, images: torch.Tensor, u: torch.Tensor, idx: torch.Tensor,
                     pool_size: int = 50):
    """vst's ``image_pool_query`` (``:311-349``) with its draws given: image
    i of the batch, in order, is inserted and returned while the pool is not
    full; once full, with u[i] > 0.5 it replaces slot idx[i] and the slot's
    old image is returned, else the image itself. ``u`` (B,) in [0, 1) and
    ``idx`` (B,) long in [0, pool_size) lie on the images' device.

    How full the pool is does not depend on a draw, so the branch is taken
    on the host and the swap done on the device (``torch.where``,
    ``index_copy_``): no host sync. The buffer is written in place; returns
    (the new state, the images to use)."""
    if pool_size == 0:
        return state, images
    buf, count = state["buffer"], state["count"]
    outs = []
    for i in range(images.shape[0]):
        img = images[i:i + 1]
        if count < pool_size:
            buf[count] = img[0]
            count += 1
            outs.append(img)
            continue
        slot = idx[i:i + 1]
        use_old = u[i] > 0.5
        old = buf.index_select(0, slot)
        outs.append(torch.where(use_old, old, img))
        buf.index_copy_(0, slot, torch.where(use_old, img, old))
    return {"buffer": buf, "count": count}, torch.cat(outs, 0)


class FusionBlock(nn.Module):
    """ConGAN's fusion net (``vst/models/cyclegan.py:352-367``,
    ``ConGAN/models/networks.py:659-715``): three reflect-pad 3×3 convs on
    (styled − warped), the first two with an affine instance norm and ReLU,
    the last a sigmoid → a per-pixel mask m; output m·warped + (1 − m)·styled.
    Convs torch's default init (vst's ``ConvLayer``), norms 1 and 0.

    Keys ``conv1.conv2d``, ``in1``, ``conv2.conv2d``, ``in2``,
    ``conv3.conv2d``: chosen here, not checked against a ConGAN checkpoint
    (none is in the repository), so a reference file may need its keys
    renamed."""

    def __init__(self, channels: int = 3, width: int = 32):
        super().__init__()
        self.conv1 = ConvLayer(channels, width, 3)
        self.in1 = InstanceNorm(width)
        self.conv2 = ConvLayer(width, width, 3)
        self.in2 = InstanceNorm(width)
        self.conv3 = ConvLayer(width, 1, 3)

    def forward(self, simg: torch.Tensor, wimg: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.in1(self.conv1(simg - wimg)))
        h = torch.relu(self.in2(self.conv2(h)))
        mask = torch.sigmoid(self.conv3(h))
        return mask * wimg + (1 - mask) * simg
