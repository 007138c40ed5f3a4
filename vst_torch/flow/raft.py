"""RAFT optical flow (full variant), NCHW, port of ``vst/flow/raft.py``
(``utils/raft/raft/``).

Feature encoder (instance norm) + context encoder (batch norm, eval
statistics) → 4-level all-pairs correlation pyramid → a Python loop of GRU
iterations: windowed corr lookup (the Hopper kernel's wrapper) → motion
encoder → SepConvGRU → flow head; after the loop, the upsample-mask head
and the convex 8× upsample of the 1/8-resolution flow. Module names are the
reference's, so its ``state_dict`` keys are what ``raft_params_from_torch``
reads.

Not ported yet: the small variant, ``train_mode`` (per-iteration flows) and
the bf16 encoder/update dtypes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vst_torch.flow.corr import build_pyramid
from vst_torch.kernels.corr_lookup import corr_lookup
from vst_torch.nn.conv import TorchConv, without_cudnn
from vst_torch.nn.init import kaiming_normal_fan_out_
from vst_torch.nn.norm import instance_norm


class _Norm(nn.Module):
    """RAFT's norms (``extractor.py:16-38``): 'instance' (InstanceNorm2d
    without affine, so no keys), 'batch' (eval mode on stored statistics),
    'group' (affine) or 'none'."""

    def __init__(self, norm_fn: str, channels: int, num_groups: int = 8):
        super().__init__()
        if norm_fn not in ("instance", "batch", "group", "none"):
            raise ValueError(norm_fn)
        self.norm_fn = norm_fn
        self.num_groups = num_groups
        if norm_fn in ("batch", "group"):
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        if norm_fn == "batch":
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.norm_fn == "none":
            return x
        if self.norm_fn == "instance":
            return instance_norm(x)
        if self.norm_fn == "batch":
            x = (x - self.running_mean[:, None, None]) / torch.sqrt(
                self.running_var[:, None, None] + 1e-5)
        else:
            B, C, H, W = x.shape
            xg = x.reshape(B, self.num_groups, C // self.num_groups, H, W)
            mean = xg.mean(dim=(2, 3, 4), keepdim=True)
            var = ((xg - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
            x = ((xg - mean) / torch.sqrt(var + 1e-5)).reshape(B, C, H, W)
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class ResidualBlock(nn.Module):
    """``extractor.py:6-56``. With stride ≠ 1 the shortcut is
    ``downsample = Sequential(conv1×1, norm3)``, norm3 registered twice as
    in the reference, so both key sets appear."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        ng = planes // 8
        self.conv1 = TorchConv(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = TorchConv(planes, planes, 3, padding=1)
        self.norm1 = _Norm(norm_fn, planes, ng)
        self.norm2 = _Norm(norm_fn, planes, ng)
        self.downsample = None
        if stride != 1:
            self.norm3 = _Norm(norm_fn, planes, ng)
            self.downsample = nn.Sequential(
                TorchConv(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """``extractor.py:118-192``: conv 7×7 s2 → residual stages (64, 96, 128)
    → 1×1 output conv."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch"):
        super().__init__()
        self.conv1 = TorchConv(3, 64, 7, stride=2, padding=3)
        self.norm1 = _Norm(norm_fn, 64, 8)
        dims = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
        for i, (cin, dim, stride) in enumerate(dims, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1)))
        self.conv2 = TorchConv(128, output_dim, 1)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_fan_out_(m.weight)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class FlowHead(nn.Module):
    """``update.py:6-14``."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = TorchConv(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = TorchConv(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicMotionEncoder(nn.Module):
    """``update.py:79-97``: corr → 256 → 192; flow → 128 → 64; fused → 126,
    concatenated with the flow."""

    def __init__(self, cor_planes: int = 4 * 9 * 9):
        super().__init__()
        self.convc1 = TorchConv(cor_planes, 256, 1)
        self.convc2 = TorchConv(256, 192, 3, padding=1)
        self.convf1 = TorchConv(2, 128, 7, padding=3)
        self.convf2 = TorchConv(128, 64, 3, padding=1)
        self.conv = TorchConv(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow], 1)


class SepConvGRU(nn.Module):
    """``update.py:33-60``: a horizontal (1×5) then a vertical (5×1) GRU pass."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        for tag, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{tag}",
                        TorchConv(cin, hidden_dim, ks, padding=pad))

    def forward(self, h, x):
        for tag in ("1", "2"):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq{tag}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class UpMaskHead(nn.Sequential):
    """``update.py:119-123``: the convex-upsample mask logits, ×0.25. Kept
    under ``update_block.mask`` as in the reference, but applied once after
    the GRU loop: evaluation reads only the last iteration's mask."""

    def __init__(self, hidden_dim: int = 128):
        super().__init__(TorchConv(hidden_dim, 256, 3, padding=1), nn.ReLU(),
                         TorchConv(256, 64 * 9, 1))

    def forward(self, net):
        return 0.25 * super().forward(net)


class BasicUpdateBlock(nn.Module):
    """``update.py:114-136``: motion encoder, GRU and flow head; the mask
    head lives here for the key names and runs from :class:`RAFT`."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden_dim, input_dim=128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = UpMaskHead(hidden_dim)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, self.flow_head(net)


def coords_grid(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """(B, 2, ht, wd) pixel grid, channel 0 = x (``utils.py:74-77``)."""
    ys, xs = torch.meshgrid(torch.arange(ht, dtype=torch.float32, device=device),
                            torch.arange(wd, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], 0)[None].repeat(batch, 1, 1, 1)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex 8× upsample (``raft.py:72-83``). flow (B, 2, H, W); mask
    (B, 576, H, W) with channel index k·64 + di·8 + dj, k the 3×3 neighbour
    and (di, dj) the sub-pixel position."""
    B, _, H, W = flow.shape
    m = torch.softmax(mask.reshape(B, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8.0 * flow, [3, 3], padding=1).reshape(B, 2, 9, 1, 1, H, W)
    up = torch.sum(m * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(B, 2, 8 * H, 8 * W)


class RAFT(nn.Module):
    """Full RAFT (``raft.py:24-144``). Images (B, 3, H, W), RGB in [0, 255],
    H and W multiples of 8 (pad with ``InputPadder``). Returns
    (flow_low, flow_up) as the reference's test mode.

    ``lookup`` is the per-iteration window lookup: the Hopper kernel's
    wrapper by default (the plain version for CPU tensors); passing
    ``vst_torch.flow.corr.lookup_pyramid`` runs the plain version on any
    device, which is how the kernel is checked end to end. Convolutions run
    without cuDNN (``without_cudnn``).
    """

    hidden_dim = 128
    context_dim = 128
    corr_levels = 4
    corr_radius = 4

    def __init__(self, iters: int = 12, lookup: Callable = corr_lookup):
        super().__init__()
        self.iters = iters
        self.lookup = lookup
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(self.hidden_dim + self.context_dim, "batch")
        self.update_block = BasicUpdateBlock(self.hidden_dim)

    def forward(self, image1, image2, flow_init: Optional[torch.Tensor] = None):
        # convolutions on PyTorch's own CUDA path, not cuDNN's (see without_cudnn)
        with without_cudnn():
            return self._forward(image1, image2, flow_init)

    def _forward(self, image1, image2, flow_init):
        B, _, H, W = image1.shape
        if H % 8 or W % 8:
            # the reference's contract (callers pad with InputPadder): at
            # H=436 the stride-2 encoder gives 55 rows against 54 of the
            # H//8 coords grid
            raise ValueError(f"RAFT requires H, W divisible by 8 (got {H}x{W}); "
                             "pad with vst_torch.ops.image.InputPadder first")
        image1 = 2.0 * (image1 / 255.0) - 1.0
        image2 = 2.0 * (image2 / 255.0) - 1.0

        fmap1, fmap2 = self.fnet(torch.cat([image1, image2], 0)).chunk(2, 0)
        pyramid = build_pyramid(fmap1, fmap2, self.corr_levels)

        net, inp = torch.split(self.cnet(image1), [self.hidden_dim, self.context_dim], 1)
        net = torch.tanh(net)
        inp = F.relu(inp)

        coords0 = coords_grid(B, H // 8, W // 8, device=image1.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init

        for _ in range(self.iters):
            # contiguous: the update convs may hand back channel-last deltas
            coords1 = coords1.detach().contiguous()
            corr = self.lookup(pyramid, coords1, self.corr_radius)
            net, delta = self.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta

        flow_low = coords1 - coords0
        return flow_low, upsample_flow_convex(flow_low, self.update_block.mask(net))
