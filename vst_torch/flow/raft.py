"""RAFT optical flow (full variant), NCHW, port of ``vst/flow/raft.py``
(``utils/raft/raft/``).

Feature encoder (instance norm) + context encoder (batch norm, eval
statistics) → 4-level all-pairs correlation pyramid → a Python loop of GRU
iterations: windowed corr lookup (the Hopper kernel's wrapper) → motion
encoder → SepConvGRU → flow head; after the loop, the upsample-mask head
and the convex 8× upsample of the 1/8-resolution flow. Module names are the
reference's, so its ``state_dict`` keys are what ``raft_params_from_torch``
reads.

``encoder_dtype`` / ``update_dtype`` (bfloat16) are vst's compute dtypes
(``vst/flow/raft.py:395-399``): the encoders' convolutions, or the update
block's, run in that dtype on float32 parameters; norms, the correlation
volume and its lookup, the hidden-state update, the delta and mask output
convs and the coordinates stay float32. ``torch.autocast`` would not do:
it would also send ``build_pyramid``'s matmul to bf16.

Not ported yet: the small variant and ``train_mode`` (per-iteration flows).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vst_torch.flow.corr import build_pyramid
from vst_torch.kernels.corr_lookup import corr_lookup
from vst_torch.nn.conv import TorchConv, cudnn_enabled
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
                 stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        ng = planes // 8
        self.conv1 = TorchConv(in_planes, planes, 3, stride=stride, padding=1,
                               compute_dtype=dtype)
        self.conv2 = TorchConv(planes, planes, 3, padding=1, compute_dtype=dtype)
        self.norm1 = _Norm(norm_fn, planes, ng)
        self.norm2 = _Norm(norm_fn, planes, ng)
        self.downsample = None
        if stride != 1:
            self.norm3 = _Norm(norm_fn, planes, ng)
            self.downsample = nn.Sequential(
                TorchConv(in_planes, planes, 1, stride=stride, compute_dtype=dtype), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """``extractor.py:118-192``: conv 7×7 s2 → residual stages (64, 96, 128)
    → 1×1 output conv. Convolutions in ``dtype``; the instance norm computes
    in float32 and returns its input's dtype, the batch norm's float32
    statistics promote to float32 (as vst's ``_Norm``)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = TorchConv(3, 64, 7, stride=2, padding=3, compute_dtype=dtype)
        self.norm1 = _Norm(norm_fn, 64, 8)
        dims = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
        for i, (cin, dim, stride) in enumerate(dims, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride, dtype),
                ResidualBlock(dim, dim, norm_fn, 1, dtype)))
        self.conv2 = TorchConv(128, output_dim, 1, compute_dtype=dtype)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_fan_out_(m.weight)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class FlowHead(nn.Module):
    """``update.py:6-14``; the delta output conv in float32."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = TorchConv(input_dim, hidden_dim, 3, padding=1, compute_dtype=dtype)
        self.conv2 = TorchConv(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)).float())


class BasicMotionEncoder(nn.Module):
    """``update.py:79-97``: corr → 256 → 192; flow → 128 → 64; fused → 126,
    concatenated with the flow."""

    def __init__(self, cor_planes: int = 4 * 9 * 9, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convc1 = TorchConv(cor_planes, 256, 1, compute_dtype=dtype)
        self.convc2 = TorchConv(256, 192, 3, padding=1, compute_dtype=dtype)
        self.convf1 = TorchConv(2, 128, 7, padding=3, compute_dtype=dtype)
        self.convf2 = TorchConv(128, 64, 3, padding=1, compute_dtype=dtype)
        self.conv = TorchConv(64 + 192, 128 - 2, 3, padding=1, compute_dtype=dtype)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow.to(out.dtype)], 1)


class SepConvGRU(nn.Module):
    """``update.py:33-60``: a horizontal (1×5) then a vertical (5×1) GRU pass.
    The gates compute in ``dtype``; the hidden state h stays float32
    (``vst/flow/raft.py:216-232``)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cin = hidden_dim + input_dim
        for tag, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{tag}",
                        TorchConv(cin, hidden_dim, ks, padding=pad, compute_dtype=dtype))

    def forward(self, h, x):
        for tag in ("1", "2"):
            hx = torch.cat([h.to(x.dtype), x], 1)
            z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq{tag}")(torch.cat([r * h.to(r.dtype), x], 1)))
            h = (1 - z.float()) * h + z.float() * q.float()
        return h


class UpMaskHead(nn.Sequential):
    """``update.py:119-123``: the convex-upsample mask logits, ×0.25. Kept
    under ``update_block.mask`` as in the reference, but applied once after
    the GRU loop: evaluation reads only the last iteration's mask. The first
    conv in ``dtype``, the output conv in float32."""

    def __init__(self, hidden_dim: int = 128, dtype: Optional[torch.dtype] = None):
        super().__init__(TorchConv(hidden_dim, 256, 3, padding=1, compute_dtype=dtype),
                         nn.ReLU(), TorchConv(256, 64 * 9, 1))

    def forward(self, net):
        return 0.25 * self[2](self[1](self[0](net)).float())


class BasicUpdateBlock(nn.Module):
    """``update.py:114-136``: motion encoder, GRU and flow head; the mask
    head lives here for the key names and runs from :class:`RAFT`."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 128,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = BasicMotionEncoder(dtype=dtype)
        self.gru = SepConvGRU(hidden_dim, input_dim=128 + hidden_dim, dtype=dtype)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256, dtype=dtype)
        self.mask = UpMaskHead(hidden_dim, dtype=dtype)

    def forward(self, net, inp, corr, flow):
        if self.dtype is not None:  # vst/flow/raft.py:265-272
            inp, corr, flow = inp.to(self.dtype), corr.to(self.dtype), flow.to(self.dtype)
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


# Whether RAFT's convolutions of a compute dtype run on cuDNN (True) or on
# PyTorch's own im2col + cuBLAS path (False), on CUDA: the faster on an H100
# (chip_smoke.py's raft and raft_bf16 phases, PERF.md). float32 stays off
# cuDNN, which with TF32 off ran the update block 70-99x slower; bfloat16
# takes it, 1.6x faster for fnet and cnet and 2.3x for the update block.
ON_CUDNN = {torch.float32: False, torch.bfloat16: True}


class RAFT(nn.Module):
    """Full RAFT (``raft.py:24-144``). Images (B, 3, H, W), RGB in [0, 255],
    H and W multiples of 8 (pad with ``InputPadder``). Returns float32
    (flow_low, flow_up) as the reference's test mode.

    ``lookup`` is the per-iteration window lookup: the Hopper kernel's
    wrapper by default (the plain version for CPU tensors); passing
    ``vst_torch.flow.corr.lookup_pyramid`` runs the plain version on any
    device, which is how the kernel is checked end to end.
    ``encoder_dtype`` / ``update_dtype``: the compute dtype (None or
    ``torch.bfloat16``) of the fnet and cnet convolutions and of the update
    block's; the parameters are the same in every dtype. ``ON_CUDNN`` says,
    per dtype, whether the convolutions run on cuDNN.
    """

    hidden_dim = 128
    context_dim = 128
    corr_levels = 4
    corr_radius = 4

    def __init__(self, iters: int = 12, lookup: Callable = corr_lookup,
                 encoder_dtype: Optional[torch.dtype] = None,
                 update_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.iters = iters
        self.lookup = lookup
        self.encoder_dtype = encoder_dtype or torch.float32
        self.update_dtype = update_dtype or torch.float32
        self.fnet = BasicEncoder(256, "instance", dtype=encoder_dtype)
        self.cnet = BasicEncoder(self.hidden_dim + self.context_dim, "batch", dtype=encoder_dtype)
        self.update_block = BasicUpdateBlock(self.hidden_dim, dtype=update_dtype)

    def forward(self, image1, image2, flow_init: Optional[torch.Tensor] = None):
        B, _, H, W = image1.shape
        if H % 8 or W % 8:
            # the reference's contract (callers pad with InputPadder): at
            # H=436 the stride-2 encoder gives 55 rows against 54 of the
            # H//8 coords grid
            raise ValueError(f"RAFT requires H, W divisible by 8 (got {H}x{W}); "
                             "pad with vst_torch.ops.image.InputPadder first")
        image1 = 2.0 * (image1 / 255.0) - 1.0
        image2 = 2.0 * (image2 / 255.0) - 1.0

        with cudnn_enabled(ON_CUDNN[self.encoder_dtype]):
            # the correlation volume and the GRU run float32 (vst/flow/raft.py:423-428)
            fmap1, fmap2 = self.fnet(torch.cat([image1, image2], 0)).float().chunk(2, 0)
            cnet = self.cnet(image1).float()
        pyramid = build_pyramid(fmap1, fmap2, self.corr_levels)
        net, inp = torch.split(cnet, [self.hidden_dim, self.context_dim], 1)
        net = torch.tanh(net)
        inp = F.relu(inp)

        coords0 = coords_grid(B, H // 8, W // 8, device=image1.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init

        with cudnn_enabled(ON_CUDNN[self.update_dtype]):
            for _ in range(self.iters):
                # contiguous: the update convs may hand back channel-last deltas
                coords1 = coords1.detach().contiguous()
                corr = self.lookup(pyramid, coords1, self.corr_radius)
                net, delta = self.update_block(net, inp, corr, coords1 - coords0)
                coords1 = coords1 + delta.float()
            mask = self.update_block.mask(net)

        flow_low = coords1 - coords0
        return flow_low, upsample_flow_convex(flow_low, mask)
