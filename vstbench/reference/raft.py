"""RAFT (Teed & Deng 2020, arXiv:2003.12039), the full model in test mode,
in plain PyTorch: the benchmark's reference for the evaluation's flows.

It follows the authors' code (``core/raft.py``, ``extractor.py``,
``update.py``, ``corr.py``): feature encoder with instance norm, context
encoder with batch norm on stored statistics, a 4-level all-pairs
correlation pyramid in float32, and 20 iterations of a windowed lookup
(radius 4, bilinear through ``grid_sample`` with ``align_corners=True``, the
window transposed as in the authors' ``meshgrid(dy, dx)``), the motion
encoder, the separable ConvGRU and the flow head; then the convex 8x
upsample. One departure: the mask head runs once, on the last iteration's
hidden state, because test mode returns only the last upsampled flow.

Convolutions run on PyTorch's own im2col path, not cuDNN (cuDNN's float32
kernels for the 1x5 and 5x1 GRU convs are two orders slower on an H100 with
TF32 off). Whether TF32 is on is the caller's: the benchmark keeps it off.
State-dict keys are the authors'.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from vstbench.reference import seeded

# The flow head's output conv is drawn at 0.03 of PyTorch's default bound:
# with random weights, RAFT's flows are then under a pixel or so (0.08 to
# 0.7 px mean over seeds at 128x256) and the harness's forward-backward mask
# keeps 3 % to 95 % of the pixels. At the default bound the flows are pixels
# of noise and on most seeds the mask keeps nothing, so the TCL would be 0
# whatever the program did.
FLOW_HEAD_SCALE = 0.03
HIDDEN = 128
CONTEXT = 128
LEVELS = 4
RADIUS = 4


class Norm(nn.Module):
    """``instance`` (no parameters) or ``batch`` (eval mode, stored statistics)."""

    def __init__(self, kind: str, c: int):
        super().__init__()
        self.kind = kind
        if kind == "batch":
            self.weight = nn.Parameter(torch.ones(c))
            self.bias = nn.Parameter(torch.zeros(c))
            self.register_buffer("running_mean", torch.zeros(c))
            self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.kind == "instance":
            return F.instance_norm(x, eps=1e-5)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-5)


class ResidualBlock(nn.Module):
    def __init__(self, cin, c, kind, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, c, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)
        self.norm1 = Norm(kind, c)
        self.norm2 = Norm(kind, c)
        self.downsample = None
        if stride != 1:
            self.norm3 = Norm(kind, c)
            self.downsample = nn.Sequential(nn.Conv2d(cin, c, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, out_dim, kind):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = Norm(kind, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, kind), ResidualBlock(64, 64, kind))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, kind, 2), ResidualBlock(96, 96, kind))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, kind, 2),
                                    ResidualBlock(128, 128, kind))
        self.conv2 = nn.Conv2d(128, out_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class MotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(LEVELS * (2 * RADIUS + 1) ** 2, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], 1))), flow], 1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden=HIDDEN, cin=128 + HIDDEN):
        super().__init__()
        for tag, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{tag}", nn.Conv2d(hidden + cin, hidden, k, padding=p))

    def forward(self, h, x):
        for tag in "12":
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq{tag}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(HIDDEN, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = MotionEncoder()
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(nn.Conv2d(HIDDEN, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))


def build_pyramid(fmap1, fmap2):
    B, C, H, W = fmap1.shape
    corr = torch.matmul(fmap1.reshape(B, C, H * W).transpose(1, 2), fmap2.reshape(B, C, H * W))
    corr = (corr / math.sqrt(C)).reshape(B * H * W, 1, H, W)
    pyramid = [corr]
    for _ in range(LEVELS - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def lookup(pyramid, coords, r=RADIUS):
    """The authors' ``CorrBlock.__call__``: (B, L*(2r+1)^2, H, W)."""
    B, _, H, W = coords.shape
    coords = coords.permute(0, 2, 3, 1)
    d = torch.linspace(-r, r, 2 * r + 1, device=coords.device, dtype=coords.dtype)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1).view(1, 2 * r + 1, 2 * r + 1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        h, w = corr.shape[-2:]
        c = coords.reshape(B * H * W, 1, 1, 2) / 2 ** i + delta
        grid = torch.cat([2 * c[..., :1] / (w - 1) - 1, 2 * c[..., 1:] / (h - 1) - 1], -1)
        out.append(F.grid_sample(corr, grid, align_corners=True).view(B, H, W, -1))
    return torch.cat(out, -1).permute(0, 3, 1, 2).contiguous()


def upsample_convex(flow, mask):
    N, _, H, W = flow.shape
    mask = torch.softmax(mask.view(N, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(N, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(N, 2, 8 * H, 8 * W)


@contextlib.contextmanager
def _no_cudnn():
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = before


class RAFT(nn.Module):
    def __init__(self, iters: int = 20):
        super().__init__()
        self.iters = iters
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(HIDDEN + CONTEXT, "batch")
        self.update_block = UpdateBlock()

    @torch.no_grad()
    def forward(self, image1, image2):
        """Images (B, 3, H, W) in [0, 255], H and W multiples of 8. Returns the
        upsampled flow (B, 2, H, W)."""
        with _no_cudnn():
            image1 = 2 * (image1 / 255.0) - 1.0
            image2 = 2 * (image2 / 255.0) - 1.0
            fmap1, fmap2 = self.fnet(torch.cat([image1, image2], 0)).chunk(2, 0)
            pyramid = build_pyramid(fmap1.float(), fmap2.float())
            net, inp = torch.split(self.cnet(image1), [HIDDEN, CONTEXT], 1)
            net, inp = torch.tanh(net), F.relu(inp)
            B, _, H, W = image1.shape
            ys, xs = torch.meshgrid(torch.arange(H // 8, device=image1.device),
                                    torch.arange(W // 8, device=image1.device), indexing="ij")
            coords0 = torch.stack([xs, ys], 0).float()[None].repeat(B, 1, 1, 1)
            coords1 = coords0.clone()
            ub = self.update_block
            for _ in range(self.iters):
                corr = lookup(pyramid, coords1)
                flow = coords1 - coords0
                net = ub.gru(net, torch.cat([inp, ub.encoder(flow, corr)], 1))
                coords1 = coords1 + ub.flow_head(net)
            return upsample_convex(coords1 - coords0, 0.25 * ub.mask(net))


def init_rule(net: RAFT):
    """The authors' init: the encoders' conv weights kaiming-normal (fan out,
    ReLU), norms 1 and 0, stored statistics 0 and 1; every other conv
    PyTorch's default, the flow head's output conv at ``FLOW_HEAD_SCALE`` of it."""
    weights = dict(net.state_dict(keep_vars=True))

    def rule(name, t):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("running_mean",):
            return ("const", 0.0)
        if leaf == "running_var":
            return ("const", 1.0)
        if t.dim() == 1 and name.rsplit(".", 1)[0] + ".running_mean" in weights:
            return ("const", 1.0 if leaf == "weight" else 0.0)
        if name.startswith(("fnet.", "cnet.")) and leaf == "weight" and t.dim() == 4:
            fan_out = t.shape[0] * t.shape[2] * t.shape[3]
            return ("normal", 0.0, math.sqrt(2.0 / fan_out))
        kind, bound = seeded.torch_default(name, t, weights)
        if name.startswith("update_block.flow_head.conv2."):
            bound *= FLOW_HEAD_SCALE
        return kind, bound

    return rule


def make(iters: int, generator: torch.Generator) -> RAFT:
    """The reference RAFT on the generator's device, weights from it."""
    net = seeded.build(lambda: RAFT(iters), generator.device)
    return seeded.fill(net, generator, init_rule(net)).eval()
