"""RAFT optical flow (full and small variants), NCHW, port of
``vst/flow/raft.py`` (``utils/raft/raft/``).

Full: feature encoder (instance norm) + context encoder (batch norm, stored
statistics; the batch's once :meth:`RAFT.unfreeze_bn` and in training mode)
→ 4-level all-pairs correlation pyramid → a Python loop of GRU iterations:
windowed corr lookup (the Hopper kernel's wrapper, radius 4) →
motion encoder → SepConvGRU (on CUDA in float32 outside autograd, two fused
kernels a pass, ``vst_torch.kernels.sepconv_gru``) → flow head; after the
loop, the upsample-mask head and the convex 8× upsample of the
1/8-resolution flow. Small
(``small=True``): bottleneck encoders (instance norm / none), radius 3, the
small motion encoder, a 3×3 ConvGRU, and the bilinear ``upflow8`` in place
of the mask head. Module names are the reference's, so its ``state_dict``
keys are what ``raft_params_from_torch`` reads.

``train_mode=True`` returns every iteration's upsampled flow, shaped
(iters, B, 2, H, W), for the sequence loss (``raft.py:121-144``): the full
net applies its one mask head to each iteration's hidden state, the small
net ``upflow8``. Gradients flow through the whole loop; the coordinates are
detached at the top of each iteration, as in the reference, so the lookup
needs the gradient of its correlation maps only.

``encoder_dtype`` / ``update_dtype`` (bfloat16) are vst's compute dtypes
(``vst/flow/raft.py:395-399``): the encoders' convolutions, or the update
block's, run in that dtype on float32 parameters; norms, the correlation
volume and its lookup, the hidden-state update, the delta and mask output
convs and the coordinates stay float32. ``torch.autocast`` would not do:
it would also send ``build_pyramid``'s matmul to bf16. A net in float64
(``.double()``, float64 images; the parity tests' gradient checks) keeps
float64 wherever the float32 parts would be; give it ``lookup=
lookup_pyramid``, since the kernel's wrapper takes float32 only.

While a profiler runs, ``forward`` records the span ``vst.raft.call`` and
inside it ``vst.raft.encode`` (both encoders), ``vst.raft.corr`` (the
pyramid) and ``vst.raft.update`` (the loop with its lookups and the
upsample), and inside that ``vst.raft.gru`` (each SepConvGRU call;
``vst_torch.core.trace``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vst_torch.core.trace import span
from vst_torch.flow.corr import build_pyramid
from vst_torch.kernels.corr_lookup import corr_lookup
from vst_torch.kernels.sepconv_gru import half_step_plain, records_grad, sepconv_gru
from vst_torch.nn.conv import TorchConv, cudnn_enabled
from vst_torch.nn.init import kaiming_normal_fan_out_
from vst_torch.nn.norm import instance_norm


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in its accumulation dtype: float32, or float64 for a float64 x."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class _Norm(nn.Module):
    """RAFT's norms (``extractor.py:16-38``): 'instance' (InstanceNorm2d
    without affine, so no keys), 'batch', 'group' (affine) or 'none'.

    'batch' normalises with the stored statistics unless it is unfrozen
    (``frozen = False``, :meth:`RAFT.unfreeze_bn`) and in training mode:
    then, as ``nn.BatchNorm2d`` in training, with the batch's per-channel
    mean and biased variance over (B, H, W), updating the stored ones by
    momentum 0.1 with the unbiased variance. The statistics are taken in the
    accumulation dtype (float32, float64 for a float64 input)."""

    MOMENTUM = 0.1

    def __init__(self, norm_fn: str, channels: int, num_groups: int = 8):
        super().__init__()
        if norm_fn not in ("instance", "batch", "group", "none"):
            raise ValueError(norm_fn)
        self.norm_fn = norm_fn
        self.num_groups = num_groups
        self.frozen = True
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
        if self.norm_fn == "batch" and self.training and not self.frozen:
            return F.batch_norm(_acc(x), self.running_mean, self.running_var, self.weight,
                                self.bias, training=True, momentum=self.MOMENTUM, eps=1e-5)
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


class BottleneckBlock(nn.Module):
    """``extractor.py:60-116`` (the small encoders): 1×1 → 3×3 (strided) →
    1×1 convolutions; with stride ≠ 1 the shortcut is ``downsample =
    Sequential(conv1×1, norm4)``, norm4 registered twice as in the reference."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        ng = planes // 8
        self.conv1 = TorchConv(in_planes, planes // 4, 1, compute_dtype=dtype)
        self.conv2 = TorchConv(planes // 4, planes // 4, 3, stride=stride, padding=1,
                               compute_dtype=dtype)
        self.conv3 = TorchConv(planes // 4, planes, 1, compute_dtype=dtype)
        self.norm1 = _Norm(norm_fn, planes // 4, ng)
        self.norm2 = _Norm(norm_fn, planes // 4, ng)
        self.norm3 = _Norm(norm_fn, planes, ng)
        self.downsample = None
        if stride != 1:
            self.norm4 = _Norm(norm_fn, planes, ng)
            self.downsample = nn.Sequential(
                TorchConv(in_planes, planes, 1, stride=stride, compute_dtype=dtype), self.norm4)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """``extractor.py:118-192``: conv 7×7 s2 → residual stages (64, 96, 128)
    → 1×1 output conv. Convolutions in ``dtype``; the instance norm computes
    in float32 and returns its input's dtype, the batch norm's float32
    statistics promote to float32 (as vst's ``_Norm``). ``block`` and
    ``dims`` ((in, out, stride) a stage) make it :class:`SmallEncoder`."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dtype: Optional[torch.dtype] = None, block=ResidualBlock,
                 dims=((64, 64, 1), (64, 96, 2), (96, 128, 2))):
        super().__init__()
        self.conv1 = TorchConv(3, dims[0][0], 7, stride=2, padding=3, compute_dtype=dtype)
        self.norm1 = _Norm(norm_fn, dims[0][0], 8)
        for i, (cin, dim, stride) in enumerate(dims, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                block(cin, dim, norm_fn, stride, dtype), block(dim, dim, norm_fn, 1, dtype)))
        self.conv2 = TorchConv(dims[-1][1], output_dim, 1, compute_dtype=dtype)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_fan_out_(m.weight)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class SmallEncoder(BasicEncoder):
    """``extractor.py:195-267``: conv 7×7 s2 → bottleneck stages (32, 64, 96)
    → 1×1 output conv."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dtype: Optional[torch.dtype] = None):
        super().__init__(output_dim, norm_fn, dtype, block=BottleneckBlock,
                         dims=((32, 32, 1), (32, 64, 2), (64, 96, 2)))


class FlowHead(nn.Module):
    """``update.py:6-14``; the delta output conv in float32."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = TorchConv(input_dim, hidden_dim, 3, padding=1, compute_dtype=dtype)
        self.conv2 = TorchConv(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(_acc(F.relu(self.conv1(x))))


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


class SmallMotionEncoder(nn.Module):
    """``update.py:62-77``: corr → 96; flow → 64 → 32; fused → 80,
    concatenated with the flow."""

    def __init__(self, cor_planes: int = 4 * 7 * 7):
        super().__init__()
        self.convc1 = TorchConv(cor_planes, 96, 1)
        self.convf1 = TorchConv(2, 64, 7, padding=3)
        self.convf2 = TorchConv(64, 32, 3, padding=1)
        self.conv = TorchConv(128, 80, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow], 1)


class ConvGRU(nn.Module):
    """``update.py:16-31``: one 3×3 GRU pass (the small update block)."""

    def __init__(self, hidden_dim: int = 96, input_dim: int = 82 + 64):
        super().__init__()
        self.convz = TorchConv(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convr = TorchConv(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convq = TorchConv(hidden_dim + input_dim, hidden_dim, 3, padding=1)

    def forward(self, h, x):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    """``update.py:33-60``: a horizontal (1×5) then a vertical (5×1) GRU pass.
    The gates compute in ``dtype``; the hidden state h stays float32
    (``vst/flow/raft.py:216-232``).

    With the gates in float32 and autograd not recording
    (:meth:`half_step`), each pass is ``vst_torch.kernels.sepconv_gru``: its
    two fused kernels on CUDA, ``half_step_plain`` on the CPU; otherwise
    (training, the bfloat16 update block) it is ``half_step_plain``. While a
    profiler runs, ``forward`` records the span ``vst.raft.gru``."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        cin = hidden_dim + input_dim
        for tag, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{tag}",
                        TorchConv(cin, hidden_dim, ks, padding=pad, compute_dtype=dtype))

    def _convs(self, tag: str):
        return [getattr(self, f"conv{gate}{tag}") for gate in ("z", "r", "q")]

    def half_step(self, h: torch.Tensor, x: torch.Tensor) -> Callable:
        """The half-step ``forward(h, x)`` runs: the kernels' wrapper
        ``sepconv_gru`` for gates in float32 (``dtype`` None) with autograd
        not recording (grad disabled, or neither input nor any parameter
        requires grad), else ``half_step_plain``."""
        if self.dtype is None and not records_grad(h, x, *self.parameters()):
            return sepconv_gru
        return half_step_plain

    def forward(self, h, x):
        with span("vst.raft.gru"):
            step = self.half_step(h, x)
            for tag in ("1", "2"):
                h = step(h, x, *self._convs(tag))
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
        return 0.25 * self[2](_acc(self[1](self[0](net))))


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


class SmallUpdateBlock(nn.Module):
    """``update.py:99-112``: motion encoder, ConvGRU and flow head; no mask
    head (the small net upsamples with :func:`upflow8`)."""

    def __init__(self, hidden_dim: int = 96):
        super().__init__()
        self.encoder = SmallMotionEncoder()
        self.gru = ConvGRU(hidden_dim, input_dim=82 + 64)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=128)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, self.flow_head(net)


def coords_grid(batch: int, ht: int, wd: int, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, 2, ht, wd) pixel grid, channel 0 = x (``utils.py:74-77``)."""
    ys, xs = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                            torch.arange(wd, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], 0)[None].repeat(batch, 1, 1, 1)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8× bilinear upsample (align_corners=True) of a (B, 2, H, W) flow, its
    vectors ×8 (``utils.py:80-82``)."""
    H, W = flow.shape[-2:]
    return 8.0 * F.interpolate(flow, size=(8 * H, 8 * W), mode="bilinear", align_corners=True)


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
# (PERF.md §6, the bring-up's measurements). float32 stays off
# cuDNN, which with TF32 off ran the update block 70-99x slower; bfloat16
# takes it, 1.6x faster for fnet and cnet and 2.3x for the update block.
ON_CUDNN = {torch.float32: False, torch.bfloat16: True}


class RAFT(nn.Module):
    """RAFT (``raft.py:24-144``), full or ``small``. Images (B, 3, H, W), RGB
    in [0, 255], H and W multiples of 8 (pad with ``InputPadder``). Returns
    float32 (flow_low, flow_up) as the reference's test mode, or with
    ``train_mode`` (flow_low, flow_preds), flow_preds (iters, B, 2, H, W)
    every iteration's upsampled flow.

    ``lookup`` is the per-iteration window lookup: the Hopper kernel's
    wrapper by default (the plain version for CPU tensors); passing
    ``vst_torch.flow.corr.lookup_pyramid`` runs the plain version on any
    device, which is how the kernel is checked end to end.
    ``encoder_dtype`` / ``update_dtype``: the compute dtype (None or
    ``torch.bfloat16``) of the fnet and cnet convolutions and of the update
    block's; the parameters are the same in every dtype. The small update
    block has no compute dtype, as vst's: it runs float32 and
    ``update_dtype`` is not read. ``ON_CUDNN`` says, per dtype, whether the
    convolutions run on cuDNN.
    """

    corr_levels = 4

    def __init__(self, iters: int = 12, lookup: Callable = corr_lookup,
                 encoder_dtype: Optional[torch.dtype] = None,
                 update_dtype: Optional[torch.dtype] = None,
                 small: bool = False, train_mode: bool = False):
        super().__init__()
        self.iters = iters
        self.lookup = lookup
        self.small = small
        self.train_mode = train_mode
        self.encoder_dtype = encoder_dtype or torch.float32
        if small:
            self.update_dtype = torch.float32
            self.hidden_dim, self.context_dim, self.corr_radius = 96, 64, 3
            self.fnet = SmallEncoder(128, "instance", dtype=encoder_dtype)
            self.cnet = SmallEncoder(self.hidden_dim + self.context_dim, "none",
                                     dtype=encoder_dtype)
            self.update_block = SmallUpdateBlock(self.hidden_dim)
        else:
            self.update_dtype = update_dtype or torch.float32
            self.hidden_dim, self.context_dim, self.corr_radius = 128, 128, 4
            self.fnet = BasicEncoder(256, "instance", dtype=encoder_dtype)
            self.cnet = BasicEncoder(self.hidden_dim + self.context_dim, "batch",
                                     dtype=encoder_dtype)
            self.update_block = BasicUpdateBlock(self.hidden_dim, dtype=update_dtype)

    def forward(self, image1, image2, flow_init: Optional[torch.Tensor] = None):
        B, _, H, W = image1.shape
        if H % 8 or W % 8:
            # the reference's contract (callers pad with InputPadder): at
            # H=436 the stride-2 encoder gives 55 rows against 54 of the
            # H//8 coords grid
            raise ValueError(f"RAFT requires H, W divisible by 8 (got {H}x{W}); "
                             "pad with vst_torch.ops.image.InputPadder first")
        with span("vst.raft.call"):
            image1 = 2.0 * (image1 / 255.0) - 1.0
            image2 = 2.0 * (image2 / 255.0) - 1.0

            with span("vst.raft.encode"), cudnn_enabled(ON_CUDNN[self.encoder_dtype]):
                # the correlation volume and the GRU run float32 (vst/flow/raft.py:423-428)
                fmap1, fmap2 = _acc(self.fnet(torch.cat([image1, image2], 0))).chunk(2, 0)
                cnet = _acc(self.cnet(image1))
            with span("vst.raft.corr"):
                pyramid = build_pyramid(fmap1, fmap2, self.corr_levels)
            net, inp = torch.split(cnet, [self.hidden_dim, self.context_dim], 1)
            net = torch.tanh(net)
            inp = F.relu(inp)

            coords0 = coords_grid(B, H // 8, W // 8, device=image1.device, dtype=cnet.dtype)
            coords1 = coords0.clone()
            if flow_init is not None:
                coords1 = coords1 + flow_init

            with span("vst.raft.update"), cudnn_enabled(ON_CUDNN[self.update_dtype]):
                steps = []  # (coords1, net) of each iteration, for train_mode
                for _ in range(self.iters):
                    # contiguous: the update convs may hand back channel-last deltas
                    coords1 = coords1.detach().contiguous()
                    corr = self.lookup(pyramid, coords1, self.corr_radius)
                    net, delta = self.update_block(net, inp, corr, coords1 - coords0)
                    coords1 = coords1 + delta.to(coords1.dtype)
                    if self.train_mode:
                        steps.append((coords1, net))
                if not self.train_mode:
                    steps = [(coords1, net)]
                ups = [self._upsample(c1 - coords0, h) for c1, h in steps]

            flow_low = coords1 - coords0
            return flow_low, torch.stack(ups) if self.train_mode else ups[0]

    def unfreeze_bn(self) -> "RAFT":
        """Let the context encoder's batch norms take the batch's statistics
        while the net is in training mode, as upstream trains at the chairs
        stage (``train.py`` calls ``freeze_bn()`` only after it). A net is
        built frozen: stored statistics in every mode."""
        for m in self.modules():
            if isinstance(m, _Norm):
                m.frozen = False
        return self

    def _upsample(self, flow: torch.Tensor, net: torch.Tensor) -> torch.Tensor:
        """The 1/8 flow at full size: ``upflow8`` (small) or the convex
        upsample with the mask head applied to ``net``."""
        if self.small:
            return upflow8(flow)
        return upsample_flow_convex(flow, self.update_block.mask(net))
