"""Operation counts of the datagen, RAFT-training and demo paths, for predictions
written before a chip run: ``torch.utils.flop_counter`` over the port's own
modules on the meta device (no data, no device; convolutions and matrix
products only, two operations a multiply-add).

    python -m vst_torch.probes.flop_counts

Prints one JSON line of GFLOP: RAFT (full) forward at 4×3×256² with 20
iterations (the CycleGAN trainers' call, whose time PERF.md has) and at
1×3×432×1024 (``precompute_lt_flow``'s call); ``RAFT(train_mode=True)`` at
RAFT's chairs stage, 10×3×368×496 with 12 iterations, forward and forward +
backward; RAFT small at 4×3×432×1024 with 12 iterations; one OBST closure
(the caffe VGG19 to r42, forward and the image's gradient) at 16×3×256² and
at the Sintel frame 1×3×436×1024, and one OBST batch at 256² (16 images,
``datagen-corpus``'s [30, 25, 20] run as 40 closure calls a level); the
FAN forward at 1×3×256² and 8×3×256²; StarGAN v2's generator with
``w_hpf = 1`` and the FAN's masks at 8×3×256²; Huang's FastStyleNet (3
styles) at 1×3×436×1024, the demos' frame.
"""

from __future__ import annotations

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from vst_torch.flow.corr import lookup_pyramid
from vst_torch.flow.datasets import flow_sequence_loss
from vst_torch.flow.raft import RAFT
from vst_torch.models.faststyle import FastStyleNet
from vst_torch.models.stargan2 import Generator
from vst_torch.models.wing import FAN
from vst_torch.ops.lbfgs import torch_eval_counts
from vst_torch.perceptual.vgg import CaffeVGG

META = torch.device("meta")
KEYS = ["r21", "r31", "r41", "r42"]


def gflop(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops() / 1e9


def raft_forward(B, H, W, iters, small=False, train=False, backward=False) -> float:
    net = RAFT(iters=iters, lookup=lookup_pyramid, small=small, train_mode=train).to(META)
    i1 = torch.empty(B, 3, H, W, device=META)

    def run():
        with torch.set_grad_enabled(backward):
            _, up = net(i1, i1)
            if backward:
                gt = torch.empty(B, 2, H, W, device=META)
                flow_sequence_loss(up, gt, torch.empty(B, H, W, device=META)).backward()

    return gflop(run)


def obst_closure(B, H, W) -> float:
    vgg = CaffeVGG().to(META).requires_grad_(False)
    x = torch.empty(B, 3, H, W, device=META, requires_grad=True)

    def run():
        feats = vgg(x, KEYS)
        sum(f.sum() for f in feats).backward()

    return gflop(run)


def net_forward(net, *shapes) -> float:
    """GFLOP of one forward of ``net`` on meta tensors of ``shapes``."""
    net = net.to(META)
    args = [torch.empty(*s, device=META) for s in shapes]
    return gflop(lambda: net(*args))


def hpf_generator(B, size) -> float:
    g = Generator(size, 64, 512, w_hpf=1).to(META)
    x, s = torch.empty(B, 3, size, size, device=META), torch.empty(B, 64, device=META)
    masks = [torch.empty(B, 1, size, size, device=META)] * 2
    return gflop(lambda: g(x, s, masks))


def main() -> dict:
    pyr = ((64, 64), (128, 128), (256, 256))
    calls = torch_eval_counts((30, 25, 20))
    out = {
        "raft_fwd_4x256x256_it20": raft_forward(4, 256, 256, 20),
        "raft_fwd_1x432x1024_it20": raft_forward(1, 432, 1024, 20),
        "raft_train_fwd_10x368x496_it12": raft_forward(10, 368, 496, 12, train=True),
        "raft_train_fwd_bwd_10x368x496_it12": raft_forward(10, 368, 496, 12, train=True,
                                                           backward=True),
        "raft_small_fwd_4x432x1024_it12": raft_forward(4, 432, 1024, 12, small=True),
        "obst_closure_16x256x256": obst_closure(16, 256, 256),
        "obst_closure_1x436x1024": obst_closure(1, 436, 1024),
        "obst_batch_16x256x256": sum(n * obst_closure(16, h, w) for n, (h, w) in zip(calls, pyr)),
        "obst_closure_calls_30_25_20": list(calls),
        "fan_fwd_1x256x256": net_forward(FAN(), (1, 3, 256, 256)),
        "fan_fwd_8x256x256": net_forward(FAN(), (8, 3, 256, 256)),
        "stargan2_g_hpf_fwd_8x256x256": hpf_generator(8, 256),
        "faststyle_fwd_1x436x1024": net_forward(FastStyleNet(n_styles=3), (1, 3, 436, 1024)),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
