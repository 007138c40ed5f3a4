#!/usr/bin/env python3
"""Drive the vst_torch port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py    # from the repository root

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. build: compile the three kernels (vst_torch/csrc/{corr_lookup,
   pad_conv3x3,gemm_rate}.cu), one nvcc each, all at once, into
   vst_torch/_build/; ptxas registers and spills per library.
2. kernel: corr_lookup against its plain version lookup_pyramid, bit for
   bit (max |Δ| = 0), at the Sintel tcl2 shape, a ragged shape, the
   CPU-test shape, radius 3, 1 and 2 levels, and windows all outside their
   maps; its time beside the plain version's, the library yardstick's (the
   reference CorrBlock's F.grid_sample per level), its bound and the bytes
   of the 32-byte sectors its windows touch, its device time alone
   (device_ms, a CUDA graph of calls each reading more than L2 holds) and
   the host's time to issue a call (host_ms); the autograd.Function's
   gradient against the plain version's (≤ 1e-5).
3. stylize: FastStyleNet (3 styles) at 1×3×436×1024, chained DT.
4. raft: full RAFT, 20 iterations, at 4×3×432×1024 through the kernel;
   a breakdown by part (and the update block on cuDNN, which RAFT avoids);
   flow at 2×3×64×96 against the same net with the plain lookup (≤ 1e-3 px).
5. main_path: evaluate_sintel_faststyle on a seeded synthetic 8-frame clip
   at 432×1024, styles (0, 1, 2), RAFT through the kernel; first the same
   harness at 64×96 against the plain lookup (TCL ≤ 1e-4 relative).
6. eval_sintel: `vst_torch.cli eval-sintel` at 436×1024 for johnson and
   ruder (the synthetic clip with its flow oracle, 3 styles); then
   evaluate_sintel_ruder with RAFT (20 iterations, through the kernel) on
   the 8-frame 432×1024 clip, after the same driver at 64×96 against the
   plain lookup (TCL ≤ 1e-4 relative, every value positive).
7. raft_bf16: RAFT's bf16 encoders and update block timed on cuDNN and on
   PyTorch's own path at 4×3×432×1024; `vst_torch.cli bench-raft` with all
   five variants at 436×1024 (its windows of 5); per bf16 variant, one pair
   through the kernel against the same net with the plain lookup, bit for
   bit (max |Δ| = 0); per variant, the pair's eager time beside its device
   time alone (a CUDA graph) and the host's time to issue it.
8. stylize_video: `vst_torch.cli stylize-video` at 436×1024 on 24 synthetic
   frames, f32 at batch 1 and bf16 at batch 8: 24 PNGs each, frames/s; its
   timed loop 5 times more, with the net and with the copies alone, and the
   net's device time per frame.
9. trunk_conv: pad_conv3x3 (modes full and mxu_only) against its plain
   version at the trunk shape 1×109×256×128, a ragged 2×13×37×64, the
   CPU-test shapes, C_in ≠ C_out, C_out = 8 and 136, batch 3 and H = 2, f32
   (≤ 1e-4 absolute) and bf16 (≤ 1e-3 + 2⁻⁷·|plain|); then the probe
   vst_torch.probes.bisect_im2col: ms/conv over a host-launched 10-conv
   chain, the device time alone (device_ms, a CUDA graph over inputs cold
   in L2), the host's time to issue a call (host_ms), plain, cuDNN and
   bound.
10. kernel_cost: shift_only and dma_only against their plain versions at
   the same ten shapes, bit for bit (max |Δ| = 0: the same f32 sums in the
   same order, one rounding), then the probe
   vst_torch.probes.bisect_kernel_cost, the four modes timed as in phase 6,
   each beside one library call that computes it.
11. gemm_rate: the kernel against its plain version at every (K, N) of the
   sweep (f32 ≤ 1e-5·max|y|, bf16 ≤ 2⁻⁷·max|y|), then the probe
   vst_torch.probes.bisect_mxu: ms, TF/s, bound, one cuBLAS call of depth
   64·K (library_ms) and 64 × cuBLAS (library_x64_ms); the kernels line
   lists K = N = 128 and K = 1152, N = 128, each with its own max |Δ| and
   the launches of its timing.
12. bench: vst_torch.bench on f32_b1, bf16_b1 and bf16_b8 (eager chain and
   CUDA-graph chain), and `vst_torch.cli bench-raft` on its f32 variant.
13. train_faststyle: one step of each method at 64×64, batch 2, on the card
   against the CPU from the same weights (loss and terms in f32 ≤ 1e-4
   relative, every gradient in f64 ≤ 1e-3 relative in L2; the f32
   gradients' difference recorded); VGG16 and FastStyleNet forward and
   backward at 16×3×256×256 on cuDNN and on PyTorch's own convolutions;
   `vst_torch.cli train-faststyle` for each method at 256², batch 16, 20
   steps from the device cache over a 64-sample FC2-layout corpus written to
   a temporary directory (device step by CUDA events, median after 3
   warm-up steps; images/s; peak memory; every loss finite); Johnson on one
   fixed batch for 30 steps, its last loss below its first, then 2 steps
   under torch.profiler (device busy share, top kernels); Johnson on
   synthetic host batches, the host's batch time beside the step time. The
   training path launches none of the kernels: their counts stay 0.

14. obst: OBST on the card against the CPU (one level at 32×32 in float64,
   20 L-BFGS iterations, the image within 1e-8 relative; one closure's loss
   at 64×64 in float32 within 1e-5); `vst_torch.cli eval-obst` at 436×1024
   on one synthetic 6-frame clip, style 0, [50, 40, 30] (run as [60, 60,
   40]), RAFT through the kernel: λ = 0 and 2000 in float32, then λ = 2000
   with --obst-bf16 (DT of obst.run alone, RAFT ms, TCL-ST / TCL-LT, wall
   seconds and peak memory each; every value finite, TCL-ST at λ = 2000
   below λ = 0, corr_lookup launched); torch.profiler over one full-size
   obst.run in float32 and in bfloat16 (the device's busy share).
15. fc2_metrics: `vst_torch.cli eval-fc2` at 256² on 4 synthetic batches of
   4: --family obst (λ 0 and 2000), --family faststyle --method johnson
   (--num-outs 3) and --method ruder; TCL / FID / LPIPS means and the
   seconds split into the metric nets, FID's host math and the rest
   (stylizing); InceptionV3 activations and one LPIPS value on the card
   against the CPU (4 images, float32, 1e-4 relative). The FC2 paths
   launch none of the kernels.

Phases 5–15 each drive one path with the kernels' launch counts set to 0
just before it and read just after; a kernel of the path that was never
launched fails the run. Then the card's name and power limit (nvidia-smi),
the kernels line and the result line. Float32 with TF32 off. Weights and
inputs are random, from seeds. Needs one CUDA device; exits 1 without one.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from vst_torch import bench, set_f32_precision
from vst_torch.cli.__main__ import (RAFT_VARIANTS, source_frames, stylize_frames,
                                    video_stylizer)
from vst_torch.cli.__main__ import main as cli_main
from vst_torch.cli.__main__ import parser as cli_parser
from vst_torch.core.roofline import PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S
from vst_torch.core.timing import chain_ms, cold_pool, graph_ms, host_ms, windows_ms
from vst_torch.data.device_cache import DeviceFC2Cache
from vst_torch.data.loader import pack_fc2_npy
from vst_torch.data.styles import load_style_images
from vst_torch.eval.drivers import (evaluate_sintel_faststyle, evaluate_sintel_ruder,
                                    faststyle_stylize_fn)
from vst_torch.eval.sintel import SintelVideo, make_tcl_program
from vst_torch.flow.corr import build_pyramid, lookup_pyramid
from vst_torch.flow.raft import RAFT, coords_grid
from vst_torch.kernels import _nvcc
from vst_torch.kernels import corr_lookup as corr_lookup_module
from vst_torch.kernels import gemm_rate as gemm_rate_module
from vst_torch.kernels import pad_conv3x3 as pad_conv3x3_module
from vst_torch.kernels.corr_lookup import corr_lookup
from vst_torch.kernels.gemm_rate import gemm_rate, gemm_rate_plain
from vst_torch.kernels.pad_conv3x3 import MODES, dtype_name, pad_conv3x3, pad_conv3x3_plain
from vst_torch.metrics.fid import InceptionV3
from vst_torch.metrics.lpips import LPIPS
from vst_torch.eval import drivers as drivers_module
from vst_torch.eval import fc2 as fc2_module
from vst_torch.models.faststyle import FastStyleNet
from vst_torch.models.gatys import OBST, PYR_SINTEL
from vst_torch.nn.conv import cudnn_enabled
from vst_torch.ops.image import InputPadder
from vst_torch.perceptual.vgg import Vgg16Features, he_randomized_
from vst_torch.probes import bisect_im2col, bisect_kernel_cost, bisect_mxu
from vst_torch.train.faststyle import FastStyleTrainer
from vst_torch.train.parity import grad_errors, training_step
from vst_torch.train.registry import FASTSTYLE_METHODS, method_net, select_method

RADIUS = 4
LEVELS = 4
KERNEL_ERR = 0.0  # corr_lookup against lookup_pyramid: same operation order, bit for bit
GRAD_ATOL = 1e-5
FLOW_ATOL_PX = 1e-3
TCL_RTOL = 1e-4
# pad_conv3x3 against its plain version: f32 sums of up to 9·128 terms with
# |y| ~ 1 in another order; bf16 one rounding of the same f32 sum (1 ulp)
CONV_F32_ATOL = 1e-4
CONV_BF16_ATOL, CONV_BF16_RTOL = 1e-3, 2.0 ** -7
# the modes without a product take the plain version's sums in its order
CONV_EXACT_MODES = ("shift_only", "dma_only")
# gemm_rate against its plain version, relative to max|y|: f32 sums of up to
# 64·1152 terms in another order; bf16 one rounding of the f32 sum
GEMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
DTYPES = (torch.float32, torch.bfloat16)
TCL_KEYS = ("TCL-ST", "TCL-LT")
SINTEL_HW = (436, 1024)  # a Sintel frame; the eval harness crops it to 432 rows
CLIP_HW = (432, 1024)
VIDEO_FRAMES = 24
VIDEO_PASSES = 5
BF16_RAFT_VARIANTS = ("bf16_enc", "bf16_full", "bf16_full_pad64")
KERNEL_SOURCES = ("corr_lookup", "pad_conv3x3", "gemm_rate")
# f32 operations per lookup output: level scale and offset (2 per axis), floor
# fractions and complements (4), 4 corner weights, 4 products, 3 sums
OPS_PER_OUTPUT = 17
TRAIN_HW = (256, 256)  # train-faststyle at the README's size and batch
TRAIN_BATCH = 16
TRAIN_STEPS = 20
TRAIN_CORPUS = 64
LEARN_STEPS = 30
HOST_STEPS = 6
TRAIN_LOSS_RTOL = 1e-4  # card against CPU, f32
TRAIN_GRAD_RTOL = 1e-3  # card against CPU, f64, L2 per parameter
OBST_IMAGE_RTOL = 1e-8  # card against CPU, one level in f64
OBST_LOSS_RTOL = 1e-5  # card against CPU, one closure in f32
METRIC_RTOL = 1e-4  # InceptionV3 activations and LPIPS, card against CPU, f32
OBST_FRAMES = 6  # TCL-LT needs a frame past the offset of 5
FC2_HW = (256, 256)
FC2_SEED = 14


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean ms per call of fn() over ``reps`` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def corrblock_grid_sample(pyramid, coords, r):
    """The library yardstick: the reference CorrBlock's lookup
    (utils/raft/raft/corr.py:29-47), one F.grid_sample(align_corners=True)
    per level. Timed here only; the port never calls it."""
    B, _, H, W = coords.shape
    n = 2 * r + 1
    d = torch.linspace(-r, r, n, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1).view(1, n, n, 2)
    centroid = coords.permute(0, 2, 3, 1).reshape(B * H * W, 1, 1, 2)
    outs = []
    for i, corr in enumerate(pyramid):
        h, w = corr.shape[-2:]
        c = centroid / 2 ** i + delta
        grid = torch.stack([2 * c[..., 0] / (w - 1) - 1, 2 * c[..., 1] / (h - 1) - 1], -1)
        outs.append(F.grid_sample(corr, grid, align_corners=True).view(B, H, W, -1))
    return torch.cat(outs, -1).permute(0, 3, 1, 2)


def lookup_bound(pyramid, coords, r):
    """Least time for one lookup at these inputs: bytes this run's windows
    need (each in-bounds map element of every query's (2r+2)² patch read
    once, coords read once, output written once) over HBM bandwidth, and
    f32 operations over the f32 rate. Returns (bound_ms, bound_by, bytes)."""
    B, _, H, W = coords.shape
    q = B * H * W
    c = coords.permute(0, 2, 3, 1).reshape(q, 2).double()
    read = 0
    for i, corr in enumerate(pyramid):
        h, w = corr.shape[-2:]
        lo = torch.floor(c / 2 ** i) - r
        hi = lo + 2 * r + 1
        nx = (torch.minimum(hi[:, 0], torch.tensor(w - 1.0, device=c.device))
              - torch.maximum(lo[:, 0], torch.tensor(0.0, device=c.device)) + 1).clamp_min(0)
        ny = (torch.minimum(hi[:, 1], torch.tensor(h - 1.0, device=c.device))
              - torch.maximum(lo[:, 1], torch.tensor(0.0, device=c.device)) + 1).clamp_min(0)
        read += int((nx * ny).sum().item()) * 4
    outputs = q * len(pyramid) * (2 * r + 1) ** 2
    nbytes = read + q * 2 * 4 + outputs * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = outputs * OPS_PER_OUTPUT / PEAK_F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), nbytes


def lookup_sector_bytes(pyramid, coords, r):
    """Bytes of the 32-byte sectors this run's windows touch: each in-bounds
    row of every query's (2r+2)² patch, rounded out to whole sectors (each
    level's tensor starts on a 256-byte boundary), plus coords and output as
    lookup_bound counts them. A window row of 10 floats spans 2–3 sectors."""
    B, _, H, W = coords.shape
    q = B * H * W
    c = coords.permute(0, 2, 3, 1).reshape(q, 2).double()
    qidx = torch.arange(q, device=c.device, dtype=torch.float64)
    sectors = 0
    for i, corr in enumerate(pyramid):
        h, w = corr.shape[-2:]
        lo = torch.floor(c / 2 ** i) - r
        x0 = lo[:, 0].clamp_min(0)
        x1 = (lo[:, 0] + 2 * r + 1).clamp_max(w - 1)
        rows = lo[:, 1:2] + torch.arange(2 * r + 2, device=c.device, dtype=torch.float64)
        ok = (rows >= 0) & (rows <= h - 1) & (x1 >= x0)[:, None]
        first = (qidx[:, None] * h * w + rows * w + x0[:, None]) * 4
        last = (qidx[:, None] * h * w + rows * w + x1[:, None]) * 4 + 3
        n = torch.floor(last / 32) - torch.floor(first / 32) + 1
        sectors += int((n * ok).sum().item())
    return sectors * 32 + q * 2 * 4 + q * len(pyramid) * (2 * r + 1) ** 2 * 4


def texture(rng, h, w):
    """A smooth seeded colour texture in [0, 1], (h, w, 3)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(16):
        fx, fy = rng.uniform(-0.06, 0.06, 2)
        phase = rng.uniform(0, 2 * np.pi)
        img += np.sin(fx * xs + fy * ys + phase)[..., None] * rng.rand(3).astype(np.float32)
    img += 0.2 * rng.rand(h, w, 3).astype(np.float32)
    img -= img.min()
    return img / img.max()


def synthetic_clip(n_frames, hw, shift=(1, 3), seed=0):
    """(n, H, W, 3) float32 [0, 1]: one texture moved by ``shift`` (dy, dx)
    pixels per frame."""
    rng = np.random.RandomState(seed)
    dy, dx = shift
    tex = texture(rng, hw[0] + dy * n_frames + 16, hw[1] + dx * n_frames + 16)
    return np.stack([tex[8 + t * dy:8 + t * dy + hw[0], 8 + t * dx:8 + t * dx + hw[1]]
                     for t in range(n_frames)])


def to_nchw(frames, dev):
    return torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2))).to(dev)


def seeded_raft(iters, dev, seed=0, lookup=corr_lookup, encoder_dtype=None, update_dtype=None):
    torch.manual_seed(seed)
    return RAFT(iters=iters, lookup=lookup, encoder_dtype=encoder_dtype,
                update_dtype=update_dtype).to(dev).eval()


def seeded_style_net(dev, seed=0, method="johnson"):
    torch.manual_seed(seed)
    net = method_net(method, 3)
    with torch.no_grad():  # spread the random net's output over [0, 255]
        net.deconv3.conv2d.weight.mul_(300.0)
    return net.to(dev).eval()


def finite_positive(means, what):
    if not all(math.isfinite(v) and v > 0 for v in means.values()):
        raise AssertionError(f"{what}: means not finite and positive: {means}")
    return means


def phase_build():
    t0 = time.perf_counter()
    logs = _nvcc.build_many(KERNEL_SOURCES)  # one nvcc per source, all at once
    seconds = time.perf_counter() - t0
    for module in (corr_lookup_module, pad_conv3x3_module, gemm_rate_module):
        module.build()
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


# (name, B, H, W, C, radius, levels, coords): the Sintel tcl2 shape, a ragged
# one, the CPU tests' shape, RAFT small's radius, 1 and 2 levels, and flows
# that put every window outside its map ("outside", all zeros)
LOOKUP_SHAPES = (("sintel_tcl2", 4, 54, 128, 256, 4, 4, "flow"),
                 ("ragged_55", 4, 55, 128, 256, 4, 4, "flow"),
                 ("cpu_test", 1, 8, 16, 32, 4, 4, "flow"),
                 ("radius_3", 4, 54, 128, 256, 3, 4, "flow"),
                 ("levels_1", 2, 55, 128, 64, 4, 1, "flow"),
                 ("levels_2", 2, 55, 128, 64, 3, 2, "flow"),
                 ("outside", 2, 54, 128, 64, 4, 4, "outside"))


def phase_kernel(dev):
    record = {"phase": "kernel", "shapes": {}}
    worst = 0.0
    for seed, (name, B, H, W, C, r, levels, where) in enumerate(LOOKUP_SHAPES):
        g = torch.Generator(device=dev).manual_seed(seed)
        f1 = torch.randn(B, C, H, W, generator=g, device=dev)
        f2 = torch.randn(B, C, H, W, generator=g, device=dev)
        pyramid = build_pyramid(f1, f2, levels)
        if where == "flow":  # flows of up to tens of pixels: windows leave every level's map
            flow = 8.0 * torch.randn(B, 2, H, W, generator=g, device=dev)
        else:  # past every map's right and bottom edge, at every level
            flow = torch.full((B, 2, H, W), 1000.0, device=dev)
        coords = (coords_grid(B, H, W, device=dev) + flow).contiguous()
        with torch.no_grad():
            got = corr_lookup(pyramid, coords, r)
            want = lookup_pyramid(pyramid, coords, r)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        entry = {"B": B, "H": H, "W": W, "C": C, "radius": r, "levels": levels,
                 "max_abs_err": err}
        if err != KERNEL_ERR or not math.isfinite(err):
            raise AssertionError(f"corr_lookup vs plain at {name}: {err} != {KERNEL_ERR}")
        if where == "outside" and want.abs().max().item() != 0:
            raise AssertionError("corr_lookup 'outside' shape: a window met its map")
        worst = max(worst, err)
        if name == "sintel_tcl2":
            with torch.no_grad():
                # the yardstick divides by (h-1): defined once every level has 2+ rows
                lib = corrblock_grid_sample(pyramid, coords, r)
                entry["library_max_abs_err"] = (lib - want).abs().max().item()
                entry["kernel_ms"] = time_ms(lambda: corr_lookup(pyramid, coords, r), 20)
                entry["plain_ms"] = time_ms(lambda: lookup_pyramid(pyramid, coords, r), 5)
                entry["library_ms"] = time_ms(lambda: corrblock_grid_sample(pyramid, coords, r), 5)
            entry["bound_ms"], entry["bound_by"], entry["bound_bytes"] = lookup_bound(
                pyramid, coords, r)
            entry["sector_bytes"] = lookup_sector_bytes(pyramid, coords, r)
            entry["sector_ms"] = entry["sector_bytes"] / PEAK_BYTES_PER_S * 1e3
            with torch.no_grad():
                # two calls, each on its own copy of the maps, keyed by the
                # level-0 map (the graph's inputs, 2 × 0.76 GB): the windows
                # they read, 2 × sector_bytes, are more than twice L2
                copy = [t.clone() for t in pyramid]
                pyramids = {id(pyramid[0]): pyramid, id(copy[0]): copy}
                entry["device_ms"] = graph_ms(
                    lambda lvl0: corr_lookup(pyramids[id(lvl0)], coords, r),
                    [pyramid[0], copy[0]], 20)
                entry["host_ms"] = host_ms(lambda c: corr_lookup(pyramid, c, r), coords)
                del pyramids, copy
            timing = entry
        record["shapes"][name] = entry
        del pyramid, f1, f2, got, want

    # gradient of the autograd.Function against the plain version's autograd
    g = torch.Generator(device=dev).manual_seed(7)
    f1 = torch.randn(1, 32, 8, 16, generator=g, device=dev)
    f2 = torch.randn(1, 32, 8, 16, generator=g, device=dev)
    coords0 = (coords_grid(1, 8, 16, device=dev)
               + 5.0 * torch.randn(1, 2, 8, 16, generator=g, device=dev)).contiguous()
    upstream = torch.randn(1, LEVELS * (2 * RADIUS + 1) ** 2, 8, 16, generator=g, device=dev)

    def grads(fn):
        pyramid = [t.detach().clone().requires_grad_() for t in build_pyramid(f1, f2, LEVELS)]
        coords = coords0.clone().requires_grad_()
        (fn(pyramid, coords, RADIUS) * upstream).sum().backward()
        return [coords.grad] + [t.grad for t in pyramid]

    grad_err = max((a - b).abs().max().item()
                   for a, b in zip(grads(corr_lookup), grads(lookup_pyramid)))
    if grad_err > GRAD_ATOL:
        raise AssertionError(f"corr_lookup gradient vs plain: {grad_err} > {GRAD_ATOL}")
    record["grad_max_abs_err"] = grad_err
    emit(record)
    return worst, timing


def phase_stylize(dev):
    net = seeded_style_net(dev)
    x = to_nchw(synthetic_clip(1, (436, 1024)), dev) * 2 - 1
    style = torch.tensor(1, device=dev)
    with torch.no_grad():
        _, out = net(x, 1.0, style)
        if out.shape != (1, 3, 436, 1024) or not torch.isfinite(out).all():
            raise AssertionError(f"stylize output {tuple(out.shape)} not finite/of shape")
        dt = min(chain_ms(lambda y: net(y, 1.0, style)[1] / 127.5 - 1.0, x, 20)
                 for _ in range(2))
    emit({"phase": "stylize", "shape": [1, 3, 436, 1024], "n_styles": 3,
          "dt_ms_per_frame": dt})


def phase_raft(dev):
    raft = seeded_raft(20, dev)
    clip = synthetic_clip(5, (432, 1024)) * 255.0
    i1 = to_nchw(clip[[0, 1, 2, 3]], dev)
    i2 = to_nchw(clip[[1, 2, 3, 4]], dev)
    record = {"phase": "raft", "shape": list(i1.shape), "iters": 20}
    with torch.no_grad():
        flow_low, flow_up = raft(i1, i2)
        if flow_up.shape != (4, 2, 432, 1024) or not torch.isfinite(flow_up).all():
            raise AssertionError("RAFT flow not finite/of shape")
        torch.cuda.reset_peak_memory_stats()
        before = corr_lookup.launches
        record["ms_per_call"] = time_ms(lambda: raft(i1, i2), reps=3, warmup=1)
        record["launches_per_call"] = (corr_lookup.launches - before) / 4
        record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

        # where one call's time goes, part by part, as RAFT runs them
        # (without cuDNN); the update block also with cuDNN, for comparison
        x1 = 2.0 * (i1 / 255.0) - 1.0
        x2 = 2.0 * (i2 / 255.0) - 1.0
        with cudnn_enabled(False):
            fmap1, fmap2 = raft.fnet(torch.cat([x1, x2], 0)).chunk(2, 0)
            net, inp = torch.split(raft.cnet(x1), [128, 128], 1)
            net, inp = torch.tanh(net), F.relu(inp)
            pyramid = build_pyramid(fmap1, fmap2, LEVELS)
            coords0 = coords_grid(4, 54, 128, device=dev)
            coords1 = (coords0 + flow_low).contiguous()
            corr = corr_lookup(pyramid, coords1, RADIUS)
            record["breakdown_ms"] = {
                "fnet": time_ms(lambda: raft.fnet(torch.cat([x1, x2], 0)), 3, 1),
                "cnet": time_ms(lambda: raft.cnet(x1), 3, 1),
                "corr_volume": time_ms(lambda: build_pyramid(fmap1, fmap2, LEVELS), 3, 1),
                "lookup_x20": 20 * time_ms(lambda: corr_lookup(pyramid, coords1, RADIUS), 20),
                "update_block_x20": 20 * time_ms(
                    lambda: raft.update_block(net, inp, corr, coords1 - coords0), 10),
                "mask_head": time_ms(lambda: raft.update_block.mask(net), 5),
            }
        record["update_block_x20_cudnn_ms"] = 20 * time_ms(
            lambda: raft.update_block(net, inp, corr, coords1 - coords0), 1, 1)
        del pyramid, corr, fmap1, fmap2

        # the whole net through the kernel against the plain lookup, same weights
        small = synthetic_clip(3, (64, 96), seed=1) * 255.0
        s1 = to_nchw(small[[0, 1]], dev)
        s2 = to_nchw(small[[1, 2]], dev)
        fast = seeded_raft(4, dev, seed=1)
        plain = seeded_raft(4, dev, seed=1, lookup=lookup_pyramid)
        plain.load_state_dict(fast.state_dict())
        low_k, up_k = fast(s1, s2)
        low_p, up_p = plain(s1, s2)
        dflow = max((low_k - low_p).abs().max().item(), (up_k - up_p).abs().max().item())
    if dflow > FLOW_ATOL_PX:
        raise AssertionError(f"RAFT kernel vs plain lookup: {dflow} px > {FLOW_ATOL_PX}")
    record["small_check"] = {"shape": [2, 3, 64, 96], "iters": 4, "max_abs_dflow_px": dflow,
                             "max_abs_flow_px": up_p.abs().max().item()}
    emit(record)


def small_reference_check(dev, evaluate, what):
    """``evaluate(videos, raft_apply)``, a Sintel driver, on a 7-frame 64×96
    clip with RAFT (4 iterations) through the kernel and through the plain
    lookup, same weights: every TCL value within ``TCL_RTOL`` relative and
    positive. Returns the largest relative difference."""
    small = SintelVideo("small", synthetic_clip(7, (64, 96), seed=2))
    vals = []
    for lookup in (corr_lookup, lookup_pyramid):
        raft = seeded_raft(4, dev, seed=2, lookup=lookup)
        res = evaluate([small], lambda a, b: raft(a, b))
        vals.append([res[k][f"{k}_small_s{d}"] for k in TCL_KEYS for d in (1, 2, 3)])
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(*vals))
    if rel > TCL_RTOL or not all(v > 0 for v in vals[1]):
        raise AssertionError(f"{what}: small-input TCL kernel vs plain: {rel} > {TCL_RTOL} "
                             f"or not positive: {vals}")
    return rel


def phase_main_path(dev):
    style_net = seeded_style_net(dev)
    sd = style_net.state_dict()
    rel = small_reference_check(
        dev, lambda videos, raft_apply: evaluate_sintel_faststyle(
            style_net, sd, videos, raft_apply, dt_iters=1, device=dev), "main path")

    raft = seeded_raft(20, dev)
    video = SintelVideo("synthetic", synthetic_clip(8, (432, 1024), seed=3))
    with torch.no_grad():  # the time of one tcl2 program at full size
        frames = to_nchw(video.frames, dev) * 2 - 1
        _, _, _, tcl2 = make_tcl_program(faststyle_stylize_fn(style_net, sd),
                                         lambda a, b: raft(a, b))
        style = torch.tensor(0, device=dev)
        tcl2_ms = time_ms(lambda: tcl2(frames[5:6], frames[4:5], frames[0:1], style), 3, 1)
        del frames

    reset_counts()
    t0 = time.perf_counter()
    res = evaluate_sintel_faststyle(style_net, sd, [video], lambda a, b: raft(a, b),
                                    styles=(0, 1, 2), device=dev)
    seconds = time.perf_counter() - t0
    launches = corr_lookup.launches

    means = finite_positive({k: res[k][f"{k}_mean"] for k in ("TCL-ST", "TCL-LT", "DT")},
                            "main path")
    if launches <= 0:
        raise AssertionError("the main path never launched the corr_lookup kernel")
    emit({"phase": "main_path", "clip": [8, 432, 1024], "styles": [0, 1, 2],
          "raft_iters": 20, **means, "corr_lookup_launches": launches, "seconds": seconds,
          "tcl2_ms": tcl2_ms, "small_reference_max_rel_err": rel})
    return launches


def phase_eval_sintel(dev):
    """The eval-sintel command for Johnson and Ruder at the Sintel size,
    then Ruder's driver through RAFT and the kernel."""
    record = {"phase": "eval_sintel", "cli": {}}
    for method in ("johnson", "ruder"):
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            res = cli_main(["eval-sintel", "--method", method, "--hw", *map(str, SINTEL_HW),
                            "--out-dir", out_dir])
            seconds = time.perf_counter() - t0
            written = sorted(os.listdir(out_dir))
        means = finite_positive({k: res[k][f"{k}_mean"] for k in res}, f"eval-sintel {method}")
        record["cli"][method] = {**means, "seconds": seconds, "written": written}

    net = seeded_style_net(dev, seed=4, method="ruder")
    pre = seeded_style_net(dev, seed=5)
    sd, pre_sd = net.state_dict(), pre.state_dict()

    def ruder(videos, raft_apply):
        return evaluate_sintel_ruder(net, sd, pre, pre_sd, videos, raft_apply, device=dev)

    rel = small_reference_check(dev, ruder, "Ruder")
    raft = seeded_raft(20, dev)
    video = SintelVideo("synthetic", synthetic_clip(8, CLIP_HW, seed=3))
    reset_counts()
    t0 = time.perf_counter()
    res = ruder([video], lambda a, b: raft(a, b))
    seconds = time.perf_counter() - t0
    launches = corr_lookup.launches
    if launches <= 0:
        raise AssertionError("evaluate_sintel_ruder never launched the corr_lookup kernel")
    record["ruder_raft"] = {"clip": [8, *CLIP_HW], "styles": [0, 1, 2], "raft_iters": 20,
                            **finite_positive({k: res[k][f"{k}_mean"] for k in res},
                                              "Ruder through RAFT"),
                            "seconds": seconds, "corr_lookup_launches": launches,
                            "small_reference_max_rel_err": rel}
    emit(record)
    return launches


def phase_raft_bf16(dev):
    """bf16 RAFT: its convolutions on cuDNN and off, bench-raft's five
    variants, and each bf16 variant through the kernel against the plain
    lookup."""
    bf16 = torch.bfloat16
    record = {"phase": "raft_bf16", "cudnn_vs_native_ms": {}}
    clip = synthetic_clip(5, CLIP_HW) * 255.0
    x1 = 2.0 * (to_nchw(clip[[0, 1, 2, 3]], dev) / 255.0) - 1.0
    x2 = 2.0 * (to_nchw(clip[[1, 2, 3, 4]], dev) / 255.0) - 1.0
    raft = seeded_raft(20, dev, encoder_dtype=bf16, update_dtype=bf16)
    with torch.no_grad():
        fmap1, fmap2 = raft.fnet(torch.cat([x1, x2], 0)).float().chunk(2, 0)
        net, inp = torch.split(raft.cnet(x1).float(), [128, 128], 1)
        net, inp = torch.tanh(net), F.relu(inp)
        pyramid = build_pyramid(fmap1, fmap2, LEVELS)
        coords = coords_grid(4, CLIP_HW[0] // 8, CLIP_HW[1] // 8, device=dev)
        corr = corr_lookup(pyramid, coords, RADIUS)
        parts = {"fnet_8_frames": lambda: raft.fnet(torch.cat([x1, x2], 0)),
                 "cnet_4_frames": lambda: raft.cnet(x1),
                 "update_block_x20": lambda: raft.update_block(net, inp, corr, coords - coords)}
        for part, fn in parts.items():
            reps = 10 if part == "update_block_x20" else 3
            scale = 20 if part == "update_block_x20" else 1
            times = {}
            for cudnn in (False, True):
                with cudnn_enabled(cudnn):
                    times["cudnn" if cudnn else "native"] = scale * time_ms(fn, reps, 1)
            record["cudnn_vs_native_ms"][part] = times
        del pyramid, corr, fmap1, fmap2

    reset_counts()
    with tempfile.TemporaryDirectory() as out_dir:  # the command's own windows of 5 pairs
        cli_main(["bench-raft", "--hw", *map(str, SINTEL_HW), "--out-dir", out_dir])
        with open(f"{out_dir}/raft_timing.json") as f:
            record["bench_raft"] = json.load(f)
    record["bench_raft_corr_lookup_launches"] = corr_lookup.launches
    if corr_lookup.launches <= 0:
        raise AssertionError("bench-raft never launched the corr_lookup kernel")

    # each bf16 variant's pair through the kernel against the plain lookup;
    # then every variant's pair split: the eager call as bench-raft times it
    # (mean of 5), the device alone (a CUDA graph of one pair call per input
    # of a cold pool, best of 3 replays), the host's time to issue one call
    pair = synthetic_clip(2, SINTEL_HW, seed=6) * 255.0
    img1, img2 = to_nchw(pair[0:1], dev), to_nchw(pair[1:2], dev)
    record["variants"] = {}
    with torch.no_grad():
        for name, (enc, upd, mult) in RAFT_VARIANTS.items():
            fast = seeded_raft(20, dev, encoder_dtype=enc, update_dtype=upd)
            i1, i2 = InputPadder(img1.shape, mult=mult).pad(img1, img2)
            a, b = torch.cat([i1, i2], 0), torch.cat([i2, i1], 0)
            entry = record["variants"][name] = {}
            if name in BF16_RAFT_VARIANTS:
                plain = seeded_raft(20, dev, lookup=lookup_pyramid, encoder_dtype=enc,
                                    update_dtype=upd)
                reset_counts()
                flow_k = fast(a, b)[1]
                torch.cuda.synchronize()
                launches = corr_lookup.launches
                flow_p = plain(a, b)[1]
                err = (flow_k - flow_p).abs().max().item()
                if launches <= 0 or err != KERNEL_ERR or not torch.isfinite(flow_k).all():
                    raise AssertionError(f"bf16 RAFT {name}: {launches} launches, kernel vs "
                                         f"plain lookup max |Δ| {err} != {KERNEL_ERR}")
                entry.update({"corr_lookup_launches": launches, "max_abs_err": err,
                              "max_abs_flow_px": flow_p.abs().max().item(),
                              "flow_dtype": str(flow_k.dtype)})
                del plain, flow_k, flow_p
            entry["pair_ms"] = {"eager": time_ms(lambda: fast(a, b), 5, 1),
                                "device": graph_ms(lambda t: fast(t, b)[1], cold_pool(a), 1),
                                "host": host_ms(lambda t: fast(t, b), a, calls=1)}
            del fast
    emit(record)
    return {name: v["corr_lookup_launches"] for name, v in record["variants"].items()
            if "corr_lookup_launches" in v}


def png_signature(path):
    with open(path, "rb") as f:
        return f.read(8)


def phase_stylize_video(dev):
    """The stylize-video command on 24 synthetic Sintel-sized frames; then
    its timed loop ``VIDEO_PASSES`` times more, with the net and with the
    identity in its place (the copies and the host's work alone), and the
    net's device time per frame on a chunk that stays on the card."""
    record = {"phase": "stylize_video", "runs": {}}
    for flags, batch in (((), 1), (("--bf16",), 8)):
        argv = ["stylize-video", "--hw", *map(str, SINTEL_HW), "--n-frames", str(VIDEO_FRAMES),
                "--batch-size", str(batch), *flags]
        with tempfile.TemporaryDirectory() as out_dir:
            line = cli_main([*argv, "--out-dir", out_dir])
            written = sorted(os.listdir(out_dir))
            pngs = [f for f in written if f.endswith(".png")]
            signatures = {png_signature(os.path.join(out_dir, f)) for f in pngs}
        if (len(pngs) != VIDEO_FRAMES or line["frames"] != VIDEO_FRAMES
                or signatures != {b"\x89PNG\r\n\x1a\n"}
                or not (math.isfinite(line["frames_per_sec"]) and line["frames_per_sec"] > 0)):
            raise AssertionError(f"stylize-video {line}: wrote {written}")
        args = cli_parser().parse_args(argv)
        frames = source_frames(args)
        stylize, dtype = video_stylizer(args, dev)
        with torch.no_grad():
            x = torch.from_numpy(frames[:batch]).to(dev).permute(0, 3, 1, 2).to(dtype).contiguous()
            fps = {what: sorted(VIDEO_FRAMES / stylize_frames(fn, frames, batch, dtype, dev)[1]
                                for _ in range(VIDEO_PASSES))
                   for what, fn in (("net", stylize), ("copies_only", lambda y: y))}
            device_ms = min(windows_ms(stylize, x, 10)) / batch
        record["runs"][f"{line['dtype']}_b{batch}"] = {
            **line, "pngs": len(pngs), "other_files": [f for f in written if f not in pngs],
            "passes_frames_per_sec": fps["net"],
            "median_frames_per_sec": fps["net"][VIDEO_PASSES // 2],
            "copies_only_frames_per_sec": fps["copies_only"],
            "device_ms_per_frame": device_ms}
    emit(record)


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    corr_lookup.launches = 0
    pad_conv3x3.launches.clear()
    gemm_rate.launches.clear()


def require_launches(counter, keys, path):
    missing = [k for k in keys if counter[k] <= 0]
    if missing:
        raise AssertionError(f"{path} never launched its kernel for {missing}")
    return {k: counter[k] for k in keys}


# (name, (N, H, W, C_in), C_out): the trunk shape, a ragged one, the CPU
# tests' shapes; then C_in ≠ C_out both ways, C_out = 8, batch 3, H = 2 and
# C_out past one 128-channel tile
CONV_SHAPES = (("trunk", (1, 109, 256, 128), 128), ("ragged", (2, 13, 37, 64), 64),
               ("cpu_test", (1, 20, 16, 8), 8), ("cpu_test_ragged", (1, 21, 16, 8), 8),
               ("cin64_cout128", (1, 40, 70, 64), 128), ("cin128_cout64", (1, 40, 70, 128), 64),
               ("cout8", (2, 13, 37, 64), 8), ("batch3", (3, 9, 40, 32), 32),
               ("h2", (1, 2, 37, 64), 64), ("cout136", (2, 2, 2, 16), 136))


def check_pad_conv3x3(dev, modes, shapes):
    """Each mode and dtype against its plain version on the same inputs, bit
    for bit for ``CONV_EXACT_MODES``; returns {(mode, dtype name): max |Δ|}
    over ``shapes``."""
    errs = {}
    for mode in modes:
        for dtype in DTYPES:
            worst = 0.0
            for seed, (name, shape, cout) in enumerate(shapes):
                x, w = bisect_im2col.trunk_inputs(dtype, dev, seed, shape, cout)
                with torch.no_grad():
                    got = pad_conv3x3(x, w, mode).float()
                    want = pad_conv3x3_plain(x, w, mode).float()
                torch.cuda.synchronize()
                diff = (got - want).abs()
                if mode in CONV_EXACT_MODES:
                    ok = bool((diff == 0).all())
                elif dtype == torch.bfloat16:
                    ok = bool((diff <= CONV_BF16_ATOL + CONV_BF16_RTOL * want.abs()).all())
                else:
                    ok = bool((diff <= CONV_F32_ATOL).all())
                err = diff.max().item()
                if not ok or not math.isfinite(err):
                    raise AssertionError(f"pad_conv3x3 {mode} {dtype} vs plain at {name} "
                                         f"{shape} -> {cout}: max |Δ| {err}")
                worst = max(worst, err)
            errs[(mode, dtype_name(dtype))] = worst
    return errs


def phase_trunk_conv(dev):
    errs = check_pad_conv3x3(dev, ("full", "mxu_only"), CONV_SHAPES)
    reset_counts()
    records = bisect_im2col.run(dev)
    keys = [("full", dtype_name(d)) for d in DTYPES]
    launches = require_launches(pad_conv3x3.launches, keys, "bisect_im2col")
    emit({"phase": "trunk_conv",
          "shapes": {name: [list(shape), cout] for name, shape, cout in CONV_SHAPES},
          "max_abs_err": {"/".join(k): v for k, v in errs.items()},
          "probe": records, "launches": {"/".join(k): v for k, v in launches.items()}})
    return {k: {"max_abs_err": errs[k], "launches": launches[k], **rec}
            for k, rec in zip(keys, records)}, errs


def phase_kernel_cost(dev, weighted_errs):
    """``weighted_errs``: phase 6's max |Δ| of full and mxu_only."""
    errs = {**weighted_errs, **check_pad_conv3x3(dev, CONV_EXACT_MODES, CONV_SHAPES)}
    reset_counts()
    records = bisect_kernel_cost.run(dev)
    keys = [(m, dtype_name(d)) for d in DTYPES for m in MODES]
    launches = require_launches(pad_conv3x3.launches, keys, "bisect_kernel_cost")
    emit({"phase": "kernel_cost", "max_abs_err": {"/".join(k): v for k, v in errs.items()},
          "probe": records, "launches": {"/".join(k): v for k, v in launches.items()}})
    by_dtype = {rec["dtype"]: rec["modes"] for rec in records}
    return {(m, dt): {"max_abs_err": errs[(m, dt)], "launches": launches[(m, dt)],
                      **by_dtype[dt][m]} for m, dt in keys}


def phase_gemm_rate(dev):
    errs = {}  # max |Δ| per (dtype name, K, N)
    for dtype in DTYPES:
        for K, N in bisect_mxu.SHAPES:
            x, w = bisect_mxu.gemm_inputs(K, N, dtype, dev)
            with torch.no_grad():
                got = gemm_rate(x, w, bisect_mxu.REPS).float()
                want = gemm_rate_plain(x, w, bisect_mxu.REPS).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            limit = GEMM_TOL[dtype] * want.abs().max().item()
            if not err <= limit:
                raise AssertionError(f"gemm_rate {dtype} vs plain at K={K}, N={N}: "
                                     f"max |Δ| {err} > {limit}")
            errs[(dtype_name(dtype), K, N)] = err
    reset_counts()
    records = bisect_mxu.run(dev)
    keys = [dtype_name(d) for d in DTYPES]
    launches = require_launches(gemm_rate.launches, keys, "bisect_mxu")
    emit({"phase": "gemm_rate", "probe": records, "launches": launches,
          "max_abs_err": {f"{dt}_K{K}_N{N}": e for (dt, K, N), e in errs.items()}})
    # the kernels line's shapes, the square one and the deepest K, each with
    # its own error and the launches its timing made in the probe's run
    listed = {f"{rec['dtype']}_K{rec['K']}_N{rec['N']}": {
                  **rec, "max_abs_err": errs[(rec["dtype"], rec["K"], rec["N"])]}
              for rec in records if (rec["K"], rec["N"]) in ((128, 128), (1152, 128))}
    require_launches({k: m["launches"] for k, m in listed.items()}, listed, "bisect_mxu")
    return listed


def phase_bench(dev):
    # the benchmark's program on one Sintel-sized frame: finite, in [0, 1]
    frame = torch.from_numpy(synthetic_clip(1, (bench.H, bench.W)).transpose(0, 3, 1, 2).copy())
    for dtype in DTYPES:
        net = bench.seeded_net(dtype, dev)
        with torch.no_grad():
            out = bench.make_stylize(net, torch.zeros((), dtype=torch.long, device=dev))(
                frame.to(dev, dtype)).float()
        if (out.shape != (1, 3, bench.H, bench.W) or not torch.isfinite(out).all()
                or out.min() < 0 or out.max() > 1):
            raise AssertionError(f"bench stylize {dtype}: output not finite in [0, 1] of shape")

    reset_counts()
    report = bench.run(bench.CONFIGS[:3], dev)
    with tempfile.TemporaryDirectory() as out_dir:
        cli_main(["bench-raft", "--variants", "f32", "--iters", "2", "--out-dir", out_dir])
        with open(f"{out_dir}/raft_timing.json") as f:
            raft = json.load(f)
    launches = corr_lookup.launches
    if launches <= 0:
        raise AssertionError("bench-raft never launched the corr_lookup kernel")
    timed = [*report["paths_ms"].values(), *report["paths_ms_fused"].values(),
             *(v for k, v in raft.items() if k.startswith("pair_ms_"))]
    if not all(math.isfinite(t) and t > 0 for t in timed):
        raise AssertionError(f"bench times not finite and positive: {timed}")
    emit({"phase": "bench", "bench": report, "bench_raft": raft,
          "corr_lookup_launches": launches})


def check_training_step(method, dev, coin):
    """One step on the card against the CPU: loss and terms in f32, every
    gradient in f64 (in f32 the ReLUs and max-pools that rounding switches
    decide a part of the gradient, recorded as ``f32_grad_*``)."""
    (want, want_aux, want_g32), (got, got_aux, got_g32) = (
        training_step(method, d, torch.float32, coin) for d in ("cpu", dev))
    loss_rel = max([abs(got - want) / abs(want)]
                   + [abs(got_aux[k] - w) / abs(w) for k, w in want_aux.items() if w])
    (_, _, want_g), (_, _, got_g) = (training_step(method, d, torch.float64, coin)
                                     for d in ("cpu", dev))
    grad_rel, _ = grad_errors(got_g, want_g)
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"train step {method} card vs CPU: loss {loss_rel} > "
                             f"{TRAIN_LOSS_RTOL} or f64 gradient {grad_rel} > {TRAIN_GRAD_RTOL}")
    f32_worst, f32_whole = grad_errors(got_g32, want_g32)
    return {"loss": want, "loss_max_rel_err": loss_rel, "f64_grad_max_rel_err": grad_rel,
            "f32_grad_max_rel_err": f32_worst, "f32_grad_whole_rel_err": f32_whole}


def conv_split(dev):
    """ms and peak memory of VGG16 (content forward, styled forward and
    input gradient, as a Johnson step runs it) and of FastStyleNet (forward
    and backward) at 16×3×256×256, on cuDNN and on PyTorch's own
    convolutions."""
    g = torch.Generator(device=dev).manual_seed(0)
    content = torch.rand(TRAIN_BATCH, 3, *TRAIN_HW, generator=g, device=dev)
    styled = torch.rand(TRAIN_BATCH, 3, *TRAIN_HW, generator=g, device=dev).requires_grad_()
    vgg = he_randomized_(Vgg16Features(), 0).requires_grad_(False).to(dev)
    torch.manual_seed(0)
    net = FastStyleNet().to(dev)

    def vgg_step():
        cf, sf = vgg(content), vgg(styled)
        loss = ((sf[2] - cf[2]) ** 2).mean() + sum(f.square().mean() for f in sf)
        torch.autograd.grad(loss, styled)

    def net_step():
        net(content)[1].mean().backward()

    out = {}
    for cudnn in (True, False):
        with cudnn_enabled(cudnn):
            part = out["cudnn" if cudnn else "native"] = {}
            for name, fn in (("vgg16_fwd_bwd", vgg_step), ("faststyle_fwd_bwd", net_step)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                part[name] = time_ms(fn, 3, 1)
                part[name + "_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def profile_steps(trainer, batch, steps=2):
    """torch.profiler over ``steps`` training steps: the wall per step, the
    kernels' device time per step (the device's busy share of the wall)
    and the 12 kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    return {"wall_ms_per_step": wall_ms, "kernel_ms_per_step": device_ms,
            "busy_share": device_ms / wall_ms,
            "top_kernels": [{"name": name[:100], "ms_per_step": ms, "calls_per_step": n}
                            for name, ms, n in kernels[:12]]}


def kernel_launches():
    return {"corr_lookup": corr_lookup.launches,
            "pad_conv3x3": sum(pad_conv3x3.launches.values()),
            "gemm_rate": sum(gemm_rate.launches.values())}


def phase_train_faststyle(dev):
    record = {"phase": "train_faststyle", "hw": list(TRAIN_HW), "batch": TRAIN_BATCH,
              "small_check": {}, "runs": {}}
    for method in FASTSTYLE_METHODS:
        for coin in ((True, False) if method == "ruder" else (None,)):
            name = method + {True: "_roll", False: "_zero", None: ""}[coin]
            record["small_check"][name] = check_training_step(method, dev, coin)
    record["cudnn_vs_native_ms"] = conv_split(dev)

    train = ["train-faststyle", "--hw", *map(str, TRAIN_HW), "--batch-size", str(TRAIN_BATCH),
             "--log-every", "5"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        corpus = os.path.join(tmp, "fc2")
        pack_fc2_npy(corpus, TRAIN_CORPUS, TRAIN_HW)
        record["corpus_write_s"] = time.perf_counter() - t0
        reset_counts()
        for method in FASTSTYLE_METHODS:
            t0 = time.perf_counter()
            res = cli_main([*train, "--method", method, "--steps", str(TRAIN_STEPS),
                            "--data-dir", corpus, "--device-cache", str(TRAIN_CORPUS),
                            "--out-dir", os.path.join(tmp, method)])
            if res["n_nonfinite"] or not all(math.isfinite(v) for v in res["losses"]):
                raise AssertionError(f"train-faststyle {method}: a loss is not finite")
            record["runs"][method] = {**{k: v for k, v in res.items() if k != "batch_ms"},
                                      "seconds": time.perf_counter() - t0}
        launches = kernel_launches()

        # vst's own check (tests/test_train_faststyle.py:49-53): on one fixed
        # batch Johnson's loss falls
        cfg = select_method("johnson", batch_size=TRAIN_BATCH)
        trainer = FastStyleTrainer(cfg, load_style_images(size=256)[:1], seed=0, device=dev)
        batch = DeviceFC2Cache(corpus, seed=1, device=dev).sample(TRAIN_BATCH)
        losses = torch.stack([trainer.train_step(batch)["loss"]
                              for _ in range(LEARN_STEPS)]).tolist()
        if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"Johnson on one batch did not learn: {losses}")
        record["fixed_batch"] = {"steps": LEARN_STEPS, "first_loss": losses[0],
                                 "last_loss": losses[-1]}
        record["johnson_profile"] = profile_steps(trainer, batch)

        # the host path: batches made on the host for every step
        res = cli_main([*train, "--method", "johnson", "--steps", str(HOST_STEPS),
                        "--out-dir", os.path.join(tmp, "host")])
        if res["n_nonfinite"]:
            raise AssertionError("train-faststyle on host batches: a loss is not finite")
        record["host_path"] = {k: v for k, v in res.items() if k != "losses"}
    if any(launches.values()):
        raise AssertionError(f"the training path launched a kernel: {launches}")
    record["kernel_launches"] = launches
    emit(record)


def obst_level(device, dtype, hw=(32, 32), iters=20, seed=0):
    """One OBST level on ``device``: ``iters`` compact L-BFGS iterations from
    a seeded image against a seeded style, content, warp target and mask
    (temporal weight 2000). Returns (image, losses) on the CPU."""
    rng = np.random.RandomState(seed)
    obst = OBST(seed=seed, compute_dtype=dtype, device=device)
    obst.set_style(rng.rand(2 * hw[0], 2 * hw[1], 3), [hw])
    x0, content, warp_img = (torch.from_numpy((rng.rand(1, 3, *hw) - 0.45) * 255.0)
                             .to(device, dtype) for _ in range(3))
    mask = torch.from_numpy(rng.rand(1, 3, *hw)).to(device, dtype)
    with torch.no_grad():
        feats = obst._features(content, ["r42"])
    x, losses = obst.descend(x0, obst.style_targets[0], feats, warp_img, mask, 2000.0, iters)
    return x.cpu(), losses.cpu()


def obst_closure_loss(device, hw=(64, 64), seed=1):
    """One float32 OBST closure's loss at ``hw`` (style, content and a live
    temporal term) on ``device``."""
    rng = np.random.RandomState(seed)
    obst = OBST(seed=seed, device=device)
    obst.set_style(rng.rand(2 * hw[0], 2 * hw[1], 3).astype(np.float32), [hw])
    x, content, warp_img = (torch.from_numpy(((rng.rand(1, 3, *hw) - 0.45) * 255.0)
                                             .astype(np.float32)).to(device) for _ in range(3))
    mask = torch.from_numpy(rng.rand(1, 3, *hw).astype(np.float32)).to(device)
    with torch.no_grad():
        feats = obst._features(content, ["r42"])
        return obst._loss(x, obst.style_targets[0], feats, warp_img, mask, 2000.0).item()


def profile_call(fn):
    """One call of ``fn`` after a warm-up call, timed by the host clock
    between two synchronize() calls (``wall_ms``), then one more under
    torch.profiler: the kernels' device ms, the device's busy share of the
    unprofiled wall (the profiler's own cost, tens of µs a launch, inflates
    the profiled wall, ``profiled_wall_ms``), the launches and the 8 kernels
    that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms, "kernel_ms": device_ms,
            "busy_share": device_ms / wall_ms, "kernel_launches": sum(n for _, _, n in kernels),
            "top_kernels": [{"name": name[:100], "ms": ms, "calls": n}
                            for name, ms, n in kernels[:8]]}


def profile_obst_frame(dev, dtype):
    """The busy share of one full-size obst.run (a frame with a warm start,
    a live mask and λ = 2000), with its peak memory."""
    rng = np.random.RandomState(2)
    H, W = SINTEL_HW
    obst = OBST(seed=0, compute_dtype=dtype, device=dev)
    obst.set_style(load_style_images(size=256)[0], PYR_SINTEL)
    img = torch.from_numpy(((rng.rand(1, 3, H, W) - 0.45) * 255.0).astype(np.float32)).to(dev)
    pre = img + 4.0 * torch.randn_like(img)
    mask = (torch.rand(1, 1, H, W, device=dev) > 0.2).float()
    torch.cuda.reset_peak_memory_stats()
    record = profile_call(lambda: obst.run(pre, img, mask, PYR_SINTEL, weight_tcl=2000.0))
    record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return record


def phase_obst(dev):
    """OBST on the card against the CPU; eval-obst at the Sintel size in f32
    (λ 0, 2000) and bf16 (λ 2000); the busy share of one frame per dtype."""
    record = {"phase": "obst", "seconds": {}}
    t0 = time.perf_counter()
    got, got_losses = obst_level(dev, torch.float64)
    want, want_losses = obst_level("cpu", torch.float64)
    level_rel = ((got - want).abs().max() / want.abs().max()).item()
    ref = obst_closure_loss("cpu")
    loss_rel = abs(obst_closure_loss(dev) - ref) / abs(ref)
    if not (level_rel <= OBST_IMAGE_RTOL and loss_rel <= OBST_LOSS_RTOL
            and want_losses[-1] < want_losses[0]):
        raise AssertionError(f"OBST card vs CPU: level {level_rel} > {OBST_IMAGE_RTOL} or "
                             f"closure loss {loss_rel} > {OBST_LOSS_RTOL}")
    record["card_vs_cpu"] = {"level_f64_32x32_iters20_max_rel_err": level_rel,
                             "level_losses_max_rel_err": (
                                 (got_losses - want_losses).abs().max()
                                 / want_losses.abs().max()).item(),
                             "closure_f32_64x64_loss_rel_err": loss_rel, "closure_loss": ref}

    record["seconds"]["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    argv = ["eval-obst", "--hw", *map(str, SINTEL_HW), "--n-videos", "1", "--n-frames",
            str(OBST_FRAMES), "--n-styles", "1", "--iters-pyr", "50", "40", "30"]
    record["eval_obst"] = {}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for lambdas, extra in (((0, 2000), ()), ((2000,), ("--obst-bf16",))):
            out_dir = os.path.join(tmp, "bf16" if extra else "f32")
            summary = cli_main([*argv, "--lambda-tcl", *map(str, lambdas), *extra,
                                "--out-dir", out_dir])
            for lam in lambdas:
                entry = summary[str(lam)]
                if not all(math.isfinite(v) for v in entry.values()):
                    raise AssertionError(f"eval-obst {extra} λ={lam}: not finite: {entry}")
                record["eval_obst"][f"{summary['obst_dtype']}_lambda{lam}"] = {
                    **entry, "DT_s_per_frame": entry["DT_ms_mean"] / 1e3}
        written = sorted(os.path.relpath(os.path.join(d, f), tmp)
                         for d, _, fs in os.walk(tmp) for f in fs)
    launches = corr_lookup.launches
    record["seconds"]["eval_obst"] = time.perf_counter() - t0
    f32 = record["eval_obst"]
    if not f32["float32_lambda2000"]["TCL-ST_mean"] < f32["float32_lambda0"]["TCL-ST_mean"]:
        raise AssertionError(f"eval-obst: TCL-ST at λ=2000 not below λ=0: {f32}")
    if launches <= 0:
        raise AssertionError("eval-obst never launched the corr_lookup kernel")
    t0 = time.perf_counter()
    record.update({"clip": [OBST_FRAMES, *SINTEL_HW], "styles": [0], "iters_pyr": [50, 40, 30],
                   "written": written, "corr_lookup_launches": launches,
                   "profile": {name: profile_obst_frame(dev, dtype) for name, dtype in
                               (("float32", torch.float32), ("bfloat16", torch.bfloat16))}})
    record["seconds"]["profile"] = time.perf_counter() - t0
    emit(record)
    return launches


class Stopwatch:
    """Host seconds spent in wrapped callables, by name (the wrapped metric
    nets return host values, so their device work is inside)."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0

        return timed


def phase_fc2_metrics(dev):
    """eval-fc2 at 256² on 4 synthetic batches of 4 for OBST, Johnson and
    Ruder, the seconds split by part; the metric nets on the card against
    the CPU."""
    record = {"phase": "fc2_metrics", "hw": list(FC2_HW), "runs": {}}
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 3, 80, 80).astype(np.float32)) * 2 - 1
    act_want = InceptionV3(seed=0, device="cpu")(x)
    act_got = InceptionV3(seed=0, device=dev)(x.to(dev))
    lp_want = LPIPS(seed=0, device="cpu")(x[:2], x[2:])
    lp_got = LPIPS(seed=0, device=dev)(x[:2].to(dev), x[2:].to(dev))
    act_rel = float(np.abs(act_got - act_want).max() / np.abs(act_want).max())
    lp_rel = abs(lp_got - lp_want) / abs(lp_want)
    if not (act_rel <= METRIC_RTOL and lp_rel <= METRIC_RTOL):
        raise AssertionError(f"metric nets card vs CPU: Inception {act_rel}, LPIPS {lp_rel} > "
                             f"{METRIC_RTOL}")
    record["card_vs_cpu"] = {"inception_max_rel_err": act_rel, "lpips_rel_err": lp_rel,
                             "lpips": lp_want}

    # seed 14: every task of the 4 batches has 2 or more samples, so FID takes
    # the sample-subspace path (a pile of one takes a 2048² sqrtm on the host)
    argv = ["eval-fc2", "--hw", *map(str, FC2_HW), "--batch-size", "4", "--seed", str(FC2_SEED)]
    runs = {"obst": ["--family", "obst", "--iters-pyr", "50", "40", "30"],
            "johnson": ["--family", "faststyle", "--method", "johnson", "--num-outs", "3"],
            "ruder": ["--family", "faststyle", "--method", "ruder"]}
    reset_counts()
    for name, flags in runs.items():
        watch = Stopwatch()
        saved = (InceptionV3.__call__, LPIPS.__call__, fc2_module.fid_from_activations,
                 drivers_module.fid_from_activations)
        InceptionV3.__call__ = watch.wrap("inception_s", saved[0])
        LPIPS.__call__ = watch.wrap("lpips_s", saved[1])
        fc2_module.fid_from_activations = watch.wrap("fid_host_s", saved[2])
        drivers_module.fid_from_activations = watch.wrap("fid_host_s", saved[3])
        try:
            with tempfile.TemporaryDirectory() as out_dir:
                t0 = time.perf_counter()
                res = cli_main([*argv, *flags, "--out-dir", out_dir])
                wall = time.perf_counter() - t0
                written = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                                 for d, _, fs in os.walk(out_dir) for f in fs)
        finally:
            (InceptionV3.__call__, LPIPS.__call__, fc2_module.fid_from_activations,
             drivers_module.fid_from_activations) = saved
        # OBST returns one table a λ, the others one table
        tables = ({f"lambda{lam}_": t for lam, t in res.items()} if name == "obst"
                  else {"": res})
        means = {prefix + k: v for prefix, table in tables.items()
                 for metric in table.values() for k, v in metric.items()
                 if k.endswith("mean") and isinstance(v, float)}
        if not means or not all(math.isfinite(v) for v in means.values()):
            raise AssertionError(f"eval-fc2 {name}: means missing or not finite: {means}")
        metric_s = sum(watch.seconds.values())
        record["runs"][name] = {"means": means, "written": written, "wall_s": wall,
                                **watch.seconds, "stylize_and_rest_s": wall - metric_s}
    launches = kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"the FC2 paths launched a kernel: {launches}")
    record["kernel_launches"] = launches
    emit(record)


def kernel_entries(name, source, replaces, measured):
    """The kernels line's entries of one kernel, one per variant."""
    return [{"name": f"{name}_{variant}", "route": "cuda", "source": source,
             "replaces": replaces, "launches": m["launches"], "max_abs_err": m["max_abs_err"],
             "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
             "bound_by": m["bound_by"], "library_ms": m.get("library_ms"),
             **{k: m[k] for k in ("device_ms", "host_ms", "library_x64_ms") if k in m}}
            for variant, m in measured.items()]


def per_conv(measured):
    """A probe record's per-conv times under the kernels line's names."""
    return {"launches": measured["launches"], "max_abs_err": measured["max_abs_err"],
            "ms": measured["ms_per_conv"], "device_ms": measured["device_ms"],
            "host_ms": measured["host_ms"], "plain_ms": measured["plain_ms_per_conv"],
            "bound_ms": measured["bound_ms"], "bound_by": measured["bound_by"],
            "library_ms": measured.get("library_ms_per_conv")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    set_f32_precision()
    emit({"phase": "start", "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn": torch.backends.cudnn.version(), "device": torch.cuda.get_device_name(0),
          "tf32": False})

    phase_build()
    max_err, timing = phase_kernel(dev)
    phase_stylize(dev)
    phase_raft(dev)
    launches = phase_main_path(dev)
    ruder_launches = phase_eval_sintel(dev)
    bf16_launches = phase_raft_bf16(dev)
    phase_stylize_video(dev)
    trunk, weighted_errs = phase_trunk_conv(dev)
    cost = phase_kernel_cost(dev, weighted_errs)
    gemm = phase_gemm_rate(dev)
    phase_bench(dev)
    phase_train_faststyle(dev)
    obst_launches = phase_obst(dev)
    phase_fc2_metrics(dev)

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    conv_source = "vst_torch/csrc/pad_conv3x3.cu"
    emit({"kernels": [
        {"name": "corr_lookup", "route": "cuda", "source": "vst_torch/csrc/corr_lookup.cu",
         "replaces": "vst/kernels/pallas_corr.py:87", "launches": launches,
         "max_abs_err": max_err, "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
         "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
         "library_ms": timing["library_ms"], "device_ms": timing["device_ms"],
         "host_ms": timing["host_ms"],
         "launches_by_path": {"main_path": launches, "eval_sintel_ruder": ruder_launches,
                              **{f"raft_{k}": v for k, v in bf16_launches.items()},
                              "eval_obst": obst_launches}},
        *kernel_entries("pad_conv3x3", conv_source, "scripts/bisect_im2col.py:20",
                        {f"full_{dt}": per_conv(m) for (_, dt), m in trunk.items()}),
        *kernel_entries("pad_conv3x3", conv_source, "scripts/bisect_kernel_cost.py:15",
                        {f"{mode}_{dt}": per_conv(m) for (mode, dt), m in cost.items()
                         if mode != "full"}),
        *kernel_entries("gemm_rate", "vst_torch/csrc/gemm_rate.cu", "scripts/bisect_mxu.py:15",
                        gemm),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
