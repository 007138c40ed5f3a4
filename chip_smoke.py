#!/usr/bin/env python3
"""Time the vst_torch port's Hopper kernels on one NVIDIA GPU, and drive each
command of its CLI once on the card.

    python3 chip_smoke.py                               # every phase, from the repository root
    python3 chip_smoke.py build kernel demos            # only the phases named

Time on a path that a benchmark cell runs is ``vstbench``'s, and the card's
results against the CPU and the plain versions are ``tests/test_torch_cuda.py``'s
(``pytest -m cuda``); this script keeps what neither does. Phases, one JSON
line each; any failure raises and the exit code is not 0:

The kernel table (``PERF.md`` §6). Each timing follows a check of the kernel
against its plain version on the same inputs; bounds are
``vstbench.counts``' (the lookup's bytes and operations, the backward's bytes,
the H100's peaks) or the probes' own (``vst_torch/core/roofline.py``).

1. build: compile the four kernel sources (vst_torch/csrc/{corr_lookup,
   pad_conv3x3,gemm_rate,sepconv_gru}.cu), one nvcc each, all at once, into
   vst_torch/_build/; ptxas registers and spills per library.
2. kernel: corr_lookup against its plain version lookup_pyramid, bit for
   bit (max |Δ| = 0), at the Sintel tcl2 shape, a ragged shape, the
   CPU-test shape, radius 3, 1 and 2 levels, windows all outside their maps,
   RAFT's chairs stage and one 432×1024 pair; at the tcl2 shape its time
   beside the plain version's, the library yardstick's (the reference
   CorrBlock's F.grid_sample per level), its bound and the bytes of the
   32-byte sectors its windows touch, its device time alone (device_ms, a
   CUDA graph of calls each reading more than L2 holds) and the host's time
   to issue a call (host_ms). Then at RAFT's chairs stage (B = 10, 46×62
   queries) the forward bit for bit and the backward kernel's level
   gradients against the plain autograd's (≤ 1e-6 of max |want|), then the
   forward, the backward kernel alone, the backward through autograd and
   the plain autograd timed, beside the backward's bound.
3. trunk_conv: pad_conv3x3 (modes full and mxu_only) against its plain
   version at the trunk shape 1×109×256×128, a ragged 2×13×37×64, the
   CPU-test shapes, C_in ≠ C_out, C_out = 8 and 136, batch 3 and H = 2, f32
   (≤ 1e-4 absolute) and bf16 (≤ 1e-3 + 2⁻⁷·|plain|); then the probe
   vst_torch.probes.bisect_im2col: ms/conv over a host-launched 10-conv
   chain, the device time alone (device_ms, a CUDA graph over inputs cold
   in L2), the host's time to issue a call (host_ms), plain, cuDNN and
   bound.
4. kernel_cost: shift_only and dma_only against their plain versions at
   the same ten shapes, bit for bit (max |Δ| = 0: the same f32 sums in the
   same order, one rounding), then the probe
   vst_torch.probes.bisect_kernel_cost, the four modes timed as in phase 3,
   each beside one library call that computes it.
5. gemm_rate: the kernel against its plain version at every (K, N) of the
   sweep (f32 ≤ 1e-5·max|y|, bf16 ≤ 2⁻⁷·max|y|), then the probe
   vst_torch.probes.bisect_mxu: ms, TF/s, bound, one cuBLAS call of depth
   64·K (library_ms) and 64 × cuBLAS (library_x64_ms); the kernels line
   lists K = N = 128 and K = 1152, N = 128, each with its own max |Δ| and
   the launches of its timing.
5b. sepconv_gru: RAFT's SepConvGRU kernels gru_zr and gru_q at the Sintel
   shape (batch 4, 54×128, x of 256 channels), each pass (1×5, 5×1), the
   gates at PyTorch's default init: each kernel against its plain version on
   the inputs it then times (≤ 1e-6 + 1e-5·|plain|), then ms (a chain of 20
   host-launched calls, CUDA events, best of 3 windows), device_ms (one CUDA
   graph over copies of x, cold in L2), plain_ms (the plain version with
   cuDNN off, as RAFT runs it), library_ms (the gate convolutions as the port
   ran them before the kernels: F.conv2d with cuDNN off on the concatenated
   input), bound_ms (2·M·K·N operations over the f32 peak) and bound_pct
   (bound_ms over device_ms); and pack_ms, the gates' packing that each
   half-step does before its launches.

The CLI's card smoke: each command through ``vst_torch.cli.__main__.main``,
its JSON line (or results) recorded as it returns them, every value finite,
and the kernels' launches counted over the command: a path that should
launch the lookup launched it (exactly, where the count is known), a path
that runs RAFT's float32 update block outside autograd launched the
SepConvGRU kernels exactly 4 times for each lookup (2 passes × gru_zr and
gru_q), and a path that should not launched nothing; `launches_by_path`
in the kernels line gives both counts of each path.

6. eval_sintel: `eval-sintel` at 436×1024 for johnson and ruder, 3 styles:
   on the synthetic clip with its flow oracle (no launch), then with
   `--sintel-dir` on a Sintel-layout tree of an 8-frame synthetic clip
   written as PNGs (the loader crops it to 432×1024), RAFT at 20
   iterations through the kernel (exactly 420 launches; Ruder 600), and 4
   launches of the SepConvGRU kernels for each lookup.
7. raft_bf16: `bench-raft` with all five variants at 436×1024: exactly 20
   lookups for each of its RAFT calls, 4 SepConvGRU launches for each lookup
   of the variants with a float32 update block (f32, bf16_enc, f32_pad64)
   and none for the bf16 ones.
8. stylize_video: `stylize-video` at 436×1024 on 24 synthetic frames, f32 at
   batch 1 and bf16 at batch 8: 24 PNGs and a video (a GIF through PIL on a
   machine without imageio) each.
9. bench: vst_torch.bench's program on one Sintel-sized frame in each
   dtype (finite, in [0, 1]), then the benchmark on f32_b1, bf16_b1 and
   bf16_b8 (the `bench` command runs all six).
10. train_faststyle: `train-faststyle` for each method at 256², batch 16, 8
   steps from the device cache over a 64-sample FC2-layout corpus.
11. obst: `eval-obst` at 436×1024 on one synthetic 6-frame clip, style 0,
   [50, 40, 30], RAFT through the kernel: λ = 0 and 2000 in float32, then
   λ = 2000 with --obst-bf16 (TCL-ST at λ = 2000 below λ = 0); 4 SepConvGRU
   launches a lookup.
12. fc2_metrics: `eval-fc2` at 256² on 4 synthetic batches of 4: --family
   obst (λ 0 and 2000, --iters-pyr 5 5 5), --family faststyle --method
   johnson (--num-outs 3) and --method ruder.
13. stargan: `eval-sintel --family stargan2` (vst's 256-pixel
   configuration, the EMA nets, 3 styles) and `--family stargan` with
   `--sintel-dir` on phase 6's tree; `train-stargan2` at 256², batch 8, 4
   domains, AdvCon, 6 iterations from the device cache over a 32-sample
   corpus in f32 and in bf16; `train-stargan` at 128², batch 16; `eval-fc2 --family
   stargan2` (latent and reference) and `--family stargan` at 256². The
   eval-sintel runs launch 4 SepConvGRU kernels a lookup; the trainers and
   eval-fc2 launch nothing.
14. cyclegan: `train-cyclegan` for each variant at 256², batch 4, ngf = ndf
   = 64, RAFT 20 iterations, 6 iterations from the device cache, `--sid 1`,
   in f32 and, for cyclegan and mogan, bf16 (`corr_lookup` launched exactly
   20 × the RAFT calls: MoGAN 600, 720 in bf16, ConGAN 480, the others 0;
   RAFT's flows run outside autograd, so 4 SepConvGRU launches a lookup);
   `eval-sintel --family cyclegan` on the f32 cyclegan, mogan and congan
   checkpoints over phase 6's tree (exactly 420 launches, 1680 SepConvGRU).
15. datagen: `datagen-corpus` at 256², batch 16, 16 pairs and 3 domains,
   with `--styler procedural` and `--styler gatys` (the tree's layout, one
   batch read through the device cache and CycleGANFC2Dataset);
   `datagen-fc2` (64 samples at 256²) and `datagen-styled` (4 samples at
   64²).
16. raft_train: `train-raft` at RAFT's chairs stage (10×368×496, 12
   iterations) for 3 steps over a FlyingChairs-layout tree of 16 synthetic
   affine-motion pairs at 384×512 with their exact flows: exactly 12
   launches of the lookup and 12 of its backward kernel a step, no plain
   backward, no launch of the SepConvGRU kernels (autograd records the GRU),
   every loss finite.
17. demos: `demo-web` through its classes (Huang, 3 styles, 436×1024, on a
   server bound to port 0, over its 48-frame synthetic clip): the page, the
   controls (style 1 at strength 0.5, half scale for the second half, then
   sid −1), the state (48 frames), a JPEG frame and a snapshot; `demo` at
   436×1024, 24 frames; `align-faces` on 8 synthetic 256² scenes written as
   PNGs.
18. parallel: `python -m vst_torch.parallel.dryrun 1` on NCCL in a
   subprocess (exit 0 and vst's line).

Phase names on the command line run only those phases (all of them without
one). Then each phase's seconds, the card's name and power limit
(nvidia-smi), the kernels line (a kernel whose phase did not run has null
numbers) and the result line. Float32 with TF32 off. Weights and inputs are
random, from seeds. Needs one CUDA device; exits 1 without one.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from http.server import ThreadingHTTPServer
from urllib.request import Request, urlopen

import numpy as np
import torch
import torch.nn.functional as F

from vst_torch import bench, set_f32_precision
from vst_torch.cli.__main__ import RAFT_VARIANTS, SLOPE_VARIANTS
from vst_torch.cli.__main__ import main as cli_main
from vst_torch.cli.webdemo import WebDemo
from vst_torch.cli.webdemo import make_handler as make_web_handler
from vst_torch.core.timing import cold_pool, graph_ms, host_ms
from vst_torch.data.datagen import generate_fc2_corpus, pack_fc2_npy
from vst_torch.data.synthetic import _scene as scene
from vst_torch.data.synthetic import synthetic_batch
from vst_torch.eval.video import write_png
from vst_torch.flow.corr import build_pyramid, lookup_pyramid
from vst_torch.flow.io import write_flo
from vst_torch.flow.raft import SepConvGRU, coords_grid
from vst_torch.kernels import _nvcc
from vst_torch.kernels import corr_lookup as corr_lookup_module
from vst_torch.kernels import gemm_rate as gemm_rate_module
from vst_torch.kernels import pad_conv3x3 as pad_conv3x3_module
from vst_torch.kernels import sepconv_gru as sepconv_gru_module
from vst_torch.kernels.corr_lookup import corr_lookup
from vst_torch.kernels.gemm_rate import gemm_rate, gemm_rate_plain
from vst_torch.kernels.pad_conv3x3 import MODES, dtype_name, pad_conv3x3, pad_conv3x3_plain
from vst_torch.kernels.sepconv_gru import (gru_q, gru_q_plain, gru_zr, gru_zr_plain, pack_gates,
                                           sepconv_gru)
from vst_torch.nn.conv import cudnn_enabled
from vst_torch.probes import bisect_im2col, bisect_kernel_cost, bisect_mxu
from vstbench.counts.lookup import lookup_bytes_ops
from vstbench.counts.lookup_bwd import lookup_bwd_bytes
from vstbench.counts.peaks import PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S

RADIUS = 4
LEVELS = 4
KERNEL_ERR = 0.0  # corr_lookup against lookup_pyramid: same operation order, bit for bit
# the backward kernel's level gradients against the plain autograd's, of
# max |want|: a pixel sums at most 4 products (9 where corners round onto it)
# in another order than autograd's sort
LOOKUP_BWD_RTOL = 1e-6
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
SINTEL_HW = (436, 1024)  # a Sintel frame; the eval harness crops it to 432 rows
VIDEO_FRAMES = 24
KERNEL_SOURCES = ("corr_lookup", "pad_conv3x3", "gemm_rate", "sepconv_gru")
# SepConvGRU's kernels against their plain versions: f32 sums of 5 × 384
# products in another order than the im2col SGEMM's, then the pointwise math
GRU_ATOL, GRU_RTOL = 1e-6, 1e-5
GRU_SHAPE = (4, 54, 128)  # RAFT's 1/8 grid of a 432×1024 pair at the harness's batch
# eval-sintel on phase 6's 8-frame tree, RAFT at 20 iterations: the harness's
# 21 RAFT calls (12 at batch 2, 9 at batch 4); Ruder's driver 30 (10 a style)
EVAL_SINTEL_LAUNCHES = {"johnson": 20 * 21, "ruder": 20 * 30}
# SepConvGRU launches for each lookup of RAFT's float32 update block outside
# autograd: 2 passes × gru_zr and gru_q
GRU_PER_LOOKUP = 4
# bench-raft's RAFT calls of each variant at 20 iterations: the flow's, then
# for each batch multiple (3 for SLOPE_VARIANTS) a warm-up and 3 windows of 5
BENCH_RAFT_CALLS = {v: 1 + (3 if v in SLOPE_VARIANTS else 1) * (1 + 3 * 5)
                    for v in RAFT_VARIANTS}
CHAIRS_BATCH, CHAIRS_CROP = 10, (368, 496)  # RAFT's chairs stage (train_standard.sh)
CHAIRS_HW, CHAIRS_PAIRS = (384, 512), 16  # FlyingChairs' own frame size
CHAIRS_ITERS, CHAIRS_STEPS = 12, 3
TRAIN_HW = (256, 256)  # train-faststyle at the README's size and batch
TRAIN_BATCH = 16
TRAIN_STEPS = 8
TRAIN_CORPUS = 64
OBST_FRAMES = 6  # TCL-LT needs a frame past the offset of 5
FC2_HW = (256, 256)
# every task of the 4 batches has 2 or more samples, so FID takes the
# sample-subspace path (a pile of one takes a 2048² sqrtm on the host)
FC2_SEED = 14
FC2_OBST_ITERS = (5, 5, 5)
SG2_HW, SG2_BATCH = (256, 256), 8  # the README's StarGAN v2 configuration, 4 domains
SG1_HW, SG1_BATCH = (128, 128), 16
GAN_ITERS = 6
GAN_DT_ITERS = 10  # the GAN eval-sintel's DT chain
GAN_CORPUS = 32
CG_HW, CG_BATCH = (256, 256), 4  # the repo's CycleGAN runs (scripts/train_queue.sh:36-49)
CG_VARIANTS = ("cyclegan", "cyclegan_con", "mogan", "congan")
# RAFT calls an E step, an M step (a bf16 MoGAN E step makes 2 more)
CG_RAFT_CALLS = {"cyclegan": (0, 0), "cyclegan_con": (0, 0), "mogan": (6, 4), "congan": (4, 0)}
DG_HW = (256, 256)  # datagen-corpus at the corpus's own size, vst's OBST batch
DG_PAIRS, DG_BATCH, DG_DOMAINS = 16, 16, 3
DG_ITERS = (30, 25, 20)
DEMO_STYLES, DEMO_FRAMES = 3, 48  # Huang's 3 styles; the web demo's 48-frame synthetic clip
DEMO_CLI_FRAMES = 24
FACE_HW, ALIGN_IMAGES = 256, 8
DRYRUN_TIMEOUT_S = 300


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


def level_hw(pyramid):
    return [tuple(t.shape[-2:]) for t in pyramid]


def lookup_sector_bytes(pyramid, coords, r):
    """Bytes of the 32-byte sectors this run's windows touch: each in-bounds
    row of every query's (2r+2)² patch, rounded out to whole sectors (each
    level's tensor starts on a 256-byte boundary), plus coords and output as
    vstbench.counts.lookup counts them. A window row of 10 floats spans 2–3
    sectors."""
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


def finite_positive(means, what):
    if not all(math.isfinite(v) and v > 0 for v in means.values()):
        raise AssertionError(f"{what}: means not finite and positive: {means}")
    return means


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven (and
    the lookup's plain backward passes, which launch no kernel)."""
    corr_lookup.launches = 0
    corr_lookup.backward_launches = 0
    corr_lookup.plain_backwards = 0
    pad_conv3x3.launches.clear()
    gemm_rate.launches.clear()
    sepconv_gru.launches = 0


def require_launches(counter, keys, path):
    missing = [k for k in keys if counter[k] <= 0]
    if missing:
        raise AssertionError(f"{path} never launched its kernel for {missing}")
    return {k: counter[k] for k in keys}


def kernel_launches():
    return {"corr_lookup": corr_lookup.launches,
            "pad_conv3x3": sum(pad_conv3x3.launches.values()),
            "gemm_rate": sum(gemm_rate.launches.values()),
            "sepconv_gru": sepconv_gru.launches}


def exact_launches(path, lookups, gru):
    """The kernels' launches since the last reset, which must be ``lookups``
    of the lookup, ``gru`` of the SepConvGRU kernels and none of the others:
    the path's entry of ``launches_by_path``."""
    want = {"corr_lookup": lookups, "pad_conv3x3": 0, "gemm_rate": 0, "sepconv_gru": gru}
    launches = kernel_launches()
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, want {want}")
    return {"corr_lookup": lookups, "sepconv_gru": gru}


def raft_launches(path):
    """``exact_launches`` of a path whose RAFT calls all run the float32
    update block outside autograd: some lookups, and the SepConvGRU kernels
    ``GRU_PER_LOOKUP`` times each."""
    lookups = require_launches(kernel_launches(), ("corr_lookup",), path)["corr_lookup"]
    return exact_launches(path, lookups, GRU_PER_LOOKUP * lookups)


def no_launches(what):
    """The kernels' launches since the last reset, which must all be 0."""
    launches = kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"{what} launched a kernel: {launches}")
    return launches


def phase_build():
    t0 = time.perf_counter()
    logs = _nvcc.build_many(KERNEL_SOURCES)  # one nvcc per source, all at once
    seconds = time.perf_counter() - t0
    for module in (corr_lookup_module, pad_conv3x3_module, gemm_rate_module, sepconv_gru_module):
        module.build()
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


# (name, B, H, W, C, radius, levels, coords): the Sintel tcl2 shape, a ragged
# one, the CPU tests' shape, the CycleGAN trainers' (4×3×256²: Q = 4096,
# level 0 32²), RAFT small's radius (its 4×432×1024 call), 1 and 2 levels,
# flows that put every window outside its map ("outside", all zeros), RAFT's
# chairs stage (10×368×496: levels 46×62, 23×31, 11×15, 5×7) and
# precompute_lt_flow's one pair at 432×1024
LOOKUP_SHAPES = (("sintel_tcl2", 4, 54, 128, 256, 4, 4, "flow"),
                 ("ragged_55", 4, 55, 128, 256, 4, 4, "flow"),
                 ("cpu_test", 1, 8, 16, 32, 4, 4, "flow"),
                 ("train_256", 4, 32, 32, 256, 4, 4, "flow"),
                 ("radius_3", 4, 54, 128, 256, 3, 4, "flow"),
                 ("levels_1", 2, 55, 128, 64, 4, 1, "flow"),
                 ("levels_2", 2, 55, 128, 64, 3, 2, "flow"),
                 ("outside", 2, 54, 128, 64, 4, 4, "outside"),
                 ("chairs_368x496", 10, 46, 62, 256, 4, 4, "flow"),
                 ("lt_flow_432x1024", 1, 54, 128, 256, 4, 4, "flow"))


def lookup_at_chairs_stage(dev):
    """The lookup at the chairs stage's shape (B = 10, 46×62 queries, 4
    levels, radius 4): the kernel's forward held against the plain version
    on these inputs (KERNEL_ERR), then timed; the backward kernel's level
    gradients held against the plain autograd's (≤ LOOKUP_BWD_RTOL of
    max |want|), then timed alone (``bwd_kernel_ms``: the allocation and
    the launch, as the backward runs them), through autograd (``bwd_ms``:
    forward and backward less the forward) and as the plain autograd
    (``plain_bwd_ms``: its recompute and its gradient), each by CUDA events
    over 10 calls; ``bwd_bound_ms`` is the op's bytes at its boundary
    (vstbench.counts.lookup_bwd) over the memory rate."""
    B, h, w = CHAIRS_BATCH, CHAIRS_CROP[0] // 8, CHAIRS_CROP[1] // 8
    g = torch.Generator(device=dev).manual_seed(9)
    f1 = torch.randn(B, 256, h, w, generator=g, device=dev)
    f2 = torch.randn(B, 256, h, w, generator=g, device=dev)
    pyramid = [t.detach().requires_grad_() for t in build_pyramid(f1, f2, LEVELS)]
    coords = (coords_grid(B, h, w, device=dev)
              + 4.0 * torch.randn(B, 2, h, w, generator=g, device=dev)).contiguous()
    out = corr_lookup(pyramid, coords, RADIUS)
    with torch.no_grad():
        err = (out - lookup_pyramid(pyramid, coords, RADIUS)).abs().max().item()
    if err != KERNEL_ERR or not math.isfinite(err):
        raise AssertionError(f"corr_lookup vs plain at the chairs stage: {err} != {KERNEL_ERR}")
    upstream = torch.randn_like(out)

    def plain_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(lookup_pyramid(pyramid, coords, RADIUS), pyramid, upstream)

    got, want = torch.autograd.grad(out, pyramid, upstream), plain_bwd()
    bwd_abs = max((a - b).abs().max().item() for a, b in zip(got, want))
    bwd_err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
    if not bwd_err <= LOOKUP_BWD_RTOL:
        raise AssertionError(f"corr_lookup backward vs plain at the chairs stage: {bwd_err} > "
                             f"{LOOKUP_BWD_RTOL} of max |want|")
    del got, want
    needs = [False] + [True] * LEVELS
    reset_counts()
    fwd = time_ms(lambda: corr_lookup(pyramid, coords, RADIUS), 10)
    bwd = time_ms(lambda: torch.autograd.grad(corr_lookup(pyramid, coords, RADIUS), pyramid,
                                              upstream), 10) - fwd
    backward_launches = corr_lookup.backward_launches
    kernel = time_ms(lambda: corr_lookup_module._launch_grad(pyramid, coords, upstream, RADIUS,
                                                             needs), 10)
    plain = time_ms(plain_bwd, 10)
    nbytes = lookup_bwd_bytes(level_hw(pyramid), B * h * w, RADIUS)
    return {"shape": [B, h, w], "max_abs_err": err, "bwd_max_abs_err": bwd_abs,
            "bwd_max_rel_err": bwd_err, "fwd_ms": fwd,
            "bwd_ms": bwd, "bwd_kernel_ms": kernel, "plain_bwd_ms": plain,
            "backward_launches": backward_launches,
            "bwd_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bwd_bound_bytes": nbytes}


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
                reset_counts()
                entry["kernel_ms"] = time_ms(lambda: corr_lookup(pyramid, coords, r), 20)
                entry["launches"] = corr_lookup.launches
                entry["plain_ms"] = time_ms(lambda: lookup_pyramid(pyramid, coords, r), 5)
                entry["library_ms"] = time_ms(lambda: corrblock_grid_sample(pyramid, coords, r), 5)
            nbytes, ops = lookup_bytes_ops(level_hw(pyramid), coords, r)
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
            entry.update(bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
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
    record["backward_at_chairs_stage"] = backward = lookup_at_chairs_stage(dev)
    emit(record)
    return worst, timing, backward


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


def phase_kernel_cost(dev, weighted_errs=None):
    """``weighted_errs``: phase 3's max |Δ| of full and mxu_only, checked here
    when phase 3 did not run."""
    if weighted_errs is None:
        weighted_errs = check_pad_conv3x3(dev, ("full", "mxu_only"), CONV_SHAPES)
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


def best_ms(fn, reps: int = 20, windows: int = 3) -> float:
    """The best of ``windows`` windows of ``time_ms``."""
    return min(time_ms(fn, reps) for _ in range(windows))


def phase_sepconv_gru(dev):
    """``gru_zr`` and ``gru_q`` of each pass at ``GRU_SHAPE``, each checked
    against its plain version and then timed (module docstring, 5b)."""
    B, H, W = GRU_SHAPE
    torch.manual_seed(21)
    gru = SepConvGRU(128, 256).to(dev)
    g = torch.Generator(device=dev).manual_seed(22)
    h = torch.tanh(torch.randn(B, 128, H, W, generator=g, device=dev))
    x = torch.relu(torch.randn(B, 256, H, W, generator=g, device=dev))
    pool = cold_pool(x)
    ops = 2 * B * H * W * 5 * 384  # operations an output channel
    measured, pack_ms = {}, {}
    with torch.no_grad():
        for tag, name in (("1", "1x5"), ("2", "5x1")):
            convz, convr, convq = (getattr(gru, f"conv{k}{tag}") for k in "zrq")
            gates = pack_gates(convz, convr, convq)
            with cudnn_enabled(False):
                z_want, rh_want = gru_zr_plain(h, x, convz, convr)
                h_want = gru_q_plain(h, x, z_want, rh_want, convq)
            z, rh = gru_zr(h, x, gates)
            h_got = gru_q(h, x, z_want, rh_want, gates)
            torch.cuda.synchronize()
            errs = {}
            for kernel, pairs in (("gru_zr", ((z, z_want), (rh, rh_want))),
                                  ("gru_q", ((h_got, h_want),))):
                for got, want in pairs:
                    diff = (got - want).abs()
                    if not bool((diff <= GRU_ATOL + GRU_RTOL * want.abs()).all()):
                        raise AssertionError(f"{kernel} {name} vs plain: max |Δ| "
                                             f"{diff.max().item()}")
                errs[kernel] = max(float((a - b).abs().max()) for a, b in pairs)

            def library_zr():
                hx = torch.cat([h, x], 1)
                return convz(hx), convr(hx)

            runs = {"gru_zr": (lambda: gru_zr(h, x, gates), lambda xi: gru_zr(h, xi, gates),
                               lambda: gru_zr_plain(h, x, convz, convr), library_zr, 256),
                    "gru_q": (lambda: gru_q(h, x, z, rh, gates),
                              lambda xi: gru_q(h, xi, z, rh, gates),
                              lambda: gru_q_plain(h, x, z, rh, convq),
                              lambda: convq(torch.cat([rh, x], 1)), 128)}
            for kernel, (fn, graph_fn, plain, library, n_out) in runs.items():
                reset_counts()
                ms = best_ms(fn)
                launches = sepconv_gru.launches
                with cudnn_enabled(False):
                    plain_ms, library_ms = best_ms(plain, 5), best_ms(library, 5)
                bound = ops * n_out / PEAK_F32_OPS_PER_S * 1e3
                device_ms = graph_ms(graph_fn, pool, 5)
                measured[f"{kernel}_{name}"] = {
                    "launches": launches, "max_abs_err": errs[kernel], "ms": ms,
                    "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound, "bound_by": "operations",
                    "bound_pct": 100 * bound / device_ms}
            pack_ms[name] = best_ms(lambda: pack_gates(convz, convr, convq))
    emit({"phase": "sepconv_gru", "shape": list(GRU_SHAPE), "kernels": measured,
          "pack_ms": pack_ms})
    return measured


def written_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def phase_eval_sintel(dev):
    """The eval-sintel command for Johnson and Ruder at the Sintel size, on
    the synthetic clip with its exact flows (no launch) and on a Sintel tree
    through RAFT (exactly ``EVAL_SINTEL_LAUNCHES``, and ``GRU_PER_LOOKUP``
    SepConvGRU launches for each)."""
    record = {"phase": "eval_sintel", "cli": {}}
    launches = {}
    sintel = sintel_tree()
    for method in ("johnson", "ruder"):
        for flow, extra in (("oracle", ["--hw", *map(str, SINTEL_HW)]),
                            ("raft", ["--sintel-dir", sintel.name])):
            reset_counts()
            with tempfile.TemporaryDirectory() as out_dir:
                res = cli_main(["eval-sintel", "--method", method, *extra, "--out-dir", out_dir])
                written = written_files(out_dir)
            want = EVAL_SINTEL_LAUNCHES[method] if flow == "raft" else 0
            counts = exact_launches(f"eval-sintel {method} ({flow})", want,
                                    GRU_PER_LOOKUP * want)
            means = finite_positive({k: res[k][f"{k}_mean"] for k in res},
                                    f"eval-sintel {method} ({flow})")
            record["cli"][f"{method}_{flow}"] = {**means, "written": written, "launches": counts}
        launches[f"eval_sintel_{method}"] = counts
    sintel.cleanup()
    emit(record)
    return launches


def phase_raft_bf16(dev):
    """bench-raft with its five variants at the Sintel size."""
    reset_counts()
    with tempfile.TemporaryDirectory() as out_dir:  # the command's own windows of 5 pairs
        cli_main(["bench-raft", "--hw", *map(str, SINTEL_HW), "--out-dir", out_dir])
        with open(f"{out_dir}/raft_timing.json") as f:
            results = json.load(f)
    f32_update = [v for v, (_, update, _) in RAFT_VARIANTS.items() if update is None]
    launches = exact_launches("bench-raft", 20 * sum(BENCH_RAFT_CALLS.values()),
                              GRU_PER_LOOKUP * 20 * sum(BENCH_RAFT_CALLS[v] for v in f32_update))
    timed = [v for k, v in results.items() if k.startswith("pair_ms_")]
    if not timed or not all(math.isfinite(t) and t > 0 for t in timed):
        raise AssertionError(f"bench-raft times not finite and positive: {results}")
    emit({"phase": "raft_bf16", "bench_raft": results, "launches": launches})
    return launches


def video_signature(path):
    """The file's kind by its first bytes: gif, mp4, or None."""
    with open(path, "rb") as f:
        head = f.read(12)
    return "gif" if head[:6] in (b"GIF87a", b"GIF89a") else "mp4" if head[4:8] == b"ftyp" else None


def png_signature(path):
    with open(path, "rb") as f:
        return f.read(8)


def phase_stylize_video(dev):
    """The stylize-video command on 24 synthetic Sintel-sized frames."""
    record = {"phase": "stylize_video", "runs": {}}
    for flags, batch in (((), 1), (("--bf16",), 8)):
        argv = ["stylize-video", "--hw", *map(str, SINTEL_HW), "--n-frames", str(VIDEO_FRAMES),
                "--batch-size", str(batch), *flags]
        with tempfile.TemporaryDirectory() as out_dir:
            line = cli_main([*argv, "--out-dir", out_dir])
            written = sorted(os.listdir(out_dir))
            pngs = [f for f in written if f.endswith(".png")]
            signatures = {png_signature(os.path.join(out_dir, f)) for f in pngs}
            kind = line["video"] and video_signature(line["video"])
        if (len(pngs) != VIDEO_FRAMES or line["frames"] != VIDEO_FRAMES
                or signatures != {b"\x89PNG\r\n\x1a\n"} or kind is None
                or not (math.isfinite(line["frames_per_sec"]) and line["frames_per_sec"] > 0)):
            raise AssertionError(f"stylize-video {line}: wrote {written}, video kind {kind}")
        record["runs"][f"{line['dtype']}_b{batch}"] = {
            **line, "video_kind": kind, "pngs": len(pngs),
            "other_files": [f for f in written if f not in pngs]}
    emit(record)


def phase_bench(dev):
    # the benchmark's program on one Sintel-sized frame: finite, in [0, 1]
    frame = synthetic_batch(1, (bench.H, bench.W))["imgs"][0, :1]
    frame = torch.from_numpy(frame.transpose(0, 3, 1, 2).copy())
    for dtype in DTYPES:
        net = bench.seeded_net(dtype, dev)
        with torch.no_grad():
            out = bench.make_stylize(net, torch.zeros((), dtype=torch.long, device=dev))(
                frame.to(dev, dtype)).float()
        if (out.shape != (1, 3, bench.H, bench.W) or not torch.isfinite(out).all()
                or out.min() < 0 or out.max() > 1):
            raise AssertionError(f"bench stylize {dtype}: output not finite in [0, 1] of shape")
    report = bench.run(bench.CONFIGS[:3], dev)
    timed = [*report["paths_ms"].values(), *report["paths_ms_fused"].values()]
    if not all(math.isfinite(t) and t > 0 for t in timed):
        raise AssertionError(f"bench times not finite and positive: {timed}")
    emit({"phase": "bench", "bench": report})


def phase_train_faststyle(dev):
    record = {"phase": "train_faststyle", "hw": list(TRAIN_HW), "batch": TRAIN_BATCH,
              "runs": {}}
    train = ["train-faststyle", "--hw", *map(str, TRAIN_HW), "--batch-size", str(TRAIN_BATCH),
             "--log-every", "5"]
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "fc2")
        pack_fc2_npy(corpus, TRAIN_CORPUS, TRAIN_HW)
        reset_counts()
        for method in ("johnson", "dumoulin", "huang", "reconet", "ruder"):
            res = cli_main([*train, "--method", method, "--steps", str(TRAIN_STEPS),
                            "--data-dir", corpus, "--device-cache", str(TRAIN_CORPUS),
                            "--out-dir", os.path.join(tmp, method)])
            if res["n_nonfinite"] or not all(math.isfinite(v) for v in res["losses"]):
                raise AssertionError(f"train-faststyle {method}: a loss is not finite")
            record["runs"][method] = {k: v for k, v in res.items() if k != "batch_ms"}
    record["kernel_launches"] = no_launches("the training path")
    emit(record)


def phase_obst(dev):
    """eval-obst at the Sintel size in f32 (λ 0, 2000) and bf16 (λ 2000)."""
    record = {"phase": "obst", "eval_obst": {}}
    argv = ["eval-obst", "--hw", *map(str, SINTEL_HW), "--n-videos", "1", "--n-frames",
            str(OBST_FRAMES), "--n-styles", "1", "--iters-pyr", "50", "40", "30"]
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
                record["eval_obst"][f"{summary['obst_dtype']}_lambda{lam}"] = entry
        written = written_files(tmp)
    launches = raft_launches("eval-obst")
    f32 = record["eval_obst"]
    if not f32["float32_lambda2000"]["TCL-ST_mean"] < f32["float32_lambda0"]["TCL-ST_mean"]:
        raise AssertionError(f"eval-obst: TCL-ST at λ=2000 not below λ=0: {f32}")
    record.update({"clip": [OBST_FRAMES, *SINTEL_HW], "styles": [0], "iters_pyr": [50, 40, 30],
                   "written": written, "launches": launches})
    emit(record)
    return launches


def fc2_run(argv, name):
    """One eval-fc2 command (``argv`` without --out-dir): its means (every one
    finite) and the files it wrote."""
    with tempfile.TemporaryDirectory() as out_dir:
        res = cli_main([*argv, "--out-dir", out_dir])
        written = written_files(out_dir)
    # OBST returns one table a λ, the others one table
    tables = ({f"lambda{lam}_": t for lam, t in res.items()} if name == "obst"
              else {"": res})
    means = {prefix + k: v for prefix, table in tables.items()
             for metric in table.values() for k, v in metric.items()
             if k.endswith("mean") and isinstance(v, float)}
    if not means or not all(math.isfinite(v) for v in means.values()):
        raise AssertionError(f"eval-fc2 {name}: means missing or not finite: {means}")
    return {"means": means, "written": written}


def phase_fc2_metrics(dev):
    """eval-fc2 at 256² on 4 synthetic batches of 4 for OBST, Johnson and
    Ruder."""
    record = {"phase": "fc2_metrics", "hw": list(FC2_HW), "runs": {}}
    argv = ["eval-fc2", "--hw", *map(str, FC2_HW), "--batch-size", "4", "--seed", str(FC2_SEED)]
    runs = {"obst": ["--family", "obst", "--iters-pyr", *map(str, FC2_OBST_ITERS)],
            "johnson": ["--family", "faststyle", "--method", "johnson", "--num-outs", "3"],
            "ruder": ["--family", "faststyle", "--method", "ruder"]}
    reset_counts()
    for name, flags in runs.items():
        record["runs"][name] = fc2_run([*argv, *flags], name)
    record["kernel_launches"] = no_launches("the FC2 paths")
    emit(record)


def sintel_tree():
    """A temporary Sintel-layout tree of an 8-frame synthetic clip at
    436×1024 as PNGs (the loader crops it to 432×1024), so that eval-sintel
    runs RAFT (without --sintel-dir it scores the clip with its exact flow)."""
    sintel = tempfile.TemporaryDirectory()
    clip = os.path.join(sintel.name, "training", "final", "synthetic_1")
    os.makedirs(clip)
    for i, frame in enumerate(synthetic_batch(1, SINTEL_HW, n_frames=8)["imgs"][0]):
        write_png(os.path.join(clip, f"frame_{i + 1:04d}.png"),
                  np.round(frame * 255).astype(np.uint8))
    return sintel


def phase_stargan(dev):
    record = {"phase": "stargan", "eval_sintel": {}, "train": {}, "fc2": {}}
    launches = {}
    sintel = sintel_tree()
    for family in ("stargan2", "stargan"):
        reset_counts()
        with tempfile.TemporaryDirectory() as out_dir:
            res = cli_main(["eval-sintel", "--family", family, "--sintel-dir", sintel.name,
                            "--dt-iters", str(GAN_DT_ITERS), "--out-dir", out_dir])
        launches[family] = raft_launches(f"eval-sintel --family {family}")
        record["eval_sintel"][family] = {
            **finite_positive({k: res[k][f"{k}_mean"] for k in res}, f"eval-sintel {family}"),
            "launches": launches[family]}
    sintel.cleanup()

    with tempfile.TemporaryDirectory() as tmp:
        corpora = {hw: os.path.join(tmp, f"styled_{hw[0]}") for hw in (SG2_HW, SG1_HW)}
        for hw, corpus in corpora.items():
            generate_fc2_corpus(corpus, GAN_CORPUS, hw=hw, styler="procedural", device=dev)
        common = ["--device-cache", str(GAN_CORPUS), "--steps", str(GAN_ITERS), "--log-every",
                  "5", "--ckpt-every", str(10 * GAN_ITERS)]
        sg2 = ["train-stargan2", "--hw", *map(str, SG2_HW), "--batch-size", str(SG2_BATCH),
               "--lambda-tcl", "100", "--sample-every", str(GAN_ITERS), "--data-dir",
               corpora[SG2_HW]]
        runs = {"stargan2_f32": sg2, "stargan2_bf16": [*sg2, "--compute-dtype", "bfloat16"],
                "stargan": ["train-stargan", "--hw", *map(str, SG1_HW), "--batch-size",
                            str(SG1_BATCH), "--data-dir", corpora[SG1_HW]]}
        reset_counts()
        for name, argv in runs.items():
            res = cli_main([*argv, *common, "--out-dir", os.path.join(tmp, name)])
            if res["n_nonfinite"]:
                raise AssertionError(f"{name}: a loss is not finite: {res['last_losses']}")
            record["train"][name] = {k: v for k, v in res.items() if k != "losses"}
    train_launches = no_launches("the StarGAN training paths")

    argv = ["eval-fc2", "--hw", *map(str, FC2_HW), "--batch-size", "4", "--seed", str(FC2_SEED),
            "--num-outs", "3"]
    fc2_runs = {"stargan2_latent": ["--family", "stargan2", "--mode", "latent"],
                "stargan2_reference": ["--family", "stargan2", "--mode", "reference"],
                "stargan": ["--family", "stargan"]}
    reset_counts()
    for name, flags in fc2_runs.items():
        record["fc2"][name] = fc2_run([*argv, *flags], name)
    record["kernel_launches"] = {"train": train_launches,
                                 "fc2": no_launches("the StarGAN FC2 paths")}
    emit(record)
    return launches


def phase_cyclegan(dev):
    record = {"phase": "cyclegan", "train": {}, "launches": {}}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "styled")
        generate_fc2_corpus(corpus, GAN_CORPUS, hw=CG_HW, styler="procedural", device=dev)
        common = ["--hw", *map(str, CG_HW), "--batch-size", str(CG_BATCH), "--steps",
                  str(GAN_ITERS), "--log-every", "5", "--ckpt-every", str(10 * GAN_ITERS),
                  "--data-dir", corpus, "--device-cache", str(GAN_CORPUS), "--sid", "1"]
        runs = {f"{v}_f32": [v] for v in CG_VARIANTS}
        runs.update(cyclegan_bf16=["cyclegan", "--compute-dtype", "bfloat16"],
                    mogan_bf16=["mogan", "--compute-dtype", "bfloat16"])
        for name, (variant, *extra) in runs.items():
            reset_counts()
            res = cli_main(["train-cyclegan", "--variant", variant, *common, *extra,
                            "--out-dir", os.path.join(tmp, name)])
            e_calls, m_calls = CG_RAFT_CALLS[variant]
            if variant == "mogan" and extra:  # the loss's flows of the cast frames
                e_calls += 2
            steps_e = (GAN_ITERS + 1) // 2 if variant == "mogan" else GAN_ITERS
            want = 20 * (steps_e * e_calls + (GAN_ITERS - steps_e) * m_calls)
            counts = exact_launches(f"train-cyclegan {name}", want, GRU_PER_LOOKUP * want)
            if res["n_nonfinite"]:
                raise AssertionError(f"{name}: a loss is not finite: {res['last_losses']}")
            launches[f"train_{name}"] = counts
            record["train"][name] = {k: v for k, v in res.items()
                                     if k not in ("losses", "checkpoints")}

        specs = ",".join(f"{v}:{os.path.join(tmp, v + '_f32')}"
                         for v in ("cyclegan", "mogan", "congan"))
        sintel = sintel_tree()
        reset_counts()
        with tempfile.TemporaryDirectory() as out_dir:
            res = cli_main(["eval-sintel", "--family", "cyclegan", "--sintel-dir", sintel.name,
                            "--ckpt-dir", specs, "--dt-iters", str(GAN_DT_ITERS),
                            "--out-dir", out_dir])
        sintel.cleanup()
        counts = exact_launches("eval-sintel --family cyclegan", 420, GRU_PER_LOOKUP * 420)
        launches["eval_sintel_cyclegan"] = counts
        record["eval_sintel"] = {
            **finite_positive({k: res[k][f"{k}_mean"] for k in res}, "eval-sintel cyclegan"),
            "launches": counts}
    record["launches"] = launches
    emit(record)
    return launches


def corpus_layout(root, n, hw, domains):
    """The corpus tree that the trainers read: (1, H, W, 9) finite .npy
    files and 256² JPEGs for every domain of both frames."""
    from PIL import Image

    npys = sorted(os.listdir(os.path.join(root, "DATAFiles")))
    if npys != [f"{i:07d}.npy" for i in range(n)]:
        raise AssertionError(f"corpus DATAFiles: {npys}")
    for name in npys:
        x = np.load(os.path.join(root, "DATAFiles", name))
        if x.shape != (1, *hw, 9) or not np.isfinite(x).all():
            raise AssertionError(f"corpus {name}: {x.shape} or not finite")
    for tree, suffix in (("styled-files", ".jpg"), ("styled-files3", "_2.jpg")):
        for k in range(domains + 1):
            names = sorted(os.listdir(os.path.join(root, tree, f"style{k}")))
            if names != [f"{i:07d}{suffix}" for i in range(n)]:
                raise AssertionError(f"corpus {tree}/style{k}: {names}")
            with Image.open(os.path.join(root, tree, f"style{k}", names[-1])) as im:
                if im.size != hw[::-1] or im.mode != "RGB":
                    raise AssertionError(f"corpus {tree}/style{k}: {im.size} {im.mode}")


def corpus_reads(root, dev):
    """One batch of the corpus through what the trainers read it with: the
    device cache (StarGAN, CycleGAN) and CycleGANFC2Dataset."""
    from vst_torch.data.device_cache import DeviceStyledCache
    from vst_torch.data.fc2 import CycleGANFC2Dataset

    batch = DeviceStyledCache(root, num_dom=DG_DOMAINS + 1, seed=1, device=dev).sample(4)
    shapes = {k: list(v.shape) for k, v in batch.items()}
    if not all(torch.isfinite(v.float()).all() for v in batch.values()):
        raise AssertionError("device cache batch not finite")
    cg = next(CycleGANFC2Dataset(root, sid=1, with_flow=True).epoch(4, seed=0))
    if not all(np.isfinite(v).all() for v in cg.values()):
        raise AssertionError("CycleGANFC2Dataset batch not finite")
    return {"device_cache": shapes, "cyclegan_fc2": {k: list(v.shape) for k, v in cg.items()}}


def phase_datagen(dev):
    """datagen-corpus (both stylers), datagen-fc2, datagen-styled."""
    from vst_torch.data.device_cache import DeviceFC2Cache

    record = {"phase": "datagen", "corpus": {}}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        for styler in ("procedural", "gatys"):
            root = os.path.join(tmp, styler)
            cli_main(["datagen-corpus", "--n-samples", str(DG_PAIRS), "--hw", *map(str, DG_HW),
                      "--batch-size", str(DG_BATCH), "--styler", styler,
                      "--iters", *map(str, DG_ITERS), "--out-dir", root])
            corpus_layout(root, DG_PAIRS, DG_HW, DG_DOMAINS)
            record["corpus"][styler] = {"styled_images": DG_PAIRS * 2 * DG_DOMAINS,
                                        "reads": corpus_reads(root, dev)}

        fc2 = os.path.join(tmp, "fc2")
        cli_main(["datagen-fc2", "--n-samples", "64", "--hw", *map(str, DG_HW), "--out-dir", fc2])
        got = DeviceFC2Cache(fc2, device=dev).sample(4)
        record["fc2"] = {"files": len(os.listdir(fc2)),
                         "batch": {k: list(v.shape) for k, v in got.items()}}
        styled = os.path.join(tmp, "styled")
        cli_main(["datagen-styled", "--n-samples", "4", "--hw", "64", "64", "--out-dir", styled])
        record["styled"] = {d: len(os.listdir(os.path.join(styled, d)))
                            for d in sorted(os.listdir(styled))}
        if record["fc2"]["files"] != 64 or record["styled"] != {f"style{k}": 4 for k in range(4)}:
            raise AssertionError(f"datagen-fc2 / datagen-styled wrote {record['fc2']}, "
                                 f"{record['styled']}")
    record["kernel_launches"] = no_launches("the datagen commands")
    emit(record)


def chairs_tree(root):
    """A FlyingChairs-layout tree (``data/*_img1.ppm``, ``*_img2.ppm``,
    ``*_flow.flo``) of affine-motion pairs at 384×512, each pair's flow
    exact: img1 is the synthetic clip's second frame, img2 its first, and
    the flow the clip's backward flow between them."""
    from PIL import Image

    os.makedirs(os.path.join(root, "data"))
    for i in range(CHAIRS_PAIRS):
        pair = synthetic_batch(1, CHAIRS_HW, seed=i + 1)
        for k, frame in enumerate((pair["imgs"][0, 1], pair["imgs"][0, 0])):
            Image.fromarray(np.round(frame * 255).astype(np.uint8)).save(
                os.path.join(root, "data", f"{i:05d}_img{k + 1}.ppm"))
        write_flo(os.path.join(root, "data", f"{i:05d}_flow.flo"), pair["flows"][0, 0])


def phase_raft_train(dev):
    """train-raft at the chairs stage (10×368×496, 12 iterations) for 3
    steps: exactly 12 launches of the lookup and 12 of its backward kernel
    a step, and no plain backward."""
    with tempfile.TemporaryDirectory() as tmp:
        chairs_tree(os.path.join(tmp, "chairs"))
        reset_counts()
        res = cli_main(["train-raft", "--data-dir", os.path.join(tmp, "chairs"),
                        "--image-size", *map(str, CHAIRS_CROP), "--batch-size", str(CHAIRS_BATCH),
                        "--iters", str(CHAIRS_ITERS), "--steps", str(CHAIRS_STEPS),
                        "--log-every", "1", "--out-dir", os.path.join(tmp, "raft")])
        written = written_files(os.path.join(tmp, "raft"))
    want = CHAIRS_ITERS * CHAIRS_STEPS
    launches = exact_launches("train-raft", want, 0)  # autograd records the GRU
    counts = {"launches": want, "backward_launches": corr_lookup.backward_launches,
              "plain_backwards": corr_lookup.plain_backwards}
    if counts != {"launches": want, "backward_launches": want, "plain_backwards": 0}:
        raise AssertionError(f"train-raft: corr_lookup {counts}, want {want} launches and "
                             f"{want} backward launches, 0 plain backwards")
    if res["n_nonfinite"] or res["iterations"] != CHAIRS_STEPS:
        raise AssertionError(f"train-raft: a loss is not finite: {res['losses']}")
    emit({"phase": "raft_train", "train_raft": {k: v for k, v in res.items() if k != "losses"},
          "written": written, "corr_lookup": counts})
    return launches


def http(base, path, payload=None):
    """The body of one request: a GET, or a POST of ``payload`` as JSON."""
    data = None if payload is None else json.dumps(payload).encode()
    with urlopen(Request(base + path, data=data, method="GET" if data is None else "POST"),
                 timeout=120) as r:
        return r.read()


def demo_web_run(dev, out_dir):
    """The demo-web server over vst's 48-frame synthetic clip at 436×1024,
    Huang with 3 styles, driven as vst's own test drives it: the page, the
    controls (style 1 at strength 0.5; half scale for the second half; then
    sid −1), the state, a frame and a snapshot."""
    demo = WebDemo(method="huang", n_styles=DEMO_STYLES, hw=SINTEL_HW, out_path=out_dir, seed=0,
                   device=dev)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_web_handler(demo))
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        page = http(base, "/")
        http(base, "/control", {"sid": 1})
        http(base, "/control", {"strength": 0.5})
        for upto, control in ((DEMO_FRAMES // 2, None), (DEMO_FRAMES - 4, {"scale": 0.5}),
                              (DEMO_FRAMES, {"sid": -1})):
            if control:
                http(base, "/control", control)
            loop = threading.Thread(target=demo.loop, kwargs={"max_frames": upto})
            loop.start()
            loop.join(300)
            if loop.is_alive():
                raise AssertionError(f"demo-web: the loop did not reach {upto} frames")
        state = http(base, "/state")
        frame = http(base, "/frame.jpg")
        snap = http(base, "/snapshot", {})
    finally:
        demo.stop()
        server.shutdown()
        server.server_close()
    state, saved = json.loads(state), json.loads(snap)["saved"]
    with open(saved, "rb") as f:
        snapshot = f.read()
    if (f"style {DEMO_STYLES}".encode() not in page or state["frames"] != DEMO_FRAMES
            or frame[:2] != b"\xff\xd8" or snapshot[:2] != b"\xff\xd8"):
        raise AssertionError(f"demo-web: state {state}, frame {frame[:4]}, snapshot "
                             f"{snapshot[:4]}")
    return {"hw": list(SINTEL_HW), "styles": DEMO_STYLES, "state": state,
            "jpeg_bytes": len(frame), "snapshot_bytes": len(snapshot)}


def phase_demos(dev):
    """demo-web, demo and align-faces at full width (see the module doc)."""
    record = {"phase": "demos"}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        record["demo_web"] = demo_web_run(dev, os.path.join(tmp, "web"))

        line = cli_main(["demo", "--hw", *map(str, SINTEL_HW), "--n-frames", str(DEMO_CLI_FRAMES),
                         "--out-dir", os.path.join(tmp, "demo")])
        kind = video_signature(line["video"])
        if line["frames"] != DEMO_CLI_FRAMES or line["hw"] != list(SINTEL_HW) or kind is None:
            raise AssertionError(f"demo: {line}, file kind {kind}")
        record["demo"] = {**line, "kind": kind, "bytes": os.path.getsize(line["video"])}

        faces_in, faces_out = os.path.join(tmp, "faces_in"), os.path.join(tmp, "faces_out")
        os.makedirs(faces_in)
        rng = np.random.RandomState(1)
        for i in range(ALIGN_IMAGES):
            write_png(os.path.join(faces_in, f"{i:04d}.png"),
                      (scene(rng, (FACE_HW, FACE_HW)) * 255).astype(np.uint8))
        line = cli_main(["align-faces", "--input-dir", faces_in, "--output-dir-align", faces_out,
                         "--img-size", str(FACE_HW)])
        written = sorted(os.listdir(faces_out))
        if line["aligned"] != ALIGN_IMAGES or written != sorted(os.listdir(faces_in)):
            raise AssertionError(f"align-faces: {line}, wrote {written}")
        record["align_faces"] = {**line, "written": len(written)}
    record["kernel_launches"] = no_launches("the demos")
    emit(record)


def phase_parallel(dev):
    """The NCCL dry run in a subprocess."""
    dryrun = subprocess.run([sys.executable, "-m", "vst_torch.parallel.dryrun", "1"],
                            capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    if dryrun.returncode != 0 or not dryrun.stdout.startswith("dryrun_multichip(1): ok"):
        raise AssertionError(f"dryrun 1: rc {dryrun.returncode}: {dryrun.stdout[-500:]} "
                             f"{dryrun.stderr[-1500:]}")
    emit({"phase": "parallel", "dryrun": {"rc": dryrun.returncode,
                                          "line": dryrun.stdout.strip()}})


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


def null_entries(name, source, replaces, variants):
    """The kernels line's entries of a kernel whose phase did not run: every
    measured value null."""
    return kernel_entries(name, source, replaces, {v: {
        k: None for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        for v in variants})


PHASES = ("build", "kernel", "trunk_conv", "kernel_cost", "gemm_rate", "sepconv_gru",
          "eval_sintel", "raft_bf16", "stylize_video", "bench", "train_faststyle", "obst",
          "fc2_metrics", "stargan", "cyclegan", "datagen", "raft_train", "demos", "parallel")


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        print(f"chip_smoke: unknown phase {unknown}; phases: {' '.join(PHASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    set_f32_precision()
    emit({"phase": "start", "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn": torch.backends.cudnn.version(), "device": torch.cuda.get_device_name(0),
          "tf32": False, "phases": names})

    seconds = {}

    def run(name, fn, *args):
        """Phase ``name`` if it was asked for (None otherwise), timed."""
        if name not in names:
            return None
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    run("build", phase_build)
    max_err, timing, backward = run("kernel", phase_kernel, dev) or (None, {}, {})
    trunk, weighted_errs = run("trunk_conv", phase_trunk_conv, dev) or (None, None)
    cost = run("kernel_cost", phase_kernel_cost, dev, weighted_errs)
    gemm = run("gemm_rate", phase_gemm_rate, dev)
    gru = run("sepconv_gru", phase_sepconv_gru, dev)
    by_path = run("eval_sintel", phase_eval_sintel, dev) or {}
    by_path["bench_raft"] = run("raft_bf16", phase_raft_bf16, dev)
    run("stylize_video", phase_stylize_video, dev)
    run("bench", phase_bench, dev)
    run("train_faststyle", phase_train_faststyle, dev)
    by_path["eval_obst"] = run("obst", phase_obst, dev)
    run("fc2_metrics", phase_fc2_metrics, dev)
    by_path.update({f"eval_sintel_{k}": v for k, v in (run("stargan", phase_stargan, dev)
                                                        or {}).items()})
    by_path.update(run("cyclegan", phase_cyclegan, dev) or {})
    run("datagen", phase_datagen, dev)
    by_path["raft_train"] = run("raft_train", phase_raft_train, dev)
    run("demos", phase_demos, dev)
    run("parallel", phase_parallel, dev)
    emit({"phase_seconds": seconds, "total_s": sum(seconds.values())})

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    conv_source = "vst_torch/csrc/pad_conv3x3.cu"
    dtypes = [dtype_name(d) for d in DTYPES]
    trunk_entries = (kernel_entries("pad_conv3x3", conv_source, "scripts/bisect_im2col.py:20",
                                    {f"full_{dt}": per_conv(m) for (_, dt), m in trunk.items()})
                     if trunk else null_entries("pad_conv3x3", conv_source,
                                                "scripts/bisect_im2col.py:20",
                                                [f"full_{dt}" for dt in dtypes]))
    cost_entries = (kernel_entries("pad_conv3x3", conv_source, "scripts/bisect_kernel_cost.py:15",
                                   {f"{mode}_{dt}": per_conv(m) for (mode, dt), m in cost.items()
                                    if mode != "full"})
                    if cost else null_entries("pad_conv3x3", conv_source,
                                              "scripts/bisect_kernel_cost.py:15",
                                              [f"{m}_{dt}" for dt in dtypes for m in MODES
                                               if m != "full"]))
    gemm_entries = (kernel_entries("gemm_rate", "vst_torch/csrc/gemm_rate.cu",
                                   "scripts/bisect_mxu.py:15", gemm)
                    if gemm else null_entries("gemm_rate", "vst_torch/csrc/gemm_rate.cu",
                                              "scripts/bisect_mxu.py:15",
                                              [f"{dt}_K{K}_N128" for dt in dtypes
                                               for K in (128, 1152)]))
    gru_source = "vst_torch/csrc/sepconv_gru.cu"
    gru_entries = (kernel_entries("sepconv_gru", gru_source, None, gru) if gru
                   else null_entries("sepconv_gru", gru_source, None,
                                     [f"{k}_{a}" for k in ("gru_zr", "gru_q")
                                      for a in ("1x5", "5x1")]))
    emit({"kernels": [
        {"name": "corr_lookup", "route": "cuda", "source": "vst_torch/csrc/corr_lookup.cu",
         "replaces": "vst/kernels/pallas_corr.py:87", "launches": timing.get("launches"),
         "max_abs_err": max_err, "ms": timing.get("kernel_ms"), "plain_ms": timing.get("plain_ms"),
         "bound_ms": timing.get("bound_ms"), "bound_by": timing.get("bound_by"),
         "library_ms": timing.get("library_ms"), "device_ms": timing.get("device_ms"),
         "host_ms": timing.get("host_ms"),
         "launches_by_path": {k: v for k, v in by_path.items() if v is not None}},
        {"name": "lookup_grad_kernel", "route": "cuda", "source": "vst_torch/csrc/corr_lookup.cu",
         "replaces": None, "launches": backward.get("backward_launches"),
         "max_abs_err": backward.get("bwd_max_abs_err"),
         "max_rel_err": backward.get("bwd_max_rel_err"), "ms": backward.get("bwd_kernel_ms"),
         "plain_ms": backward.get("plain_bwd_ms"), "bound_ms": backward.get("bwd_bound_ms"),
         "bound_by": "bytes" if backward else None, "library_ms": None},
        *trunk_entries, *cost_entries, *gemm_entries, *gru_entries,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
