#!/usr/bin/env python3
"""Drive the vst_torch port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py                               # every phase, from the repository root
    python3 chip_smoke.py build kernel demos            # only the phases named

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
   frames, f32 at batch 1 and bf16 at batch 8: 24 PNGs and a video (a GIF
   through PIL on a machine without imageio) each, frames/s; its
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
   `vst_torch.cli train-faststyle` for each method at 256², batch 16, 8
   steps from the device cache over a 64-sample FC2-layout corpus written to
   a temporary directory (device step by CUDA events, median after 3
   warm-up steps; images/s; peak memory; every loss finite); Johnson on one
   fixed batch for 20 steps, its last loss below its first, then 2 steps
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
   4: --family obst (λ 0 and 2000, --iters-pyr 5 5 5, run as 10 closure
   calls a level), --family faststyle --method johnson
   (--num-outs 3) and --method ruder; TCL / FID / LPIPS means and the
   seconds split into the metric nets, FID's host math and the rest
   (stylizing); InceptionV3 activations and one LPIPS value on the card
   against the CPU (4 images, float32, 1e-4 relative). The FC2 paths
   launch none of the kernels.

16. stargan: `vst_torch.cli eval-sintel --family stargan2` (vst's 256-pixel
   configuration, the EMA nets, 3 styles) and `--family stargan` (conv_dim
   64) with `--sintel-dir` on a Sintel-layout tree of vst's 8-frame
   synthetic clip at 436×1024 written as PNGs (the loader crops it to
   432×1024), RAFT f32 at 20 iterations through the kernel (without
   `--sintel-dir` the command scores the clip with its exact flow and runs
   no RAFT), each after its driver on a 7-frame 64×96 clip on the card
   against the same on the CPU (TCL ≤ 1e-4 relative); each StarGAN v2 step
   (d_latent, d_ref, g_latent, g_ref) and v1's D and G steps at 32² on the
   card against the CPU (losses f32 ≤ 1e-4 relative, gradients f64 ≤ 1e-8
   relative in L2 per parameter); `train-stargan2` at 256², batch 8, 4
   domains, AdvCon, 6 iterations from the device cache over a 32-sample
   corpus (`generate_fc2_corpus`, procedural) in f32 and in bf16
   (iteration median after 3 warm-up iterations, images/s, peak memory, every loss finite), one f32
   iteration split by CUDA events into its D steps (R1), G steps and EMA,
   and one under torch.profiler (busy share); `train-stargan` at 128²,
   batch 16, 6 iterations (1 G step) from a 128² corpus, the same numbers; `vst_torch.cli
   eval-fc2 --family stargan2` (latent and reference) and `--family
   stargan` at 256² on 4 synthetic batches of 4, --num-outs 3, the seconds
   split as in phase 15. The training and FC2 paths launch no kernel.
17. cyclegan: each variant's E step and MoGAN's M step at 32² (stub flow) on
   the card against the CPU (losses f32 ≤ 1e-4 relative, parameters and
   gradients f64 ≤ 1e-8 relative in L2 per parameter), MoGAN's and
   ConGAN's E steps and MoGAN's M step with RAFT (4 iterations) at 64²,
   through the kernel on the card against the plain lookup on the CPU
   (losses ≤ 1e-4); `train-cyclegan` for each variant at 256², batch 4,
   ngf = ndf = 64, RAFT 20 iterations, 6 iterations from the device cache
   over a 32-sample synthetic styled corpus, `--sid 1`, in f32 and, for
   cyclegan and mogan, bf16 (E / M step medians after 3 warm-up iterations,
   images/s, peak memory, every loss finite; `corr_lookup` launched exactly
   20 × the RAFT calls: MoGAN 600 (720 in bf16, whose E step adds the
   loss's 2 flows of the cast frames), ConGAN 480, the others 0); one E
   step of MoGAN f32, MoGAN bf16 and cyclegan bf16 split by CUDA events
   into the motion flows, the G step (its RAFT calls apart), the pools and
   the D step, and one under torch.profiler (busy share, launches);
   `eval-sintel --family cyclegan` on the f32 cyclegan,
   mogan and congan checkpoints with `--sintel-dir` (phase 16's tree: RAFT
   at 432×1024, 420 launches), after the driver at 64×96 on the card
   against the CPU (TCL ≤ 1e-4 relative).

18. datagen: `vst_torch.cli datagen-corpus` at 256², batch 16, 16 pairs
   and 3 domains (96 styled images a styler), with `--styler procedural`
   and `--styler gatys` (the seeded VGG, [30, 25, 20], f32): seconds an
   image, the tree's layout, one batch read through the device cache and
   CycleGANFC2Dataset; one OBST batch of 16 timed by CUDA events and under
   torch.profiler (busy share); `datagen-fc2` (64 samples at 256²) and
   `datagen-styled` (4 samples at 64²); `precompute_lt_flow` with RAFT (20
   iterations) at 64×96 through the kernel against the plain lookup (flow
   ≤ 1e-3 px, masks equal), then on the 8-frame 432×1024 clip of phase 5
   through the kernel (seconds a frame, exactly 2 × 20 × 3 = 120 launches).
   The datagen commands launch no kernel.
19. raft_train: flow_sequence_loss over RAFT(train_mode=True), full and
   small, at 2×3×64×64 with 3 iterations on the card against the CPU (loss
   in f32 through the kernel ≤ 1e-4 relative; every gradient in f64, the
   plain lookup on both sides, ≤ 1e-8 relative in L2 per parameter); RAFT's
   chairs stage through `RAFTTrainer` (batch 10, crop 368×496, 12
   iterations, γ = 0.8, AdamW lr 4e-4, weight decay 1e-4, gradient clip 1.0,
   OneCycle, batch norm on batch statistics) on batches of FlyingChairs
   with its stage's augmentor over a 384×512 `data/*.ppm` + `*.flo` tree of
   affine-motion pairs: 9 steps (the median of the last 6 by CUDA events,
   images/s, peak memory, every loss finite, exactly 12 launches and 12
   plain backward passes of the lookup a step), the lookup's forward and
   backward at that shape, one step under torch.profiler; RAFT small (12
   iterations, radius 3) at 4×3×432×1024 through the kernel after the same
   net at 64×96 against the plain lookup (≤ 1e-3 px), 12 launches a call.
20. demos: `demo-web` through its classes (Huang, 3 styles, 436×1024, on a
   server bound to port 0, over its 48-frame synthetic clip): the page,
   the controls (style 1 at strength 0.5, half scale for the second half,
   then sid −1), the state (48 frames), a JPEG frame and a snapshot; per
   part of the clip the median ms a frame of the host→device copy, the net
   and the device→host copy (CUDA events) and the JPEG (host clock), the
   FPS readout and each request's wall. `vst_torch.cli demo` at 436×1024,
   24 frames (its JSON line and the video it wrote). The seeded FAN: its
   forward at 1×3×256² (best of 3 windows), its heatmaps against the same
   module on the CPU (max |Δ| ≤ 1e-3 of max |heat|), `get_heatmap` with
   masks at batch 8, and `profile_trace` of a forward (its annotation and
   the card's kernels in the trace). `align-faces` on 8 synthetic 256²
   scenes written as PNGs: seconds an image, 8 files. StarGAN v2's
   generator with w_hpf = 1 at 256², batch 8, with the FAN's masks: ms and
   peak memory, the masks moving the output; `latent_interpolation_video`
   (3 latents × 16 steps through that generator and a mapping net) and
   `make_videos` over the face directories. No kernel is launched.
21. parallel: `python -m vst_torch.parallel.dryrun 1` on NCCL in a
   subprocess, started first (exit 0 and vst's line); meanwhile, on a
   world-size-1 NCCL group in this process (a `file://` store in a
   temporary directory), the untimed parts: the serial `evaluate_videos` on
   phase 5's 8-frame 432×1024 clip (Johnson, style 0, RAFT 20 iterations
   through the kernel); Johnson at 256² × 16, TV on, fed by
   `prefetch_to_mesh`, 3 updates from the same gradients with and without
   the gradients' all-reduce (parameters and Adam state bit for bit); the
   `Checkpointer` saving and restoring FastStyleNet, StarGAN v2's `nets` +
   `nets_ema` and a CycleGAN `G_A` under the CLI's names (every tensor bit
   for bit, the restored net's output equal). Once the dry run has ended,
   the timed parts: `evaluate_videos_sharded` on the same clip against the
   serial TCL-ST / TCL-LT (≤ 1e-4 relative), the lookup launched exactly 20
   × the RAFT calls (`launches_by_path` entry `eval_sintel_sharded`), vst's
   sharded DT (ms an ST pair); the Johnson step's median ms with and without
   the reductions (CUDA events) and the reduction alone (bytes, ms);
   StarGAN v2 AdvCon at 256² × 8 the same (its four reductions leave the
   gradients bit for bit).

Phase names on the command line run only those phases (all of them
without one). Phases 5–19 and 21 each drive one path with the kernels' launch
counts set to 0 just before it and read just after; a kernel of the path
that was never launched fails the run. Then each phase's seconds, the
card's name and power limit (nvidia-smi), the kernels line (a kernel whose
phases did not run has null numbers) and the result line. Float32 with TF32 off. Weights and
inputs are random, from seeds. Needs one CUDA device; exits 1 without one.
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
from functools import partial
from http.server import ThreadingHTTPServer
from urllib.request import Request, urlopen

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from vst_torch import bench, set_f32_precision
from vst_torch.cli.__main__ import (RAFT_VARIANTS, source_frames, stylize_frames,
                                    video_stylizer)
from vst_torch.cli.__main__ import synthetic_clip as cli_synthetic_clip
from vst_torch.cli.__main__ import main as cli_main
from vst_torch.cli.__main__ import parser as cli_parser
from vst_torch.core.checkpoint import LAYOUTS, Checkpointer
from vst_torch.core.roofline import PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S
from vst_torch.cli.webdemo import WebDemo
from vst_torch.cli.webdemo import make_handler as make_web_handler
from vst_torch.core.timing import chain_ms, cold_pool, graph_ms, host_ms, windows_ms
from vst_torch.core.trace import profile_trace, span
from vst_torch.data.device_cache import DeviceFC2Cache
from vst_torch.data.datagen import generate_fc2_corpus, pack_fc2_npy, precompute_lt_flow
from vst_torch.data.styles import load_style_images
from vst_torch.eval.drivers import (evaluate_sintel_cyclegan, evaluate_sintel_faststyle,
                                    evaluate_sintel_ruder,
                                    evaluate_sintel_stargan, evaluate_sintel_stargan2,
                                    faststyle_stylize_fn, stargan2_styles)
from vst_torch.eval.sintel import (SintelVideo, evaluate_videos, evaluate_videos_sharded,
                                   make_tcl_program)
from vst_torch.data.loader import prefetch_to_mesh
from vst_torch.parallel.mesh import all_reduce_gradients, create_mesh, initialize_distributed
from vst_torch.data.synthetic import _scene as scene
from vst_torch.eval.video import latent_interpolation_video, make_videos, write_png
from vst_torch.flow.corr import build_pyramid, lookup_pyramid
from vst_torch.flow.datasets import fetch_flow_datasets
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
from vst_torch.models.cyclegan import ResnetGenerator
from vst_torch.models.faststyle import FastStyleNet
from vst_torch.models.gatys import OBST, PYR_SINTEL
from vst_torch.models.stargan import Generator as StarGANGenerator
from vst_torch.models.stargan2 import Generator as StarGAN2Generator
from vst_torch.models.stargan2 import MappingNetwork
from vst_torch.models.wing import FAN, get_heatmap
from vst_torch.nn.conv import cudnn_enabled
from vst_torch.ops.image import InputPadder
from vst_torch.perceptual.vgg import Vgg16Features, he_randomized_
from vst_torch.probes import bisect_im2col, bisect_kernel_cost, bisect_mxu
from vst_torch.train.faststyle import FastStyleTrainer, batch_to_tensors
from vst_torch.train.cyclegan import CycleGANConfig, CycleGANTrainer, cyclegan_batch
from vst_torch.train.parity import (cyclegan_steps, grad_errors, max_loss_rel_err, param_errors,
                                    raft_sequence_step, raft_train_inputs, stargan2_steps,
                                    stargan_steps, training_step)
from vst_torch.train.raft import RAFTTrainConfig, RAFTTrainer
from vst_torch.train.stargan2 import StarGAN2Config, StarGAN2Trainer
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
TRAIN_STEPS = 8  # cut from 20 (PR 11) and 12 (PR 13) for the full run's time (PERF.md §6)
TRAIN_CORPUS = 64
LEARN_STEPS = 20  # cut from 30 (PR 13) for the full run's time (PERF.md §6)
HOST_STEPS = 4  # cut from 6 (PR 13)
TRAIN_LOSS_RTOL = 1e-4  # card against CPU, f32
TRAIN_GRAD_RTOL = 1e-3  # card against CPU, f64, L2 per parameter
OBST_IMAGE_RTOL = 1e-8  # card against CPU, one level in f64
OBST_LOSS_RTOL = 1e-5  # card against CPU, one closure in f32
METRIC_RTOL = 1e-4  # InceptionV3 activations and LPIPS, card against CPU, f32
OBST_FRAMES = 6  # TCL-LT needs a frame past the offset of 5
FC2_HW = (256, 256)
FC2_SEED = 14
FC2_OBST_ITERS = (5, 5, 5)  # cut from [50, 40, 30] (PR 11) and 10s (PR 13) (PERF.md §6)
GAN_LOSS_RTOL = 1e-4  # card against CPU, f32
GAN_GRAD_RTOL = 1e-8  # card against CPU, f64, L2 per parameter
SG2_HW, SG2_BATCH = (256, 256), 8  # the README's StarGAN v2 configuration, 4 domains
SG1_HW, SG1_BATCH = (128, 128), 16
GAN_ITERS = 6  # cut from 10 (PR 13) for the full run's time (PERF.md §6)
GAN_DT_ITERS = 10  # the GAN eval-sintel's DT chain, cut from 20 (PR 13) as GAN_ITERS
GAN_CORPUS = 32
CG_HW, CG_BATCH = (256, 256), 4  # the repo's CycleGAN runs (scripts/train_queue.sh:36-49)
CG_VARIANTS = ("cyclegan", "cyclegan_con", "mogan", "congan")
# RAFT calls an E step, an M step (a bf16 MoGAN E step makes 2 more)
CG_RAFT_CALLS = {"cyclegan": (0, 0), "cyclegan_con": (0, 0), "mogan": (6, 4), "congan": (4, 0)}


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


def seeded_raft(iters, dev, seed=0, lookup=corr_lookup, encoder_dtype=None, update_dtype=None,
                small=False, train_mode=False):
    torch.manual_seed(seed)
    return RAFT(iters=iters, lookup=lookup, encoder_dtype=encoder_dtype,
                update_dtype=update_dtype, small=small, train_mode=train_mode).to(dev).eval()


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
            kind = line["video"] and video_signature(line["video"])
        if (len(pngs) != VIDEO_FRAMES or line["frames"] != VIDEO_FRAMES
                or signatures != {b"\x89PNG\r\n\x1a\n"} or kind is None
                or not (math.isfinite(line["frames_per_sec"]) and line["frames_per_sec"] > 0)):
            raise AssertionError(f"stylize-video {line}: wrote {written}, video kind {kind}")
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
            **line, "video_kind": kind, "pngs": len(pngs),
            "other_files": [f for f in written if f not in pngs],
            "passes_frames_per_sec": fps["net"],
            "median_frames_per_sec": fps["net"][VIDEO_PASSES // 2],
            "copies_only_frames_per_sec": fps["copies_only"],
            "device_ms_per_frame": device_ms}
    emit(record)


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven (and
    the lookup's backward passes, which launch no kernel)."""
    corr_lookup.launches = 0
    corr_lookup.plain_backwards = 0
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


def phase_kernel_cost(dev, weighted_errs=None):
    """``weighted_errs``: phase 9's max |Δ| of full and mxu_only, checked here
    when phase 9 did not run."""
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


def device_activity(prof, per=1):
    """(name, ms, count) of every device activity that ``prof`` recorded
    (kernels, copies, fills), divided by ``per``, largest first. Read from
    the profiler's raw events: ``key_averages()`` builds a Python event for
    each one first, which takes seconds for tens of thousands of launches."""
    from torch.autograd import DeviceType

    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ms, n = agg.get(e.name(), (0.0, 0))
            agg[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((name, ms / per, n / per) for name, (ms, n) in agg.items()),
                  key=lambda k: -k[1])


def profile_steps(trainer, batch, steps=2):
    """torch.profiler (the CUDA activity only) over ``steps`` training steps:
    the wall per step, the kernels' device time per step (the device's busy share of the wall)
    and the 12 kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = device_activity(prof, steps)
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


def profile_call(fn, walls=2):
    """``fn``, which each caller has run before at these shapes: ``walls``
    calls timed by the host clock between two synchronize() calls (their
    median ``wall_ms`` and range), then one more under torch.profiler,
    recording the CUDA activity only (the CPU ops' events made most of the
    profiler's cost: PERF.md §6): the kernels' device ms, the launches and
    the 8 kernels that take the most.

    ``kernel_over_wall`` is the kernels' ms over the median unprofiled wall,
    with its range over the walls. It sets one run's device time against
    other runs' walls, and CUPTI's timestamps add to each kernel's time, so
    it leans high: a ratio over 1 is the reading's error (one stream is never
    more than fully busy), and then ``busy_share`` and ``host_idle_share``
    are None. ``busy_share_floor``, the kernels' ms over the wall of the
    profiled call itself, is a floor: the profiler's own cost, µs to tens of
    µs a launch, lengthens that wall.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    wall = []
    for _ in range(walls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_activity(prof)
    device_ms = sum(ms for _, ms, _ in kernels)
    wall_ms = float(np.median(wall))
    ratio = device_ms / wall_ms
    return {"wall_ms": wall_ms, "wall_ms_range": [min(wall), max(wall)],
            "profiled_wall_ms": profiled_wall_ms, "kernel_ms": device_ms,
            "kernel_over_wall": ratio,
            "kernel_over_wall_range": [device_ms / max(wall), device_ms / min(wall)],
            "busy_share": ratio if ratio <= 1.0 else None,
            "host_idle_share": 1.0 - ratio if ratio <= 1.0 else None,
            "busy_share_floor": device_ms / profiled_wall_ms,
            "kernel_launches": sum(n for _, _, n in kernels),
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


class Spans:
    """Spans around wrapped callables, by name, on two clocks: the host's
    seconds, summed (``seconds``; a callable that returns host values has
    its device work inside), and CUDA-event spans of the stream, each in
    order (``device_ms()``, read after one synchronize)."""

    def __init__(self):
        self.seconds, self.events = {}, []

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                end.record()
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
                self.events.append((name, start, end))

        return timed

    def device_ms(self):
        """{name: [ms of each span, in order]}."""
        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.events:
            out.setdefault(name, []).append(a.elapsed_time(b))
        return out


def fc2_run(argv, name):
    """One eval-fc2 command (``argv`` without --out-dir): its means (every one
    finite), the files it wrote and its wall seconds split into the metric
    nets, FID's host math and the rest (stylizing)."""
    watch = Spans()
    saved = (InceptionV3.__call__, LPIPS.__call__, fc2_module.fid_from_activations,
             drivers_module.fid_from_activations)
    InceptionV3.__call__ = watch.wrap("inception_s", saved[0])
    LPIPS.__call__ = watch.wrap("lpips_s", saved[1])
    fc2_module.fid_from_activations = watch.wrap("fid_host_s", saved[2])
    drivers_module.fid_from_activations = watch.wrap("fid_host_s", saved[3])
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            res = cli_main([*argv, "--out-dir", out_dir])
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
    return {"means": means, "written": written, "wall_s": wall, **watch.seconds,
            "stylize_and_rest_s": wall - metric_s}


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
    runs = {"obst": ["--family", "obst", "--iters-pyr", *map(str, FC2_OBST_ITERS)],
            "johnson": ["--family", "faststyle", "--method", "johnson", "--num-outs", "3"],
            "ruder": ["--family", "faststyle", "--method", "ruder"]}
    reset_counts()
    for name, flags in runs.items():
        record["runs"][name] = fc2_run([*argv, *flags], name)
    launches = kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"the FC2 paths launched a kernel: {launches}")
    record["kernel_launches"] = launches
    emit(record)


def gan_card_vs_cpu(what, steps, dev, lr=None):
    """Each step of ``steps(device, dtype)`` (``vst_torch.train.parity``:
    {step: (losses, gradients[, parameters after the update])}) on the card
    against the CPU: losses in f32, gradients in f64 (in f32 rounding
    decides a part of each gradient) and, where the steps return them, the
    parameters after an update of rate ``lr`` in f64."""
    out = {}
    f32 = (steps("cpu", torch.float32), steps(dev, torch.float32))
    f64 = (steps("cpu", torch.float64), steps(dev, torch.float64))
    for name, want in f64[0].items():
        got = f64[1][name]
        loss_rel = max_loss_rel_err(f32[1][name][0], f32[0][name][0])
        grad_rel, _ = grad_errors(got[1], want[1])
        rec = {"losses": f32[0][name][0], "loss_max_rel_err": loss_rel,
               "f64_grad_max_rel_err": grad_rel,
               "f32_grad_max_rel_err": grad_errors(f32[1][name][1], f32[0][name][1])[0]}
        if len(want) > 2:
            rec["f64_param_max_rel_err"] = param_errors(got[2], want[2], want[1], lr)
        if not (loss_rel <= GAN_LOSS_RTOL
                and max(grad_rel, rec.get("f64_param_max_rel_err", 0.0)) <= GAN_GRAD_RTOL):
            raise AssertionError(f"{what} {name} card vs CPU: loss {loss_rel} > {GAN_LOSS_RTOL}"
                                 f" or f64 gradient / parameter {grad_rel} / "
                                 f"{rec.get('f64_param_max_rel_err')} > {GAN_GRAD_RTOL}")
        out[name] = rec
    return out


def gan_eval_card_vs_cpu(dev, family):
    """A GAN family's Sintel driver (StarGAN v2, v1, or CycleGAN with three
    16-wide generators) on a 7-frame 64×96 clip with RAFT (4 iterations) on
    the card (through the kernel) against the CPU (the plain lookup),
    seeded weights: every TCL value within TCL_RTOL relative and positive."""
    small = SintelVideo("small", synthetic_clip(7, (64, 96), seed=2))
    vals = []
    for device in (dev, torch.device("cpu")):
        raft = seeded_raft(4, device, seed=2)
        torch.manual_seed(3)
        if family == "stargan2":
            g, f = StarGAN2Generator(256, 64, 512).to(device), MappingNetwork(16, 64, 4).to(device)
            res = evaluate_sintel_stargan2(g, f, [small], lambda a, b: raft(a, b), num_domains=4,
                                           styles=stargan2_styles(4, 16), dt_iters=1,
                                           device=device)
        elif family == "cyclegan":
            gens = [ResnetGenerator(3, 3, 16).to(device).eval() for _ in range(3)]
            res = evaluate_sintel_cyclegan(gens, [small], lambda a, b: raft(a, b), dt_iters=1,
                                           device=device)
        else:
            g = StarGANGenerator(64, 4, 6).to(device)
            res = evaluate_sintel_stargan(g, [small], lambda a, b: raft(a, b), c_dim=4,
                                          dt_iters=1, device=device)
        vals.append([res[k][f"{k}_small_s{d}"] for k in TCL_KEYS for d in (1, 2, 3)])
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(*vals))
    if rel > TCL_RTOL or not all(v > 0 for v in vals[1]):
        raise AssertionError(f"eval-sintel {family}: small clip card vs CPU {rel} > {TCL_RTOL} "
                             f"or not positive: {vals}")
    return rel


def sintel_tree():
    """A temporary Sintel-layout tree of vst's 8-frame synthetic clip at
    436×1024 as PNGs (the loader crops it to 432×1024), so that eval-sintel
    runs RAFT (without --sintel-dir it scores the clip with its exact flow)."""
    sintel = tempfile.TemporaryDirectory()
    clip = os.path.join(sintel.name, "training", "final", "synthetic_1")
    os.makedirs(clip)
    for i, frame in enumerate(cli_synthetic_clip(SINTEL_HW, 8, 0)[0]):
        write_png(os.path.join(clip, f"frame_{i + 1:04d}.png"),
                  np.round(frame * 255).astype(np.uint8))
    return sintel


def stargan2_split(dev, corpus):
    """One f32 iteration at the full configuration split by CUDA events into
    its D steps (R1), G steps and EMA (after a warm-up iteration), then one
    more under torch.profiler (profile_call: kernel time, busy share)."""
    from vst_torch.data.device_cache import DeviceStyledCache
    from vst_torch.train.stargan2 import gan_batch

    trainer = StarGAN2Trainer(StarGAN2Config(img_size=SG2_HW[0], lambda_tcl=100.0), seed=0,
                              device=dev)
    cache = DeviceStyledCache(corpus, num_dom=4, seed=1, device=dev)
    batch = gan_batch(cache.sample(SG2_BATCH), dev)
    trainer.train_iteration(batch)  # warm-up
    z, _ = trainer.draw_latents(SG2_BATCH)
    args = (batch["x_real"], batch["y_org"], batch["y_trg"], z, batch["x_ref"])
    parts = {"d_steps_r1": lambda: [trainer.d_step(k, *args) for k in ("latent", "ref")],
             "g_steps": lambda: [trainer.g_step(k, k == "latent", {**batch, "z": z})
                                 for k in ("latent", "ref")],
             "ema": trainer.ema_step}
    spans = Spans()
    torch.cuda.synchronize()
    for name, fn in parts.items():
        spans.wrap(f"{name}_ms", fn)()
    split = {name: ms for name, (ms,) in spans.device_ms().items()}
    profile = profile_call(lambda: trainer.train_iteration(batch))
    return {**split, "profile": profile}


def phase_stargan(dev):
    record = {"phase": "stargan", "seconds": {}, "eval_sintel": {}, "train": {}, "fc2": {}}
    t0 = time.perf_counter()
    record["card_vs_cpu"] = {"stargan2_32x32": gan_card_vs_cpu("stargan2", stargan2_steps, dev),
                             "stargan_32x32": gan_card_vs_cpu("stargan", stargan_steps, dev)}
    record["seconds"]["card_vs_cpu"] = time.perf_counter() - t0

    launches = {}
    sintel = sintel_tree()
    for family in ("stargan2", "stargan"):
        t0 = time.perf_counter()
        rel = gan_eval_card_vs_cpu(dev, family)
        reset_counts()
        with tempfile.TemporaryDirectory() as out_dir:
            t1 = time.perf_counter()
            res = cli_main(["eval-sintel", "--family", family, "--sintel-dir", sintel.name,
                            "--dt-iters", str(GAN_DT_ITERS), "--out-dir", out_dir])
            seconds = time.perf_counter() - t1
        launches[family] = corr_lookup.launches
        require_launches(launches, (family,), "eval-sintel --family")
        record["eval_sintel"][family] = {
            **finite_positive({k: res[k][f"{k}_mean"] for k in res}, f"eval-sintel {family}"),
            "evaluation_s": seconds, "corr_lookup_launches": launches[family],
            "small_card_vs_cpu_max_rel_err": rel}
        record["seconds"][f"eval_sintel_{family}"] = time.perf_counter() - t0
    sintel.cleanup()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        corpora = {hw: os.path.join(tmp, f"styled_{hw[0]}") for hw in (SG2_HW, SG1_HW)}
        for hw, corpus in corpora.items():
            generate_fc2_corpus(corpus, GAN_CORPUS, hw=hw, styler="procedural", device=dev)
        record["seconds"]["corpus_write"] = time.perf_counter() - t0
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
            t0 = time.perf_counter()
            res = cli_main([*argv, *common, "--out-dir", os.path.join(tmp, name)])
            if res["n_nonfinite"]:
                raise AssertionError(f"{name}: a loss is not finite: {res['last_losses']}")
            record["train"][name] = {k: v for k, v in res.items() if k != "losses"}
            record["seconds"][f"train_{name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        record["train"]["stargan2_f32_split"] = stargan2_split(dev, corpora[SG2_HW])
        record["seconds"]["split"] = time.perf_counter() - t0
    train_launches = kernel_launches()

    argv = ["eval-fc2", "--hw", *map(str, FC2_HW), "--batch-size", "4", "--seed", str(FC2_SEED),
            "--num-outs", "3"]
    fc2_runs = {"stargan2_latent": ["--family", "stargan2", "--mode", "latent"],
                "stargan2_reference": ["--family", "stargan2", "--mode", "reference"],
                "stargan": ["--family", "stargan"]}
    reset_counts()
    for name, flags in fc2_runs.items():
        t0 = time.perf_counter()
        record["fc2"][name] = fc2_run([*argv, *flags], name)
        record["seconds"][f"fc2_{name}"] = time.perf_counter() - t0
    fc2_launches = kernel_launches()
    if any(train_launches.values()) or any(fc2_launches.values()):
        raise AssertionError(f"the training / FC2 paths launched a kernel: {train_launches}, "
                             f"{fc2_launches}")
    record["kernel_launches"] = {"train": train_launches, "fc2": fc2_launches}
    emit(record)
    return launches


def cyclegan_raft_card_vs_cpu(dev):
    """MoGAN's and ConGAN's steps with RAFT (4 iterations) at 64², through the
    kernel on the card against the plain lookup on the CPU, losses in f32."""
    out = {}
    for variant in ("mogan", "congan"):
        runs = [cyclegan_steps(variant, device, torch.float32, hw=(64, 64),
                               raft=seeded_raft(4, device, seed=2, lookup=lookup))
                for device, lookup in ((dev, corr_lookup), ("cpu", lookup_pyramid))]
        for step in runs[1]:
            rel = max_loss_rel_err(runs[0][step][0], runs[1][step][0])
            if rel > GAN_LOSS_RTOL:
                raise AssertionError(f"cyclegan {variant} {step} with RAFT, kernel vs plain: "
                                     f"{rel} > {GAN_LOSS_RTOL}")
            out[f"{variant}_{step}"] = {"losses": runs[1][step][0], "loss_max_rel_err": rel}
    return out


def cyclegan_split(dev, corpus, variant, compute_dtype=None):
    """One E step of ``variant`` at 256² × 4 split by CUDA events (after an E
    step of warm-up): for MoGAN the motion flows (2 RAFT calls, M_A,
    M_B), the G step (its RAFT calls apart), the pools and the D step; then
    one E step under torch.profiler (profile_call: busy share, launches)."""
    from vst_torch.data.device_cache import DeviceStyledCache

    spans = Spans()
    raft = seeded_raft(20, dev)
    trainer = CycleGANTrainer(CycleGANConfig(variant=variant, compute_dtype=compute_dtype),
                              raft=raft if variant in ("mogan", "congan") else None, seed=0,
                              device=dev)
    cache = DeviceStyledCache(corpus, num_dom=2, seed=1, device=dev)
    batch = cyclegan_batch(cache.sample_cyclegan(CG_BATCH, 1), dev)
    trainer.train_iteration(0, batch)  # warm-up
    trainer.raft = spans.wrap("raft_ms", raft)
    parts = ("motion_aux", "g_step", "query_pools", "d_step")
    for name in parts if variant == "mogan" else parts[1:]:
        setattr(trainer, name, spans.wrap(f"{name}_ms", getattr(trainer, name)))
    torch.cuda.synchronize()
    trainer.e_step(batch)
    spans_ms = spans.device_ms()
    split = {name: sum(v) for name, v in spans_ms.items()}
    if "raft_ms" in spans_ms:
        split["raft_calls_ms"] = spans_ms["raft_ms"]  # MoGAN's first 2 are the motion flows'
        in_g = spans_ms["raft_ms"][2 if variant == "mogan" else 0:]
        split["g_step_without_raft_ms"] = split["g_step_ms"] - sum(in_g)
    profile = profile_call(lambda: trainer.e_step(batch))
    return {**split, "profile": profile}


def phase_cyclegan(dev):
    record = {"phase": "cyclegan", "seconds": {}, "train": {}, "launches": {}}
    t0 = time.perf_counter()
    lr = CycleGANConfig().lr
    record["card_vs_cpu"] = {
        **{f"{v}_32x32": gan_card_vs_cpu(f"cyclegan {v}", partial(cyclegan_steps, v), dev, lr)
           for v in CG_VARIANTS},
        "raft_64x64": cyclegan_raft_card_vs_cpu(dev)}
    record["seconds"]["card_vs_cpu"] = time.perf_counter() - t0

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        corpus = os.path.join(tmp, "styled")
        generate_fc2_corpus(corpus, GAN_CORPUS, hw=CG_HW, styler="procedural", device=dev)
        record["seconds"]["corpus_write"] = time.perf_counter() - t0
        common = ["--hw", *map(str, CG_HW), "--batch-size", str(CG_BATCH), "--steps",
                  str(GAN_ITERS), "--log-every", "5", "--ckpt-every", str(10 * GAN_ITERS),
                  "--data-dir", corpus, "--device-cache", str(GAN_CORPUS), "--sid", "1"]
        runs = {f"{v}_f32": [v] for v in CG_VARIANTS}
        runs.update(cyclegan_bf16=["cyclegan", "--compute-dtype", "bfloat16"],
                    mogan_bf16=["mogan", "--compute-dtype", "bfloat16"])
        for name, (variant, *extra) in runs.items():
            t0 = time.perf_counter()
            reset_counts()
            res = cli_main(["train-cyclegan", "--variant", variant, *common, *extra,
                            "--out-dir", os.path.join(tmp, name)])
            counts = kernel_launches()
            e_calls, m_calls = CG_RAFT_CALLS[variant]
            if variant == "mogan" and extra:  # the loss's flows of the cast frames
                e_calls += 2
            steps_e = (GAN_ITERS + 1) // 2 if variant == "mogan" else GAN_ITERS
            want = 20 * (steps_e * e_calls + (GAN_ITERS - steps_e) * m_calls)
            if counts != {"corr_lookup": want, "pad_conv3x3": 0, "gemm_rate": 0}:
                raise AssertionError(f"train-cyclegan {name}: launches {counts}, corr_lookup "
                                     f"should be {want}")
            if res["n_nonfinite"]:
                raise AssertionError(f"{name}: a loss is not finite: {res['last_losses']}")
            launches[f"train_{name}"] = counts["corr_lookup"]
            record["train"][name] = {k: v for k, v in res.items()
                                     if k not in ("losses", "checkpoints")}
            record["seconds"][f"train_{name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for variant, dtype in (("mogan", None), ("mogan", "bfloat16"), ("cyclegan", "bfloat16")):
            name = f"{variant}_{'bf16' if dtype else 'f32'}_split"
            record["train"][name] = cyclegan_split(dev, corpus, variant, dtype)
        record["seconds"]["split"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        record["eval_small_card_vs_cpu_max_rel_err"] = gan_eval_card_vs_cpu(dev, "cyclegan")
        sintel = sintel_tree()
        specs = ",".join(f"{v}:{os.path.join(tmp, v + '_f32')}"
                         for v in ("cyclegan", "mogan", "congan"))
        reset_counts()
        with tempfile.TemporaryDirectory() as out_dir:
            t1 = time.perf_counter()
            res = cli_main(["eval-sintel", "--family", "cyclegan", "--sintel-dir", sintel.name,
                            "--ckpt-dir", specs, "--dt-iters", str(GAN_DT_ITERS),
                            "--out-dir", out_dir])
            seconds = time.perf_counter() - t1
        sintel.cleanup()
        counts = kernel_launches()
        if counts != {"corr_lookup": 420, "pad_conv3x3": 0, "gemm_rate": 0}:
            raise AssertionError(f"eval-sintel --family cyclegan: launches {counts}, "
                                 "corr_lookup should be 420")
        launches["eval_sintel_cyclegan"] = counts["corr_lookup"]
        record["eval_sintel"] = {
            **finite_positive({k: res[k][f"{k}_mean"] for k in res}, "eval-sintel cyclegan"),
            "evaluation_s": seconds, "corr_lookup_launches": counts["corr_lookup"]}
        record["seconds"]["eval_sintel"] = time.perf_counter() - t0
    record["launches"] = launches
    emit(record)
    return launches


DG_HW = (256, 256)  # datagen-corpus at the corpus's own size, vst's OBST batch
DG_PAIRS, DG_BATCH, DG_DOMAINS = 16, 16, 3
DG_ITERS = (30, 25, 20)
LT_OFFSET = 5
# The seeded RAFT's flows (mean |flow| 3.4–4.2 px, no relation between the two
# directions) fail the forward-backward check everywhere, so every mask would
# be 0. Scaled by 0.1 to the sub-pixel motion of a near-static clip, about a
# fifth of the pixels pass (0.15–0.20 on the CPU at 64×96 and 432×1024), so
# the masks that are compared and checked are not constant.
LT_FLOW_SCALE = 0.1


def lt_raft_apply(raft):
    return lambda a, b: tuple(LT_FLOW_SCALE * f for f in raft(255.0 * a, 255.0 * b))


def partial_masks(out, what):
    """The mean of the (1, H, W, 3) outputs' masks, which must be binary and
    neither all 0 nor all 1."""
    masks = np.stack([o[..., 2] for o in out])
    mean = float(masks.mean())
    if not set(np.unique(masks)) <= {0.0, 1.0} or not 0.0 < mean < 1.0:
        raise AssertionError(f"{what}: the masks are not binary or are constant (mean {mean})")
    return mean
RT_BATCH, RT_CROP, RT_ITERS = 10, (368, 496), 12  # RAFT's chairs stage (train_standard.sh)
RT_LR, RT_WDECAY, RT_CLIP, RT_GAMMA = 4e-4, 1e-4, 1.0, 0.8
RT_STEPS, RT_WARMUP = 6, 3  # RT_STEPS cut from 10 (PR 13)
CHAIRS_HW, CHAIRS_PAIRS = (384, 512), 16  # FlyingChairs' own frame size
RT_LOSS_RTOL = 1e-4  # card against CPU, f32
RT_GRAD_RTOL = 1e-8  # card against CPU, f64, L2 per parameter
SMALL_RADIUS = 3


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


def obst_batch(dev, root):
    """One OBST batch of ``DG_BATCH`` corpus frames at 256² as datagen-corpus
    runs it (style 0, [30, 25, 20]) through profile_call: its seconds (the
    median of 2 calls by the host clock between two synchronize() calls, the
    styled images copied back) and the device's busy share."""
    from vst_torch.data.datagen import _stylize_batch

    names = sorted(os.listdir(os.path.join(root, "DATAFiles")))[:DG_BATCH]
    frames = np.stack([np.load(os.path.join(root, "DATAFiles", n))[0, ..., :3] for n in names])
    batch = to_nchw(frames, dev)
    pyr = ((DG_HW[0] // 4, DG_HW[1] // 4), (DG_HW[0] // 2, DG_HW[1] // 2), DG_HW)
    obst = OBST(max_iters=DG_ITERS, device=dev)
    obst.set_style(load_style_images(size=256)[0], pyr)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    profile = profile_call(lambda: out.update(rgb=_stylize_batch(obst, batch, pyr, 0.0)))
    if out["rgb"].shape != (DG_BATCH, *DG_HW, 3) or not np.isfinite(out["rgb"]).all():
        raise AssertionError(f"OBST batch {out['rgb'].shape} not finite")
    return {"s_per_batch": profile["wall_ms"] / 1e3, "batch": DG_BATCH,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "profile": profile}


def lt_flow_check(dev):
    """precompute_lt_flow on an 8-frame 64×96 clip with RAFT (20 iterations,
    flows scaled by LT_FLOW_SCALE) through the kernel and through the plain
    lookup, same weights: flows within FLOW_ATOL_PX, masks equal and not
    constant."""
    clip = synthetic_clip(8, (64, 96), seed=4)
    outs = []
    for lookup in (corr_lookup, lookup_pyramid):
        raft = seeded_raft(20, dev, seed=4, lookup=lookup)
        outs.append(precompute_lt_flow(clip, lt_raft_apply(raft), offset=LT_OFFSET, device=dev))
    mask_mean = partial_masks(outs[1], "precompute_lt_flow at 64×96")
    dflow = max(np.abs(a[..., :2] - b[..., :2]).max() for a, b in zip(*outs))
    if dflow > FLOW_ATOL_PX or not all(np.array_equal(a[..., 2], b[..., 2]) for a, b in zip(*outs)):
        raise AssertionError(f"precompute_lt_flow kernel vs plain: {dflow} px or masks differ")
    return {"clip": [8, 64, 96], "flow_scale": LT_FLOW_SCALE, "max_abs_dflow_px": float(dflow),
            "mask_mean": mask_mean}


def phase_datagen(dev):
    """datagen-corpus (both stylers), datagen-fc2, datagen-styled; one OBST
    batch timed and profiled; precompute_lt_flow through RAFT and the kernel."""
    record = {"phase": "datagen", "seconds": {}, "corpus": {}}
    n_styled = DG_PAIRS * 2 * DG_DOMAINS
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        for styler in ("procedural", "gatys"):
            root = os.path.join(tmp, styler)
            t0 = time.perf_counter()
            cli_main(["datagen-corpus", "--n-samples", str(DG_PAIRS), "--hw", *map(str, DG_HW),
                      "--batch-size", str(DG_BATCH), "--styler", styler,
                      "--iters", *map(str, DG_ITERS), "--out-dir", root])
            wall = time.perf_counter() - t0
            corpus_layout(root, DG_PAIRS, DG_HW, DG_DOMAINS)
            record["corpus"][styler] = {"wall_s": wall, "styled_images": n_styled,
                                        "s_per_styled_image": wall / n_styled,
                                        "reads": corpus_reads(root, dev)}
            record["seconds"][f"corpus_{styler}"] = wall
        t0 = time.perf_counter()
        record["corpus"]["gatys"]["obst_batch"] = obst_batch(dev, os.path.join(tmp, "gatys"))
        record["seconds"]["obst_batch"] = time.perf_counter() - t0

        t0 = time.perf_counter()
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
        record["seconds"]["fc2_and_styled"] = time.perf_counter() - t0
        launches = kernel_launches()
        if any(launches.values()):
            raise AssertionError(f"the datagen commands launched a kernel: {launches}")

        t0 = time.perf_counter()
        record["lt_flow_small_check"] = lt_flow_check(dev)
        raft = seeded_raft(20, dev)
        clip = synthetic_clip(8, CLIP_HW, seed=3)
        raft(*(to_nchw(clip[:1], dev) * 255.0,) * 2)  # warm
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = precompute_lt_flow(clip, lt_raft_apply(raft), out_dir=os.path.join(tmp, "lt"),
                                 offset=LT_OFFSET, device=dev)
        wall = time.perf_counter() - t1
        launches = corr_lookup.launches
        want = 2 * 20 * (len(clip) - LT_OFFSET)
        if launches != want or len(out) != len(clip) - LT_OFFSET:
            raise AssertionError(f"precompute_lt_flow: {launches} launches, want {want}")
        if not all(o.shape == (1, *CLIP_HW, 3) and np.isfinite(o).all() for o in out):
            raise AssertionError("precompute_lt_flow: output not finite / of shape")
        record["lt_flow"] = {"clip": [len(clip), *CLIP_HW], "raft_iters": 20, "frames": len(out),
                             "flow_scale": LT_FLOW_SCALE,
                             "mask_mean": partial_masks(out, "precompute_lt_flow at 432×1024"),
                             "s_per_frame": wall / len(out), "corr_lookup_launches": launches,
                             "files": sorted(os.listdir(os.path.join(tmp, "lt")))}
        record["seconds"]["lt_flow"] = time.perf_counter() - t0
    emit(record)
    return {"precompute_lt_flow": launches}


def chairs_tree(root):
    """A FlyingChairs-layout tree (``data/*_img1.ppm``, ``*_img2.ppm``,
    ``*_flow.flo``) of affine-motion pairs at 384×512, the forward flow of
    each pair exact."""
    from PIL import Image

    from vst_torch.data.synthetic import MARGIN, AffineMotionGenerator, _texture
    from vst_torch.flow.io import write_flo

    os.makedirs(os.path.join(root, "data"))
    for i in range(CHAIRS_PAIRS):
        gen = AffineMotionGenerator(crop_hw=CHAIRS_HW, seed=i + 1)
        rng = np.random.RandomState(i)
        frames, _, _ = gen.generate(_texture(rng, (CHAIRS_HW[0] + MARGIN, CHAIRS_HW[1] + MARGIN)),
                                    n_frames=2)
        for k in (0, 1):
            Image.fromarray(np.round(frames[k] * 255).astype(np.uint8)).save(
                os.path.join(root, "data", f"{i:05d}_img{k + 1}.ppm"))
        write_flo(os.path.join(root, "data", f"{i:05d}_flow.flo"), gen.pairwise_flows(0, 1)[0])


def flow_batches(dataset, n_batches, dev):
    """``n_batches`` batches of ``RT_BATCH`` samples drawn in order (the
    augmentor's generator advances) on the device: NCHW images [0, 255],
    flow (B, 2, H, W), valid (B, H, W)."""
    out, i = [], 0
    for _ in range(n_batches):
        samples = [dataset[(i + j) % len(dataset)] for j in range(RT_BATCH)]
        i += RT_BATCH
        img1, img2, flow, valid = (np.stack(x) for x in zip(*samples))
        out.append((to_nchw(img1, dev), to_nchw(img2, dev), to_nchw(flow, dev),
                    torch.from_numpy(valid).to(dev)))
    return out


def lookup_fwd_bwd_ms(dev):
    """The lookup at the chairs stage's shape (B = 10, 46×62 queries, 4
    levels, radius 4): the kernel's forward held against the plain version
    on these inputs (KERNEL_ERR), then timed, and the backward (the plain
    version's recompute and autograd), each by CUDA events over 10 calls."""
    B, h, w = RT_BATCH, RT_CROP[0] // 8, RT_CROP[1] // 8
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
    fwd = time_ms(lambda: corr_lookup(pyramid, coords, RADIUS), 10)
    bwd = time_ms(lambda: torch.autograd.grad(corr_lookup(pyramid, coords, RADIUS), pyramid,
                                              upstream), 10) - fwd
    return {"shape": [B, h, w], "max_abs_err": err, "fwd_ms": fwd, "bwd_ms": bwd}


def raft_train_card_vs_cpu(dev):
    """flow_sequence_loss over RAFT(train_mode=True) at 64×64, 3 iterations,
    batch 2: the loss in f32 (the kernel on the card, the plain lookup on the
    CPU) and every gradient in f64 (the plain lookup on both: the kernel is
    f32), card against CPU."""
    inputs = raft_train_inputs((64, 64), batch=2, seed=5)
    out = {}
    for small in (False, True):
        fast = seeded_raft(3, "cpu", seed=5, small=small, train_mode=True)
        plain = seeded_raft(3, "cpu", seed=5, small=small, train_mode=True, lookup=lookup_pyramid)
        want, _ = raft_sequence_step(fast, inputs, "cpu", torch.float32)
        got, _ = raft_sequence_step(fast, inputs, dev, torch.float32)
        _, want_g = raft_sequence_step(plain, inputs, "cpu", torch.float64)
        _, got_g = raft_sequence_step(plain, inputs, dev, torch.float64)
        loss_rel = abs(got - want) / abs(want)
        grad_rel, _ = grad_errors(got_g, want_g)
        if not (loss_rel <= RT_LOSS_RTOL and grad_rel <= RT_GRAD_RTOL):
            raise AssertionError(f"RAFT sequence loss (small={small}) card vs CPU: loss "
                                 f"{loss_rel} > {RT_LOSS_RTOL} or f64 gradient {grad_rel} > "
                                 f"{RT_GRAD_RTOL}")
        out["small" if small else "full"] = {"loss": want, "loss_rel_err": loss_rel,
                                             "f64_grad_max_rel_err": grad_rel}
    return out


def raft_small_eval(dev):
    """RAFT small (12 iterations, radius 3) in evaluation at 4×3×432×1024
    through the kernel, after the same net at 2×3×64×96 against the plain
    lookup (≤ FLOW_ATOL_PX); time a call, its launches."""
    small = synthetic_clip(3, (64, 96), seed=1) * 255.0
    s1, s2 = to_nchw(small[[0, 1]], dev), to_nchw(small[[1, 2]], dev)
    fast = seeded_raft(RT_ITERS, dev, seed=6, small=True)
    plain = seeded_raft(RT_ITERS, dev, seed=6, small=True, lookup=lookup_pyramid)
    clip = synthetic_clip(5, CLIP_HW) * 255.0
    i1, i2 = to_nchw(clip[[0, 1, 2, 3]], dev), to_nchw(clip[[1, 2, 3, 4]], dev)
    with torch.no_grad():
        dflow = max((a - b).abs().max().item() for a, b in zip(fast(s1, s2), plain(s1, s2)))
        if dflow > FLOW_ATOL_PX:
            raise AssertionError(f"RAFT small kernel vs plain lookup: {dflow} px")
        fast(i1, i2)
        reset_counts()
        _, up = fast(i1, i2)
        torch.cuda.synchronize()
        launches = corr_lookup.launches
        if launches != RT_ITERS or up.shape != (4, 2, *CLIP_HW) or not torch.isfinite(up).all():
            raise AssertionError(f"RAFT small: {launches} launches (want {RT_ITERS}) or flow "
                                 "not finite / of shape")
        ms = time_ms(lambda: fast(i1, i2), 3, 1)
    return {"shape": [4, 3, *CLIP_HW], "iters": RT_ITERS, "radius": SMALL_RADIUS,
            "ms_per_call": ms, "corr_lookup_launches": launches,
            "small_check": {"shape": [2, 3, 64, 96], "max_abs_dflow_px": dflow}}


def phase_raft_train(dev):
    """RAFT's training path at its chairs stage; small RAFT in evaluation."""
    record = {"phase": "raft_train", "seconds": {}}
    t0 = time.perf_counter()
    record["card_vs_cpu"] = raft_train_card_vs_cpu(dev)
    record["seconds"]["card_vs_cpu"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        chairs_tree(tmp)
        data = fetch_flow_datasets("chairs", {"chairs": tmp}, crop_size=RT_CROP, seed=0)
        batches = flow_batches(data, RT_WARMUP + RT_STEPS, dev)
    record["seconds"]["data"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    trainer = RAFTTrainer(RAFTTrainConfig(iters=RT_ITERS, lr=RT_LR, wdecay=RT_WDECAY,
                                          gamma=RT_GAMMA, clip=RT_CLIP), device=dev)

    def step(batch):
        return trainer.train_iteration(dict(zip(("image1", "image2", "flow", "valid"),
                                                batch)))["loss"]

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for batch in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(batch))
        end.record()
        ms.append((start, end))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in ms]
    losses = torch.stack(losses).tolist()
    launches, backwards = corr_lookup.launches, corr_lookup.plain_backwards
    want = RT_ITERS * len(batches)
    if launches != want or backwards != want:
        raise AssertionError(f"raft_train: corr_lookup {launches} launches and {backwards} "
                             f"backward passes, want {want} each")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"raft_train: a loss is not finite: {losses}")
    median = float(np.median(step_ms[RT_WARMUP:]))
    record["train"] = {
        "batch": RT_BATCH, "crop": list(RT_CROP), "iters": RT_ITERS, "gamma": RT_GAMMA,
        "lr": RT_LR, "weight_decay": RT_WDECAY, "clip": RT_CLIP, "steps": len(batches),
        "warmup": RT_WARMUP, "step_ms": step_ms, "step_ms_median": median,
        "images_per_s": RT_BATCH / median * 1e3,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "losses": losses,
        "corr_lookup_launches": launches, "corr_lookup_plain_backwards": backwards}
    lookup = lookup_fwd_bwd_ms(dev)
    record["lookup_at_train_shape"] = {
        **lookup, "per_step_fwd_ms": RT_ITERS * lookup["fwd_ms"],
        "per_step_bwd_ms": RT_ITERS * lookup["bwd_ms"],
        "bwd_share_of_step": RT_ITERS * lookup["bwd_ms"] / median}
    profile = profile_call(lambda: step(batches[0]))
    record["profile"] = profile
    record["seconds"]["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    record["small_eval"] = raft_small_eval(dev)
    record["seconds"]["small_eval"] = time.perf_counter() - t0
    emit(record)
    return {"raft_train": launches, "raft_small_eval": record["small_eval"]["corr_lookup_launches"]}


DEMO_STYLES, DEMO_FRAMES = 3, 48  # Huang's 3 styles; the web demo's 48-frame synthetic clip
DEMO_CLI_FRAMES = 24  # the demo command's frames, cut from 48 (PR 13)
FAN_HW, FAN_BATCH = 256, 8
FAN_CARD_RTOL = 1e-3  # FAN heatmaps card against CPU, f32 with TF32 off, of max |heat|
ALIGN_IMAGES = 8
HPF_SIZE, HPF_BATCH, HPF_STYLE, HPF_LATENT, HPF_DOMAINS = 256, 8, 64, 16, 4
LATENTS, LATENT_STEPS = 3, 16


def http(base, path, payload=None):
    """(body, wall ms) of one request: a GET, or a POST of ``payload`` as JSON."""
    data = None if payload is None else json.dumps(payload).encode()
    t0 = time.perf_counter()
    with urlopen(Request(base + path, data=data, method="GET" if data is None else "POST"),
                 timeout=120) as r:
        body = r.read()
    return body, (time.perf_counter() - t0) * 1e3


def stage_medians(rows):
    return {k: float(np.median([r[k] for r in rows])) for k in rows[0]}


def demo_web_run(dev, out_dir):
    """The demo-web server over vst's 48-frame synthetic clip at 436×1024,
    Huang with 3 styles, driven as vst's own test drives it: the page, the
    controls (style 1 at strength 0.5; half scale for the second half; then
    sid −1), the state, a frame and a snapshot. Per part of the clip, the
    median ms a frame of each stage (CUDA events on the copies and the net,
    the host clock on the JPEG) and the FPS readout; each request's wall."""
    t0 = time.perf_counter()
    demo = WebDemo(method="huang", n_styles=DEMO_STYLES, hw=SINTEL_HW, out_path=out_dir, seed=0,
                   device=dev)
    setup_s = time.perf_counter() - t0  # the net, and the clip made on the host
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_web_handler(demo))
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    walls, parts = {}, {}
    try:
        page, walls["page"] = http(base, "/")
        _, walls["control_sid"] = http(base, "/control", {"sid": 1})
        _, walls["control_strength"] = http(base, "/control", {"strength": 0.5})
        for name, upto, control in (("full_scale", DEMO_FRAMES // 2, None),
                                    ("half_scale", DEMO_FRAMES - 4, {"scale": 0.5}),
                                    ("pass_through", DEMO_FRAMES, {"sid": -1})):
            if control:
                _, walls[f"control_{name}"] = http(base, "/control", control)
            start, t0 = demo.frames_done, time.perf_counter()
            loop = threading.Thread(target=demo.loop, kwargs={"max_frames": upto})
            loop.start()
            loop.join(300)
            if loop.is_alive():
                raise AssertionError(f"demo-web: the loop did not reach {upto} frames")
            wall = time.perf_counter() - t0
            parts[name] = {"frames": upto - start, "wall_s": wall,
                           "frames_per_s": (upto - start) / wall, "fps_readout": demo.fps,
                           "median_ms": stage_medians(list(demo.stage_ms)[start:upto])}
        state, walls["state"] = http(base, "/state")
        frame, walls["frame_jpg"] = http(base, "/frame.jpg")
        snap, walls["snapshot"] = http(base, "/snapshot", {})
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
    return {"hw": list(SINTEL_HW), "styles": DEMO_STYLES, "setup_s": setup_s, "state": state,
            "parts": parts,
            "request_wall_ms": walls, "jpeg_bytes": len(frame), "snapshot_bytes": len(snapshot)}


def video_signature(path):
    """The file's kind by its first bytes: gif, mp4, or None."""
    with open(path, "rb") as f:
        head = f.read(12)
    return "gif" if head[:6] in (b"GIF87a", b"GIF89a") else "mp4" if head[4:8] == b"ftyp" else None


def best_ms(fn, windows=3, reps=5):
    """The best of ``windows`` means over ``reps`` calls (CUDA events)."""
    return min(time_ms(fn, reps, 1) for _ in range(windows))


def fan_run(dev, tmp):
    """The seeded FAN: its forward at 1×3×256² (best of 3 windows), its
    heatmaps on the card against the same module on the CPU, get_heatmap
    with masks at batch 8, and a profile_trace of a forward holding its
    annotation and the card's kernels. Returns (the record, the FAN, the
    batch's images and masks)."""
    torch.manual_seed(0)
    fan_cpu = FAN()
    fan = FAN().to(dev)
    fan.load_state_dict(fan_cpu.state_dict())
    rng = np.random.RandomState(0)
    x1 = torch.from_numpy(rng.rand(1, 3, FAN_HW, FAN_HW).astype(np.float32))
    xb = torch.from_numpy(rng.uniform(-1, 1, (FAN_BATCH, 3, FAN_HW, FAN_HW)).astype(np.float32))
    with torch.inference_mode():
        heat_cpu, _ = fan_cpu(x1)
        heat, _ = fan(x1.to(dev))
        err = (heat.cpu() - heat_cpu).abs().max().item()
        scale = heat_cpu.abs().max().item()
        if not err <= FAN_CARD_RTOL * scale:
            raise AssertionError(f"FAN card vs CPU: max |Δ| {err} > {FAN_CARD_RTOL} × {scale}")
        x1d, xbd = x1.to(dev), xb.to(dev)
        fwd_ms = best_ms(lambda: fan(x1d))
        masks = get_heatmap(fan, xbd)
        heatmap_ms = best_ms(lambda: get_heatmap(fan, xbd), reps=3)
        if any(m.shape != (FAN_BATCH, 1, FAN_HW, FAN_HW) or not torch.isfinite(m).all()
               for m in masks):
            raise AssertionError("get_heatmap: masks not finite or of shape")
        trace_dir = os.path.join(tmp, "trace")
        with profile_trace(trace_dir):
            with span("demos/fan_forward"):
                fan(x1d)
                torch.cuda.synchronize()
    events = []
    for name in os.listdir(trace_dir):
        with open(os.path.join(trace_dir, name)) as f:
            events += json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if kernels == 0 or not any(e.get("name") == "demos/fan_forward" for e in events):
        raise AssertionError(f"profile_trace: {kernels} kernel events, annotation missing")
    return ({"forward_1x256_ms": fwd_ms, "get_heatmap_b8_ms": heatmap_ms,
             "card_vs_cpu": {"max_abs_err": err, "max_abs_heat": scale,
                             "bound": FAN_CARD_RTOL * scale},
             "mask_mean": [m.mean().item() for m in masks],
             "trace": {"kernel_events": kernels, "events": len(events)}},
            fan, xbd, masks)


def phase_demos(dev):
    """demo-web, demo, the FAN, align-faces, StarGAN v2's high-pass branch,
    the latent walk and make_videos, at full width (see the module doc)."""
    record = {"phase": "demos", "seconds": {}}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        record["demo_web"] = demo_web_run(dev, os.path.join(tmp, "web"))
        record["seconds"]["demo_web"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        line = cli_main(["demo", "--hw", *map(str, SINTEL_HW), "--n-frames", str(DEMO_CLI_FRAMES),
                         "--out-dir", os.path.join(tmp, "demo")])
        kind = video_signature(line["video"])
        if line["frames"] != DEMO_CLI_FRAMES or line["hw"] != list(SINTEL_HW) or kind is None:
            raise AssertionError(f"demo: {line}, file kind {kind}")
        record["demo"] = {**line, "kind": kind, "bytes": os.path.getsize(line["video"]),
                          "wall_s": time.perf_counter() - t0}
        record["seconds"]["demo"] = record["demo"]["wall_s"]

        t0 = time.perf_counter()
        record["fan"], fan, xb, masks = fan_run(dev, tmp)
        record["seconds"]["fan"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        frames = os.path.join(tmp, "frames")
        faces_in, faces_out = os.path.join(frames, "faces_in"), os.path.join(frames, "faces_out")
        os.makedirs(faces_in)
        rng = np.random.RandomState(1)
        for i in range(ALIGN_IMAGES):
            write_png(os.path.join(faces_in, f"{i:04d}.png"),
                      (scene(rng, (FAN_HW, FAN_HW)) * 255).astype(np.uint8))
        line = cli_main(["align-faces", "--input-dir", faces_in, "--output-dir-align", faces_out,
                         "--img-size", str(FAN_HW)])
        written = sorted(os.listdir(faces_out))
        if line["aligned"] != ALIGN_IMAGES or written != sorted(os.listdir(faces_in)):
            raise AssertionError(f"align-faces: {line}, wrote {written}")
        record["align_faces"] = {**line, "s_per_image": line["seconds"] / ALIGN_IMAGES,
                                 "written": len(written)}
        record["seconds"]["align_faces"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        torch.manual_seed(0)
        gen = StarGAN2Generator(HPF_SIZE, HPF_STYLE, w_hpf=1).to(dev).eval()
        mapping = MappingNetwork(HPF_LATENT, HPF_STYLE, HPF_DOMAINS).to(dev).eval()
        s = torch.randn(HPF_BATCH, HPF_STYLE, device=dev)
        with torch.inference_mode():
            out = gen(xb, s, masks)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            g_ms = best_ms(lambda: gen(xb, s, masks), reps=3)
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            moved = (out - gen(xb, s)).abs().max().item()
        if out.shape != xb.shape or not torch.isfinite(out).all() or moved == 0.0:
            raise AssertionError(f"StarGAN v2 w_hpf=1: shape {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}, masks moved it {moved}")
        one = [m[:1] for m in masks]
        latents = np.random.RandomState(2).randn(LATENTS, HPF_LATENT).astype(np.float32)
        t1 = time.perf_counter()
        path = latent_interpolation_video(lambda x, st: gen(x, st, one), mapping, xb[0], latents,
                                          torch.tensor([1], device=dev),
                                          os.path.join(tmp, "latent", "interp.mp4"),
                                          steps_per_pair=LATENT_STEPS)
        latent_s = time.perf_counter() - t1
        kind, n = video_signature(path), None
        if kind == "gif":
            with Image.open(path) as video:
                n = video.n_frames
        if kind is None or n not in (None, (LATENTS - 1) * LATENT_STEPS):
            raise AssertionError(f"latent_interpolation_video: {n} frames in {path}")
        record["stargan2_hpf"] = {
            "img_size": HPF_SIZE, "batch": HPF_BATCH, "w_hpf": 1, "forward_ms": g_ms,
            "peak_mem_gib": peak, "masks_moved_max_abs": moved,
            "latent_video": {"file": os.path.basename(path), "kind": kind,
                             "frames": (LATENTS - 1) * LATENT_STEPS, "frames_read": n,
                             "wall_s": latent_s}}
        record["seconds"]["stargan2_hpf"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        videos = make_videos(frames, os.path.join(tmp, "videos"))
        if len(videos) != 2 or not all(video_signature(v) for v in videos):
            raise AssertionError(f"make_videos: {videos}")
        record["make_videos"] = {"files": [os.path.basename(v) for v in videos],
                                 "kinds": [video_signature(v) for v in videos],
                                 "wall_s": time.perf_counter() - t0}
        record["seconds"]["make_videos"] = record["make_videos"]["wall_s"]
    record["kernel_launches"] = kernel_launches()
    if any(record["kernel_launches"].values()):
        raise AssertionError(f"demos launched a kernel: {record['kernel_launches']}")
    emit(record)


PAR_TRAIN_STEPS = 3  # updates bit for bit against the plain trainer's
PAR_TIMED_STEPS = 6  # Johnson steps timed a trainer
PAR_V2_BATCH = 8
PAR_V2_TIMED = 2  # StarGAN v2 iterations timed a trainer
PAR_TCL_RTOL = 1e-4  # sharded against serial TCL
DRYRUN_TIMEOUT_S = 300


def step_ms(fn, n):
    """Each of ``n`` calls of fn() timed by CUDA events: (median ms, all)."""
    marks = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in marks]
    return float(np.median(ms)), ms


def same_tensors(got, want, what):
    """Every tensor of two state_dicts equal bit for bit."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys differ")
    diff = [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]
    if diff:
        raise AssertionError(f"{what}: {len(diff)} tensors differ, first {diff[0]}")
    return len(want)


def adam_state(opt):
    return {f"{i}.{k}": v for i, st in enumerate(opt.state.values()) for k, v in st.items()}


def johnson_same_gradients(plain, reduced, batches, steps):
    """``steps`` updates of two Johnson trainers from the same gradients:
    the plain trainer's loss and backward on each batch, its gradients
    copied to ``reduced``, then each trainer's ``apply_gradients`` (the
    reduced one's all-reduces first). The card's backward is not bit for
    bit between two runs (reflection pad's and grid_sample's backward add
    with atomics), so both updates take one backward's gradients."""
    for _ in range(steps):
        batch = next(batches)
        plain.opt.zero_grad(set_to_none=True)
        with cudnn_enabled(True):
            loss, _ = plain.loss_fn(batch)
            loss.backward()
        for p, q in zip(plain.model.parameters(), reduced.model.parameters()):
            q.grad = p.grad.clone()
        plain.apply_gradients()
        reduced.apply_gradients()


def check_checkpoints(tmp, trees_by_layout):
    """Each (layout, step, trees) saved and restored by the Checkpointer;
    every tensor bit for bit. Returns {first file: files, tensors, bytes}."""
    out = {}
    for layout, step, trees in trees_by_layout:
        ckpt = Checkpointer(os.path.join(tmp, "ckpt"), layout)
        paths = ckpt.save(step, **trees)
        back = ckpt.restore(step, **{k: None for k in trees})
        n = 0
        for name, tree in trees.items():
            nested = all(isinstance(v, dict) for v in tree.values())
            flat = lambda t: ({f"{a}.{k}": v for a, sd in t.items()  # noqa: E731
                               for k, v in sd.items()} if nested else t)
            n += same_tensors(flat(back[name]), flat(tree), f"checkpoint {name}")
        out[os.path.basename(paths[0])] = {"files": [os.path.basename(p) for p in paths],
                                           "tensors": n,
                                           "bytes": sum(os.path.getsize(p) for p in paths)}
    return out


def phase_parallel(dev):
    """The NCCL dry run in a subprocess, started first; meanwhile, on a
    world-size-1 NCCL group in this process, the untimed parts (the serial
    evaluation, Johnson's updates from the same gradients, the warm-ups,
    the Checkpointer's round trips); once the dry run has ended, the timed
    parts (the sharded evaluation, the Johnson steps and StarGAN v2
    iterations with and without the reductions, the reductions alone)."""
    t_phase = time.perf_counter()
    record = {"phase": "parallel"}
    dryrun = subprocess.Popen([sys.executable, "-m", "vst_torch.parallel.dryrun", "1"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            initialize_distributed(f"file://{os.path.join(tmp, 'pg')}", 1, 0, device="cuda")
            try:
                mesh = create_mesh(devices=[dev])
                record["world_size"] = mesh.size
                record["backend"] = torch.distributed.get_backend()

                # untimed: the serial harness on the main path's clip
                style_net = seeded_style_net(dev)
                stylize = faststyle_stylize_fn(style_net, style_net.state_dict())
                raft = seeded_raft(20, dev)
                calls = [0]

                def raft_apply(a, b):
                    calls[0] += 1
                    return raft(a, b)

                video = SintelVideo("synthetic", synthetic_clip(8, CLIP_HW, seed=3))
                to_range = lambda f: f * 2.0 - 1.0  # noqa: E731 (feed-forward pipeline range)
                serial = evaluate_videos([video], stylize, raft_apply, styles=[0], dt_iters=2,
                                         frame_transform=to_range, device=dev)
                # one sharded pair warms the batch-1 RAFT and stylize, which the
                # serial harness (RAFT at batch 2 and 4) does not run
                evaluate_videos_sharded([SintelVideo("warm-up", video.frames[:2])], stylize,
                                        raft_apply, [0], mesh, frame_transform=to_range)

                # untimed: Johnson at 256² × 16 (TV on) fed by prefetch_to_mesh, 3
                # updates from the same gradients with and without the reduction
                styles = load_style_images(size=256)[:1]
                rng = np.random.RandomState(0)
                host = batch_to_tensors({"imgs": rng.rand(TRAIN_BATCH, 2, *TRAIN_HW, 3),
                                         "masks": np.ones((TRAIN_BATCH, 1, *TRAIN_HW, 1)),
                                         "flows": np.zeros((TRAIN_BATCH, 1, *TRAIN_HW, 2))},
                                        "cpu")
                plain, dp = (FastStyleTrainer(select_method("johnson", batch_size=TRAIN_BATCH),
                                              styles, seed=0, device=dev, mesh=m)
                             for m in (None, mesh))
                feed = prefetch_to_mesh(iter([host] * (PAR_TRAIN_STEPS + 1)), mesh)
                johnson_same_gradients(plain, dp, feed, PAR_TRAIN_STEPS)
                n_johnson = same_tensors(dp.model.state_dict(), plain.model.state_dict(),
                                         "Johnson at world size 1")
                n_johnson += same_tensors(adam_state(dp.opt), adam_state(plain.opt),
                                          "Johnson's Adam at world size 1")
                batch = next(feed)
                for t in (plain, dp):
                    t.train_step(batch)  # warm-up

                # untimed: StarGAN v2 AdvCon at 256² × 8, both trainers warmed up
                B = PAR_V2_BATCH
                gb = {"x_real": torch.rand(B, 3, *TRAIN_HW) * 2 - 1,
                      "x_real2": torch.rand(B, 3, *TRAIN_HW) * 2 - 1,
                      "x_ref": torch.rand(B, 3, *TRAIN_HW) * 2 - 1,
                      "y_org": torch.randint(0, 4, (B,)), "y_trg": torch.randint(0, 4, (B,)),
                      "mask": torch.ones(B, 1, *TRAIN_HW), "flow": torch.zeros(B, 2, *TRAIN_HW)}
                cfg2 = StarGAN2Config(img_size=TRAIN_HW[0], num_domains=4, lambda_tcl=100.0)
                gbatch = next(prefetch_to_mesh(iter([gb]), mesh))
                p2, d2 = (StarGAN2Trainer(cfg2, seed=0, device=dev, mesh=m) for m in (None, mesh))
                for t in (p2, d2):
                    t.train_iteration(gbatch)  # warm-up

                # untimed: the Checkpointer on the card, every tensor bit for bit
                torch.manual_seed(0)
                g_a = ResnetGenerator(3, 3, 64, 9).to(dev)
                ck = check_checkpoints(tmp, (
                    (LAYOUTS["faststyle"], None, {"model": dp.model.state_dict()}),
                    (LAYOUTS["stargan2"], 1, {"nets": d2.state_dicts(),
                                              "nets_ema": d2.state_dicts(use_ema=True)}),
                    (LAYOUTS["cyclegan"], 1, {"G_A": g_a.state_dict()})))
                restored = Checkpointer(os.path.join(tmp, "ckpt"), LAYOUTS["faststyle"]).restore(
                    None, model=FastStyleNet(3, 1))["model"].to(dev).eval()
                x = torch.rand(1, 3, *SINTEL_HW, device=dev)
                sid = torch.tensor(0, device=dev)
                with torch.no_grad():
                    if not torch.equal(restored(x, 1.0, sid)[1], dp.model.eval()(x, 1.0, sid)[1]):
                        raise AssertionError("the restored FastStyleNet's output differs")
                dp.model.train()
                record["checkpointer"] = {**ck, "restored_output_equal": True}
                del restored, g_a

                out, err = dryrun.communicate(timeout=DRYRUN_TIMEOUT_S)
                if dryrun.returncode != 0 or not out.startswith("dryrun_multichip(1): ok"):
                    raise AssertionError(f"dryrun 1: rc {dryrun.returncode}: {out[-500:]} "
                                         f"{err[-1500:]}")
                record["dryrun"] = {"rc": dryrun.returncode, "line": out.strip(),
                                    "ended_after_s": time.perf_counter() - t_phase}

                # timed, the dry run over: the sharded evaluation
                torch.cuda.synchronize()
                reset_counts()
                calls[0] = 0
                t0 = time.perf_counter()
                sharded = evaluate_videos_sharded([video], stylize, raft_apply, [0], mesh,
                                                  frame_transform=to_range)
                eval_s = time.perf_counter() - t0
                launches = corr_lookup.launches
                if launches != 20 * calls[0] or calls[0] != 2 * (7 + 3):
                    raise AssertionError(f"sharded evaluation: {launches} launches, "
                                         f"{calls[0]} RAFT calls")
                rel = {}
                for kind in TCL_KEYS:
                    want, got = serial[kind][f"{kind}_mean"], sharded[kind][f"{kind}_mean"]
                    rel[kind] = abs(got - want) / abs(want)
                    if not (math.isfinite(got) and rel[kind] <= PAR_TCL_RTOL):
                        raise AssertionError(f"sharded {kind} {got} against serial {want}")
                record["eval_sintel_sharded"] = {
                    "clip": [8, *CLIP_HW], "raft_iters": 20, "styles": [0],
                    "tcl": {k: sharded[k][f"{k}_mean"] for k in TCL_KEYS},
                    "serial_tcl": {k: serial[k][f"{k}_mean"] for k in TCL_KEYS},
                    "max_rel_err": rel, "DT_ms_per_st_pair": sharded["DT"]["DT_mean"],
                    "raft_calls": calls[0], "corr_lookup_launches": launches, "wall_s": eval_s}
                del raft

                # timed: Johnson's steps, then the reduction alone
                timed = {name: step_ms(lambda t=t: t.train_step(batch), PAR_TIMED_STEPS)
                         for name, t in (("plain", plain), ("reduced", dp))}
                record["johnson_step"] = {
                    "hw": list(TRAIN_HW), "batch": TRAIN_BATCH, "tv": dp.cfg.emphasis[2],
                    "bit_for_bit_after_updates": PAR_TRAIN_STEPS, "tensors_equal": n_johnson,
                    "step_ms_median": timed["plain"][0],
                    "reduced_step_ms_median": timed["reduced"][0],
                    "step_ms": timed["plain"][1], "reduced_step_ms": timed["reduced"][1],
                    "reduction_bytes": all_reduce_gradients([dp.opt], mesh),
                    "reduction_ms": time_ms(lambda: all_reduce_gradients([dp.opt], mesh))}
                del plain, dp, feed

                # timed: StarGAN v2's iterations; its four reductions (D twice,
                # G + F + E, G) leave the gradients bit for bit at world size 1
                timed = {name: step_ms(lambda t=t: t.train_iteration(gbatch), PAR_V2_TIMED)
                         for name, t in (("plain", p2), ("reduced", d2))}
                sets = ([d2.opts["disc"]], [d2.opts["disc"]],
                        [d2.opts[k] for k in ("generator", "mapping", "style_enc")],
                        [d2.opts["generator"]])
                grads = lambda: {f"{k}.{n}": p.grad for k, net in d2.nets.items()  # noqa: E731
                                 for n, p in net.named_parameters() if p.grad is not None}
                before = {k: g.clone() for k, g in grads().items()}
                v2_bytes = sum(all_reduce_gradients(o, mesh) for o in sets)
                record["stargan2_iteration"] = {
                    "hw": list(TRAIN_HW), "batch": B, "lambda_tcl": cfg2.lambda_tcl,
                    "gradients_equal_after_reduction": same_tensors(
                        grads(), before, "StarGAN v2's gradients through the reduction"),
                    "iteration_ms_median": timed["plain"][0],
                    "reduced_iteration_ms_median": timed["reduced"][0],
                    "iteration_ms": timed["plain"][1], "reduced_iteration_ms": timed["reduced"][1],
                    "reduction_bytes": v2_bytes,
                    "reduction_ms": sum(time_ms(lambda o=o: all_reduce_gradients(o, mesh), 5, 1)
                                        for o in sets)}
                del p2, d2, before
            finally:
                torch.distributed.destroy_process_group()
    finally:
        if dryrun.poll() is None:
            dryrun.kill()
            dryrun.communicate()
    record["seconds"] = time.perf_counter() - t_phase
    emit(record)
    return {"eval_sintel_sharded": launches}


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


PHASES = ("build", "kernel", "stylize", "raft", "main_path", "eval_sintel", "raft_bf16",
          "stylize_video", "trunk_conv", "kernel_cost", "gemm_rate", "bench", "train_faststyle",
          "obst", "fc2_metrics", "stargan", "cyclegan", "datagen", "raft_train", "demos",
          "parallel")


def null_entries(name, source, replaces, variants):
    """The kernels line's entries of a kernel whose phase did not run: every
    measured value null."""
    return kernel_entries(name, source, replaces, {v: {
        k: None for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        for v in variants})


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
    max_err, timing = run("kernel", phase_kernel, dev) or (None, {})
    run("stylize", phase_stylize, dev)
    run("raft", phase_raft, dev)
    launches = run("main_path", phase_main_path, dev)
    by_path = {"main_path": launches,
               "eval_sintel_ruder": run("eval_sintel", phase_eval_sintel, dev)}
    by_path.update({f"raft_{k}": v for k, v in (run("raft_bf16", phase_raft_bf16, dev)
                                                 or {}).items()})
    run("stylize_video", phase_stylize_video, dev)
    trunk, weighted_errs = run("trunk_conv", phase_trunk_conv, dev) or (None, None)
    cost = run("kernel_cost", phase_kernel_cost, dev, weighted_errs)
    gemm = run("gemm_rate", phase_gemm_rate, dev)
    run("bench", phase_bench, dev)
    run("train_faststyle", phase_train_faststyle, dev)
    by_path["eval_obst"] = run("obst", phase_obst, dev)
    run("fc2_metrics", phase_fc2_metrics, dev)
    by_path.update({f"eval_sintel_{k}": v for k, v in (run("stargan", phase_stargan, dev)
                                                        or {}).items()})
    by_path.update(run("cyclegan", phase_cyclegan, dev) or {})
    by_path.update(run("datagen", phase_datagen, dev) or {})
    by_path.update(run("raft_train", phase_raft_train, dev) or {})
    run("demos", phase_demos, dev)
    by_path.update(run("parallel", phase_parallel, dev) or {})
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
    emit({"kernels": [
        {"name": "corr_lookup", "route": "cuda", "source": "vst_torch/csrc/corr_lookup.cu",
         "replaces": "vst/kernels/pallas_corr.py:87", "launches": launches,
         "max_abs_err": max_err, "ms": timing.get("kernel_ms"), "plain_ms": timing.get("plain_ms"),
         "bound_ms": timing.get("bound_ms"), "bound_by": timing.get("bound_by"),
         "library_ms": timing.get("library_ms"), "device_ms": timing.get("device_ms"),
         "host_ms": timing.get("host_ms"),
         "launches_by_path": {k: v for k, v in by_path.items() if v is not None}},
        *trunk_entries, *cost_entries, *gemm_entries,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
