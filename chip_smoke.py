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
   of the 32-byte sectors its windows touch; the autograd.Function's
   gradient against the plain version's (≤ 1e-5).
3. stylize: FastStyleNet (3 styles) at 1×3×436×1024, chained DT.
4. raft: full RAFT, 20 iterations, at 4×3×432×1024 through the kernel;
   a breakdown by part (and the update block on cuDNN, which RAFT avoids);
   flow at 2×3×64×96 against the same net with the plain lookup (≤ 1e-3 px).
5. main_path: evaluate_sintel_faststyle on a seeded synthetic 8-frame clip
   at 432×1024, styles (0, 1, 2), RAFT through the kernel; first the same
   harness at 64×96 against the plain lookup (TCL ≤ 1e-4 relative).
6. trunk_conv: pad_conv3x3 (modes full and mxu_only) against its plain
   version at the trunk shape 1×109×256×128, a ragged 2×13×37×64, the
   CPU-test shapes, C_in ≠ C_out, C_out = 8 and 136, batch 3 and H = 2, f32
   (≤ 1e-4 absolute) and bf16 (≤ 1e-3 + 2⁻⁷·|plain|); then the probe
   vst_torch.probes.bisect_im2col: ms/conv over a 10-conv chain, plain,
   cuDNN and bound.
7. kernel_cost: the four modes against their plain versions at the trunk
   and ragged shapes, then the probe vst_torch.probes.bisect_kernel_cost,
   each mode beside one library call that computes it.
8. gemm_rate: the kernel against its plain version at every (K, N) of the
   sweep (f32 ≤ 1e-5·max|y|, bf16 ≤ 2⁻⁷·max|y|), then the probe
   vst_torch.probes.bisect_mxu: ms, TF/s, bound, one cuBLAS call of depth
   64·K (library_ms) and 64 × cuBLAS (library_x64_ms); the kernels line
   lists K = N = 128 and K = 1152, N = 128, each with its own max |Δ| and
   the launches of its timing.
9. bench: vst_torch.bench on f32_b1, bf16_b1 and bf16_b8 (eager chain and
   CUDA-graph chain), and `vst_torch.cli bench-raft` on its f32 variant.

Phases 5–9 each drive one path with the kernels' launch counts set to 0
just before it and read just after; a kernel of the path that was never
launched fails the run. Then the card's name and power limit (nvidia-smi),
the kernels line and the result line. Float32 with TF32 off. Weights and
inputs are random, from seeds. Needs one CUDA device; exits 1 without one.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from vst_torch import bench, set_f32_precision
from vst_torch.cli.__main__ import main as cli_main
from vst_torch.core.roofline import PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S
from vst_torch.core.timing import chain_ms
from vst_torch.eval.drivers import evaluate_sintel_faststyle, faststyle_stylize_fn
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
from vst_torch.models.faststyle import FastStyleNet
from vst_torch.nn.conv import without_cudnn
from vst_torch.probes import bisect_im2col, bisect_kernel_cost, bisect_mxu

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
# gemm_rate against its plain version, relative to max|y|: f32 sums of up to
# 64·1152 terms in another order; bf16 one rounding of the f32 sum
GEMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
DTYPES = (torch.float32, torch.bfloat16)
KERNEL_SOURCES = ("corr_lookup", "pad_conv3x3", "gemm_rate")
# f32 operations per lookup output: level scale and offset (2 per axis), floor
# fractions and complements (4), 4 corner weights, 4 products, 3 sums
OPS_PER_OUTPUT = 17


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


def seeded_raft(iters, dev, seed=0, lookup=corr_lookup):
    torch.manual_seed(seed)
    return RAFT(iters=iters, lookup=lookup).to(dev).eval()


def seeded_style_net(dev, seed=0):
    torch.manual_seed(seed)
    net = FastStyleNet(n_styles=3)
    with torch.no_grad():  # spread the random net's output over [0, 255]
        net.deconv3.conv2d.weight.mul_(300.0)
    return net.to(dev).eval()


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
        with without_cudnn():
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


def phase_main_path(dev):
    style_net = seeded_style_net(dev)
    sd = style_net.state_dict()

    # a reference on a small input: the same harness with the plain lookup
    small = SintelVideo("small", synthetic_clip(7, (64, 96), seed=2))
    small_vals = []
    for lookup in (corr_lookup, lookup_pyramid):
        raft = seeded_raft(4, dev, seed=2, lookup=lookup)
        res = evaluate_sintel_faststyle(style_net, sd, [small], lambda a, b: raft(a, b),
                                        dt_iters=1, device=dev)
        small_vals.append([res[k][f"{k}_small_s{d}"] for k in ("TCL-ST", "TCL-LT")
                           for d in (1, 2, 3)])
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(*small_vals))
    if rel > TCL_RTOL or not all(v > 0 for v in small_vals[1]):
        raise AssertionError(f"small-input TCL kernel vs plain: {rel} > {TCL_RTOL}")

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

    means = {k: res[k][f"{k}_mean"] for k in ("TCL-ST", "TCL-LT", "DT")}
    if not all(math.isfinite(v) for v in means.values()) or min(means.values()) <= 0:
        raise AssertionError(f"main path means not finite and positive: {means}")
    if launches <= 0:
        raise AssertionError("the main path never launched the corr_lookup kernel")
    emit({"phase": "main_path", "clip": [8, 432, 1024], "styles": [0, 1, 2],
          "raft_iters": 20, **means, "corr_lookup_launches": launches, "seconds": seconds,
          "tcl2_ms": tcl2_ms, "small_reference_max_rel_err": rel})
    return launches


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
    """Each mode and dtype against its plain version on the same inputs;
    returns {(mode, dtype name): max |Δ|} over ``shapes``."""
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
                if dtype == torch.bfloat16:
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
            for k, rec in zip(keys, records)}


def phase_kernel_cost(dev):
    errs = check_pad_conv3x3(dev, MODES, CONV_SHAPES[:2])
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


def kernel_entries(name, source, replaces, measured):
    """The kernels line's entries of one kernel, one per variant."""
    return [{"name": f"{name}_{variant}", "route": "cuda", "source": source,
             "replaces": replaces, "launches": m["launches"], "max_abs_err": m["max_abs_err"],
             "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
             "bound_by": m["bound_by"], "library_ms": m.get("library_ms"),
             **({"library_x64_ms": m["library_x64_ms"]} if "library_x64_ms" in m else {})}
            for variant, m in measured.items()]


def per_conv(measured):
    """A probe record's per-conv times under the kernels line's names."""
    return {"launches": measured["launches"], "max_abs_err": measured["max_abs_err"],
            "ms": measured["ms_per_conv"], "plain_ms": measured["plain_ms_per_conv"],
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
    trunk = phase_trunk_conv(dev)
    cost = phase_kernel_cost(dev)
    gemm = phase_gemm_rate(dev)
    phase_bench(dev)

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    conv_source = "vst_torch/csrc/pad_conv3x3.cu"
    emit({"kernels": [
        {"name": "corr_lookup", "route": "cuda", "source": "vst_torch/csrc/corr_lookup.cu",
         "replaces": "vst/kernels/pallas_corr.py:87", "launches": launches,
         "max_abs_err": max_err, "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
         "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
         "library_ms": timing["library_ms"]},
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
