"""Sintel video eval harness: TCL-ST / TCL-LT / DT, port of
``vst/eval/sintel.py`` (``utils/sintel_eval.py:142-233``).

Per video × style: stylize every frame (timed → DT), estimate RAFT flow
between the current and the previous (ST) / 5-back (LT) frame, build the
fb-consistency mask, backward-warp the re-stylized earlier frame and take
the RMS masked difference. Quirks kept (PARITY.md): frames cropped to 432
rows; ``computeTCL`` re-stylizes the earlier frame; the caller's pipeline
range goes to RAFT unchanged unless ``raft_preprocess`` says otherwise.

Frames are NCHW tensors on the harness's device. DT is timed with CUDA
events after a ``torch.cuda.synchronize()`` on the card (the reference's
timer has no sync) and with the host clock on the CPU. With
``VST_PROFILE_DIR`` set, the evaluation is traced into that directory
(``vst_torch.core.trace``), each DT block under ``DT/<video>_s<d>``.

``evaluate_videos_sharded`` is the multi-GPU harness: each rank scores one
frame pair of a batch of world-size pairs and the per-frame values are
all-gathered in order (``vst_torch.parallel``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vst_torch import set_f32_precision
from vst_torch.core.metrics import aggregate_means, save_json
from vst_torch.core.timing import chain_ms
from vst_torch.core.trace import annotate, profile_trace
from vst_torch.data.fc2 import _read_image
from vst_torch.ops.flowtools import fbc_mask
from vst_torch.ops.image import InputPadder
from vst_torch.ops.sample import warp
from vst_torch.parallel.mesh import Mesh, all_gather_rows


class SintelVideo:
    """One video's frames in host memory: (N, H, W, 3) float32 [0, 1], H=432."""

    def __init__(self, name: str, frames: np.ndarray):
        self.name = name
        self.frames = frames

    def __len__(self):
        return self.frames.shape[0]


def load_sintel_videos(sintel_dir: str, crop_h: int = 432) -> List[SintelVideo]:
    """training/final + test/final videos, frames sorted and cropped to
    ``crop_h`` rows (``sintel_eval.py:156-167``, SingleSintelVideo). Frames
    are read through PIL (vst reads them with imageio, which the port does not
    require; for a PNG both give the same pixels)."""
    videos = []
    for split in ("training", "test"):
        base = os.path.join(sintel_dir, split, "final")
        if not os.path.isdir(base):
            continue
        for vid in sorted(os.listdir(base)):
            vdir = os.path.join(base, vid)
            frames = [_read_image(os.path.join(vdir, fid)).astype(np.float32)[:crop_h] / 255.0
                      for fid in sorted(os.listdir(vdir))]
            videos.append(SintelVideo(vid, np.stack(frames)))
    return videos


def tcl_value(mask, x_fake, warped):
    """RMS(mask·(x_fake − warped)): the TCL of one frame pair."""
    return torch.sqrt(torch.mean((mask * (x_fake - warped)) ** 2))


def frames_to_device(frames: np.ndarray, device, transform: Optional[Callable] = None):
    """(N, H, W, 3) host frames, mapped by ``transform``, → NCHW float32 on
    ``device``."""
    if transform is not None:
        frames = transform(frames)
    return torch.from_numpy(np.ascontiguousarray(frames, np.float32)).permute(
        0, 3, 1, 2).contiguous().to(device)


def flows_to_device(flows, device):
    """``flow_fn``'s host (H, W, 2) flows → (1, 2, H, W) float32 on ``device``."""
    return [torch.from_numpy(np.asarray(f, np.float32)).permute(2, 0, 1)[None].to(device)
            for f in flows]


def aggregate_results(tables: Dict[str, Dict[str, float]], num_styles: int,
                      out_path: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """Per metric ("TCL-ST", ...): the reference's ``<ID>_mean`` and
    ``<ID>_mean_s{d}`` aggregation of its per-(video, style) values, written
    to ``<out_path>/<ID>.json`` when ``out_path`` is given."""
    results = {}
    for out_id, data in tables.items():
        agg = aggregate_means(data, num_styles=num_styles)
        agg[f"{out_id}_mean"] = agg.pop("_mean")
        for d in range(1, num_styles + 1):
            if f"_mean_s{d}" in agg:
                agg[f"{out_id}_mean_s{d}"] = agg.pop(f"_mean_s{d}")
        results[out_id] = agg
        if out_path:
            save_json(agg, os.path.join(out_path, out_id + ".json"), aggregate=False)
    return results


def make_tcl_program(stylize_fn: Callable, raft_apply: Callable,
                     raft_preprocess: Optional[Callable] = None):
    """The per-frame eval programs.

    stylize_fn(img, style) → stylized frame of the same size, in the
    caller's pipeline range. raft_apply(img1, img2) → (flow_low, flow_up)
    with flow_up (B, 2, H, W). raft_preprocess maps pipeline frames to what
    the method family feeds RAFT (identity by default).

    Returns ``tcl(img, img_earlier, style) → (x_fake, tcl)``,
    ``stylize(img, style)``, ``tcl_gt(img, img_earlier, style, ff, bf)`` and
    ``tcl2(img, img_st, img_lt, style) → (x_fake, tcl_st, tcl_lt)``.
    """
    prep = raft_preprocess or (lambda x: x)

    def compute_raft_multi(imgs_a, imgs_b):
        """K flow pairs, forward AND backward, in ONE RAFT call at batch 2K;
        rows [0, K) are the forward flows a_i→b_i, rows [K, 2K) backward."""
        padder = InputPadder(imgs_a[0].shape)
        padded = [padder.pad(prep(a), prep(b)) for a, b in zip(imgs_a, imgs_b)]
        a = torch.cat([p[0] for p in padded] + [p[1] for p in padded], 0)
        b = torch.cat([p[1] for p in padded] + [p[0] for p in padded], 0)
        _, flow_up = raft_apply(a, b)
        n = imgs_a[0].shape[0]
        k = len(imgs_a)
        fwd = [padder.unpad(flow_up[i * n:(i + 1) * n]) for i in range(k)]
        bwd = [padder.unpad(flow_up[(k + i) * n:(k + i + 1) * n]) for i in range(k)]
        return fwd, bwd

    @torch.no_grad()
    def tcl(img, img2, style):
        """computeTCL (``sintel_eval.py:104-110``): img = current frame,
        img2 = earlier frame."""
        x_fake = stylize_fn(img, style)
        (ff,), (bf,) = compute_raft_multi([img2], [img])
        warped = warp(stylize_fn(img2, style), bf)
        return x_fake, tcl_value(fbc_mask(ff, bf), x_fake, warped)

    @torch.no_grad()
    def tcl_gt(img, img2, style, ff, bf):
        """The same metric with given flow (a dataset's or a motion oracle's)."""
        x_fake = stylize_fn(img, style)
        warped = warp(stylize_fn(img2, style), bf)
        return x_fake, tcl_value(fbc_mask(ff, bf), x_fake, warped)

    @torch.no_grad()
    def tcl2(img, img_st, img_lt, style):
        """ST and LT TCL of one frame: the current frame is stylized once and
        both flow pairs share one RAFT call at batch 4."""
        x_fake = stylize_fn(img, style)
        fwd, bwd = compute_raft_multi([img_st, img_lt], [img, img])
        vals = [tcl_value(fbc_mask(ff, bf), x_fake, warp(stylize_fn(earlier, style), bf))
                for ff, bf, earlier in zip(fwd, bwd, (img_st, img_lt))]
        return x_fake, vals[0], vals[1]

    @torch.no_grad()
    def stylize(img, style):
        return stylize_fn(img, style)

    return tcl, stylize, tcl_gt, tcl2


@torch.no_grad()
def evaluate_videos(
    videos: Sequence[SintelVideo],
    stylize_fn: Callable,
    raft_apply: Callable,
    styles: Sequence,
    out_path: Optional[str] = None,
    lt_len: int = 5,
    frame_transform: Optional[Callable] = None,
    raft_preprocess: Optional[Callable] = None,
    save_frames: bool = False,
    dt_iters: int = 20,
    num_domains: Optional[int] = None,
    flow_fn: Optional[Callable] = None,
    save_transform: Optional[Callable] = None,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Run the Sintel benchmark on ``device`` (CUDA unless the caller asks
    for the CPU; there is no fallback). Sets float32 precision first
    (TF32 off, ``set_f32_precision``).

    ``styles``: style ids; style index d is reported as ``_s{d+1}``.
    ``frame_transform`` maps [0,1] frames into the pipeline range;
    ``save_transform(style_index, frame)`` post-processes saved PNGs only;
    ``flow_fn(video, i, j)`` → (ff, bf) numpy (H, W, 2) replaces RAFT.
    Returns {"TCL-ST": {...}, "TCL-LT": {...}, "DT": {...}} with the
    reference's ``<ID>_mean`` / ``<ID>_mean_s{d}`` aggregation; writes the
    JSONs when ``out_path`` is given.
    """
    set_f32_precision()
    device = torch.device(device)
    progs = make_tcl_program(stylize_fn, raft_apply, raft_preprocess=raft_preprocess)
    styles = [torch.as_tensor(s, device=device) for s in styles]

    with profile_trace():  # a no-op unless VST_PROFILE_DIR is set
        # warm every (resolution, style) stylize before any DT timing
        if dt_iters > 0:
            seen_hw = set()
            for video in videos:
                hw = video.frames.shape[1:3]
                if hw in seen_hw:
                    continue
                seen_hw.add(hw)
                f0 = frames_to_device(video.frames[:1], device, frame_transform)
                for style in styles:
                    for _ in range(2):
                        float(progs[1](f0, style).sum())

        tcl_st: Dict[str, float] = {}
        tcl_lt: Dict[str, float] = {}
        dt: Dict[str, float] = {}
        for video in videos:
            frames = frames_to_device(video.frames, device, frame_transform)
            for d, style in enumerate(styles):
                key = f"{video.name}_s{d + 1}"
                tcl_st[f"TCL-ST_{key}"], tcl_lt[f"TCL-LT_{key}"], dt[f"DT_{key}"] = _eval_one(
                    video, frames, d, style, progs, lt_len, dt_iters, save_frames,
                    out_path, flow_fn, save_transform)

    nd = (num_domains or len(styles) + 1) - 1
    return aggregate_results({"TCL-ST": tcl_st, "TCL-LT": tcl_lt, "DT": dt}, nd, out_path)


def _eval_one(video, frames, d, style, progs, lt_len, dt_iters, save_frames,
              out_path, flow_fn, save_transform):
    """One (video, style) pass: DT chained timing, then per-frame ST/LT TCL."""
    tcl_prog, stylize_prog, tcl_gt_prog, tcl2_prog = progs
    key = f"{video.name}_s{d + 1}"
    n = len(video)
    st_vals, lt_vals = [], []

    # DT: the stylize program alone (the reference times only the generator
    # call, sintel_eval.py:210-214); chained, best of 2 windows
    with annotate(f"DT/{key}"):
        float(stylize_prog(frames[0:1], style).sum())
        dt_ms = min(chain_ms(lambda x: stylize_prog(x, style), frames[0:1], dt_iters)
                    for _ in range(2)) if dt_iters > 0 else 0.0

    def tcl_pair(img, j, i):
        if flow_fn is None:
            return tcl_prog(img, frames[j:j + 1], style)[1]
        ff, bf = flows_to_device(flow_fn(video, i, j), frames.device)
        return tcl_gt_prog(img, frames[j:j + 1], style, ff, bf)[1]

    for i in range(n):
        img = frames[i:i + 1]
        if i >= lt_len and flow_fn is None:
            _, st_v, lt_v = tcl2_prog(img, frames[i - 1:i],
                                      frames[i - lt_len:i - lt_len + 1], style)
            st_vals.append(float(st_v))
            lt_vals.append(float(lt_v))
        else:
            if i > 0:
                st_vals.append(float(tcl_pair(img, i - 1, i)))
            if i >= lt_len:
                lt_vals.append(float(tcl_pair(img, i - lt_len, i)))
        if save_frames and out_path:
            x_fake = stylize_prog(img, style)[0].permute(1, 2, 0).cpu().numpy()
            if save_transform is not None:
                x_fake = save_transform(d, x_fake)
            _save_frame(x_fake, os.path.join(out_path, key, f"frame_{i:04d}.png"))

    st = float(np.mean(st_vals)) if st_vals else 0.0
    lt = float(np.mean(lt_vals)) if lt_vals else 0.0
    return st, lt, dt_ms


def _save_frame(x: np.ndarray, path: str) -> None:
    import imageio.v2 as imageio

    os.makedirs(os.path.dirname(path), exist_ok=True)
    imageio.imwrite(path, (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8))


@torch.no_grad()
def evaluate_videos_sharded(
    videos: Sequence[SintelVideo],
    stylize_fn: Callable,
    raft_apply: Callable,
    styles: Sequence,
    mesh: Mesh,
    lt_len: int = 5,
    frame_transform: Optional[Callable] = None,
    raft_preprocess: Optional[Callable] = None,
) -> Dict[str, Dict[str, float]]:
    """The Sintel TCL over the mesh's ranks (vst's
    ``evaluate_videos_sharded``, ``vst/eval/sintel.py:325``), on the rank's
    device (``mesh.device``: CUDA unless the mesh was made for the CPU).

    Per (video, style), the ST pairs (i − 1, i) and then the LT pairs
    (i − lt_len, i) go in batches of ``mesh.size`` pairs, one a rank, the
    tail padded by repeating its last pair and the padding dropped. A rank
    stylizes its current frame, runs RAFT forward and backward as two
    calls, builds the fb mask, warps the re-stylized earlier frame with the
    backward flow and takes the RMS; the per-frame values are all-gathered
    in rank order. ``DT_<key>`` is the ST pass's wall clock over its pair
    count, in ms. Every rank returns the same results, aggregated as
    :func:`evaluate_videos` does over ``len(styles)`` styles.
    """
    set_f32_precision()
    device = mesh.device
    prep = raft_preprocess or (lambda x: x)
    n_dev = mesh.size
    styles = [torch.as_tensor(s, device=device) for s in styles]

    def tcl_one(img, prev, style):
        x_fake = stylize_fn(img, style)
        padder = InputPadder(img.shape)
        i1, i2 = padder.pad(prep(prev), prep(img))
        ff = padder.unpad(raft_apply(i1, i2)[1])
        bf = padder.unpad(raft_apply(i2, i1)[1])
        warped = warp(stylize_fn(prev, style), bf)
        return torch.sqrt(torch.mean((fbc_mask(ff, bf) * (x_fake - warped)) ** 2, dim=(1, 2, 3)))

    tcl_st: Dict[str, float] = {}
    tcl_lt: Dict[str, float] = {}
    dt: Dict[str, float] = {}
    for video in videos:
        frames = frames_to_device(video.frames, device, frame_transform)
        n = len(video)
        for d, style in enumerate(styles):
            key = f"{video.name}_s{d + 1}"

            def run_pairs(cur_idx, prev_idx):
                vals = []
                t0 = time.perf_counter()
                for i in range(0, len(cur_idx), n_dev):
                    ci, pi = cur_idx[i:i + n_dev], prev_idx[i:i + n_dev]
                    real = len(ci)
                    ci = ci + [ci[-1]] * (n_dev - real)  # the tail padded to the ranks
                    pi = pi + [pi[-1]] * (n_dev - real)
                    c, p = ci[mesh.rank], pi[mesh.rank]
                    per = tcl_one(frames[c:c + 1], frames[p:p + 1], style)
                    vals.extend(all_gather_rows(per, mesh)[:real].tolist())
                return vals, time.perf_counter() - t0

            st_vals, t_st = run_pairs(list(range(1, n)), list(range(0, n - 1)))
            lt_vals, _ = run_pairs(list(range(lt_len, n)), list(range(0, n - lt_len)))
            tcl_st[f"TCL-ST_{key}"] = float(np.mean(st_vals)) if st_vals else 0.0
            tcl_lt[f"TCL-LT_{key}"] = float(np.mean(lt_vals)) if lt_vals else 0.0
            dt[f"DT_{key}"] = t_st / max(len(st_vals), 1) * 1000.0
    return aggregate_results({"TCL-ST": tcl_st, "TCL-LT": tcl_lt, "DT": dt}, len(styles))
