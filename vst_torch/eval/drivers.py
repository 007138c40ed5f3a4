"""Per-family Sintel and FC2 drivers, port of ``vst/eval/drivers.py``:

* the feed-forward family on Sintel (``:29-73``: Johnson, Dumoulin, Huang,
  ReCoNet through the generic harness; ``:378-506``: Ruder's streaming
  protocol) and on FC2 (``:509-597``, Ruder);
* OBST on Sintel (``:147-279``, streaming with a warm start from the warped
  previous stylized frame) and on FC2 (``:282-375``);
* StarGAN v2 and v1 on Sintel (``:76-132``): frames in [−1, 1] into the
  generator and into RAFT, domains 1 … D−1 as the styles;
* the CycleGAN family on Sintel (``:131-144``, vst's CLI ``:547-573``): one
  model a style, frames in [−1, 1].

The feed-forward harness normalises frames with mean/std 0.5
(``fast_style_transfer.py:407-410``): the net sees [−1, 1] frames, and so
does RAFT, which applies its own 2·(x/255)−1 on top (``raft.py:89-90``).
Outputs are clamp(out/255, 0, 1); the style-3 grayscale is a save-time
effect only. OBST works in caffe space (BGR ×255 about the mean).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from vst_torch import set_f32_precision
from vst_torch.core.metrics import save_json
from vst_torch.core.timing import call_ms
from vst_torch.core.trace import span
from vst_torch.data.fc2 import to_grayscale3
from vst_torch.eval.fc2 import batch_to_device, to_nchw
from vst_torch.eval.sintel import (aggregate_results, evaluate_videos, flows_to_device,
                                   frames_to_device, tcl_value)
from vst_torch.metrics.fid import InceptionV3, fid_from_activations
from vst_torch.ops.flowtools import fbc_mask
from vst_torch.ops.image import InputPadder
from vst_torch.ops.sample import warp
from vst_torch.perceptual.vgg import obst_postp, obst_prep


def faststyle_stylize_fn(model, state_dict):
    """stylize_fn for evaluate_videos, style = style id. Loads
    ``state_dict`` into ``model`` (a ``FastStyleNet``; span
    ``vst.eval.load``), which stands in for vst's (trainer, params); output
    clamp(model/255, 0, 1)
    (``fast_style_transfer.py:514-515``)."""
    with span("vst.eval.load"):
        model.load_state_dict(state_dict)
        model.eval()

    def fn(img, style_id):
        _, out = model(img, 1.0, style_id)
        return (out / 255.0).clamp(0.0, 1.0)

    return fn


def grayscale_save_transform(grayscale_style: Optional[int] = 2):
    """Saved-frame post-process for reference style 3 (0-based id 2),
    ``save_image(..., gray=True)``: PIL ``Grayscale``, ITU-R 601 luma."""

    def fn(style_index, frame):
        if grayscale_style is None or style_index != grayscale_style:
            return frame
        g = 0.299 * frame[..., 0] + 0.587 * frame[..., 1] + 0.114 * frame[..., 2]
        return np.repeat(np.asarray(g)[..., None], 3, axis=-1)

    return fn


def evaluate_sintel_faststyle(model, state_dict, videos, raft_apply,
                              styles=(0, 1, 2), out_path=None, device="cuda", **kw):
    """The FastStyleNet Sintel benchmark on ``device`` (CUDA by default):
    frames ×2−1 into both the net and RAFT. ``model`` must already lie on
    ``device``; ``raft_apply`` is bound by the caller."""
    return evaluate_videos(
        videos, faststyle_stylize_fn(model, state_dict), raft_apply,
        styles=list(styles), out_path=out_path,
        frame_transform=lambda f: f * 2.0 - 1.0,
        save_transform=grayscale_save_transform(),
        device=device, **kw,
    )


@torch.no_grad()
def evaluate_sintel_ruder(model, state_dict, pre_model, pre_state_dict, videos,
                          raft_apply: Callable, styles=(0, 1, 2), out_path=None,
                          lt_len: int = 5, dt_iters: int = 20, flow_fn=None,
                          num_domains=None, device="cuda"):
    """Ruder's streaming Sintel evaluation (``fast_style_transfer.py:494-556``
    with ``fs_ruder.infer_method``, ``:110-121``) on ``device`` (CUDA by
    default). ``model`` is the 7-input FastStyleNet, ``pre_model`` the
    3-input frame-0 bootstrap; both must lie on ``device`` and get their
    ``state_dict`` here.

    Frame 0 goes through the bootstrap. Frame i > 0: RAFT(frame i−1,
    frame i) forward and backward in one call at batch 2, the fb mask,
    ``warp_last = warp(x_fake_{i−1}, bf)``, then the 7-input net on
    cat(frame, mask, warp_last). TCL-ST = RMS(mask·(x_fake − warp_last)):
    the warp is both the net's input and the metric's target. TCL-LT warps
    the output of frame i−5 with the i−5 pair's flow. ``flow_fn(video, i,
    j)`` → (ff, bf) host arrays replaces RAFT. DT is the net call alone,
    timed after the flow, mask and warp have drained (``call_ms``).
    ``dt_iters`` is taken for the harness's signature and unused, as in vst.
    """
    set_f32_precision()
    device = torch.device(device)
    for net, sd in ((model, state_dict), (pre_model, pre_state_dict)):
        net.load_state_dict(sd)
        net.eval()

    def stylize0(img, sid):
        return (pre_model(img, 1.0, sid)[1] / 255.0).clamp(0.0, 1.0)

    def stylize_i(img, mask, warped, sid):
        return (model(torch.cat([img, mask, warped], 1), 1.0, sid)[1] / 255.0).clamp(0.0, 1.0)

    def flow_and_mask(video, frames, i, j):
        """(bf, mask): the backward flow frame i → the earlier frame j and
        the fb-consistency mask."""
        if flow_fn is None:
            earlier, current = frames[j:j + 1], frames[i:i + 1]
            padder = InputPadder(earlier.shape)
            i1, i2 = padder.pad(earlier, current)
            _, up = raft_apply(torch.cat([i1, i2], 0), torch.cat([i2, i1], 0))
            ff, bf = padder.unpad(up[:1]), padder.unpad(up[1:])
        else:
            ff, bf = flows_to_device(flow_fn(video, i, j), device)
        return bf, fbc_mask(ff, bf)

    tcl_st, tcl_lt, dt = {}, {}, {}
    for video in videos:
        frames01 = frames_to_device(video.frames, device)
        frames = frames01 * 2.0 - 1.0  # the eval Normalize(0.5) quirk
        for d, style in enumerate(styles):
            sid = torch.as_tensor(style, device=device)
            key = f"{video.name}_s{d + 1}"
            st_vals, lt_vals, dt_vals, hist = [], [], [], []
            stylize0(frames[0:1], sid)  # warm both nets before timing
            stylize_i(frames[0:1], torch.zeros_like(frames[0:1, :1]), frames01[0:1], sid)
            for i in range(len(video)):
                img = frames[i:i + 1]
                if i == 0:
                    x_fake, ms = call_ms(lambda: stylize0(img, sid), device)
                else:
                    bf, mask = flow_and_mask(video, frames, i, i - 1)
                    warp_last = warp(hist[-1], bf)
                    x_fake, ms = call_ms(lambda: stylize_i(img, mask, warp_last, sid), device)
                    st_vals.append(float(tcl_value(mask, x_fake, warp_last)))
                dt_vals.append(ms)
                if i >= lt_len:
                    bf5, m5 = flow_and_mask(video, frames, i, i - lt_len)
                    lt_vals.append(float(tcl_value(m5, x_fake, warp(hist.pop(0), bf5))))
                hist.append(x_fake)
            tcl_st[f"TCL-ST_{key}"] = float(np.mean(st_vals)) if st_vals else 0.0
            tcl_lt[f"TCL-LT_{key}"] = float(np.mean(lt_vals)) if lt_vals else 0.0
            dt[f"DT_{key}"] = float(np.mean(dt_vals))

    nd = (num_domains or len(styles) + 1) - 1
    return aggregate_results({"TCL-ST": tcl_st, "TCL-LT": tcl_lt, "DT": dt}, nd, out_path)


def stargan2_stylize_fn(generator, mapping, styles, device="cuda"):
    """stylize_fn for evaluate_videos, StarGAN v2: style d of ``styles``, a
    list of (domain y, latent z (1, latent_dim)), is G(img, F(z, y))
    (``utils/sintel_eval.py:207-208``); the harness passes d as a device
    index, so the call reads no host value. vst draws one z per (video,
    style) pass, not per frame as the reference; so does the port."""
    device = torch.device(device)
    ys = torch.tensor([int(y) for y, _ in styles], device=device)
    zs = torch.cat([torch.as_tensor(np.asarray(z, np.float32)).reshape(1, -1)
                    for _, z in styles]).to(device)

    def fn(img, d):
        d = d.reshape(1)
        return generator(img, mapping(zs.index_select(0, d), ys.index_select(0, d)))

    return fn


def stargan2_styles(num_domains: int, latent_dim: int, seed: int = 777):
    """The evaluation's styles: (y, z) for y = 1 … D−1, each z (1,
    latent_dim) standard normal from a ``torch.Generator`` seeded with
    ``seed`` (vst draws them from ``PRNGKey(777)``)."""
    g = torch.Generator().manual_seed(seed)
    return [(y, torch.randn(1, latent_dim, generator=g)) for y in range(1, num_domains)]


@torch.no_grad()
def evaluate_sintel_stargan2(generator, mapping, videos, raft_apply: Callable,
                             num_domains: int = 4, styles=None, seed: int = 777,
                             out_path=None, device="cuda", **kw):
    """StarGAN v2 on Sintel (vst's ``evaluate_sintel_stargan2``): ``styles``
    as :func:`stargan2_stylize_fn` takes them, or :func:`stargan2_styles`
    from ``seed``; frames ×2−1; the nets (vst evaluates the EMA ones) must
    lie on ``device``."""
    if styles is None:
        styles = stargan2_styles(num_domains, mapping.shared[0].in_features, seed)
    return evaluate_videos(
        videos, stargan2_stylize_fn(generator, mapping, styles, device), raft_apply,
        styles=list(range(len(styles))), out_path=out_path,
        frame_transform=lambda f: f * 2.0 - 1.0, num_domains=num_domains, device=device, **kw)


def stargan_stylize_fn(generator, c_dim: int):
    """stylize_fn for evaluate_videos, StarGAN v1: style y (a device id) is
    G(img, one_hot(y, c_dim))."""

    def fn(img, y):
        c = torch.nn.functional.one_hot(y.reshape(1).long(), c_dim).to(img.dtype)
        return generator(img, c)

    return fn


@torch.no_grad()
def evaluate_sintel_stargan(generator, videos, raft_apply: Callable, c_dim: int = 4,
                            out_path=None, device="cuda", **kw):
    """StarGAN v1 on Sintel (``solver.py:639-721``, vst's
    ``evaluate_sintel_stargan``): domains 1 … c_dim−1 as styles, frames
    ×2−1; ``generator`` must lie on ``device``."""
    return evaluate_videos(
        videos, stargan_stylize_fn(generator, c_dim), raft_apply,
        styles=list(range(1, c_dim)), out_path=out_path,
        frame_transform=lambda f: f * 2.0 - 1.0, num_domains=c_dim, device=device, **kw)


def cyclegan_stylize_fn(generators: Sequence[torch.nn.Module]):
    """vst's ``cyclegan_stylize_fn``: the family trains one model a style
    (``CycleGAN_train_sid{1,2,3}.sh``), so every model's G_A runs and the
    style index, clipped into range, picks one output
    (``fc2_eval.py:248-251``). The index is a device tensor: no host sync."""

    def fn(img, style_idx):
        outs = torch.stack([g(img) for g in generators])
        idx = torch.as_tensor(style_idx, device=outs.device).long().reshape(1)
        return outs.index_select(0, idx.clamp(0, len(generators) - 1))[0]

    return fn


def evaluate_sintel_cyclegan(generators: Sequence[torch.nn.Module], videos,
                             raft_apply: Callable, out_path=None, device="cuda", **kw):
    """The CycleGAN family on Sintel (vst's CLI, ``vst/cli/__main__.py:
    547-573``): style d is model d's G_A, frames ×2−1 into the nets and
    RAFT; the generators must lie on ``device``."""
    return evaluate_videos(
        videos, cyclegan_stylize_fn(generators), raft_apply,
        styles=list(range(len(generators))), out_path=out_path,
        frame_transform=lambda f: f * 2.0 - 1.0, device=device, **kw)


def fc2_tasks(num_domains: int):
    """vst's FC2 task grid: content to each style, each style to content."""
    return ([f"style02style{d}" for d in range(1, num_domains)]
            + [f"style{d}2style0" for d in range(1, num_domains)])


def _stack(pile):
    """A pile of (3, H, W) images, tensors on the device or host arrays."""
    return torch.stack(pile) if torch.is_tensor(pile[0]) else np.stack(pile)


def _fc2_summaries(tcl_vals, fakes, refs, tasks, inception, sep, out_dir):
    """TCL and FID per task, their means and the FID backbone, with ``sep``
    between metric and task (``/`` for OBST, ``_`` for Ruder, as in vst);
    written to ``<out_dir>/{TCL,FID}.json``."""
    tcl_dict, fid_dict = OrderedDict(), OrderedDict()
    for task in tasks:
        if not fakes[task]:
            continue
        tcl_dict[f"TCL{sep}{task}"] = float(np.mean(tcl_vals[task]))
        fid_dict[f"FID{sep}{task}"] = fid_from_activations(inception(_stack(refs[task])),
                                                           inception(_stack(fakes[task])))
    for d, name in ((tcl_dict, "TCL"), (fid_dict, "FID")):
        if d:
            d[f"{name}{sep}mean"] = float(np.mean(
                [v for k, v in d.items() if not k.endswith(f"{sep}mean")]))
            if name == "FID":  # the metric net's provenance
                d[f"FID{sep}backbone"] = getattr(inception, "backbone", "random-he")
        if out_dir:
            save_json(d, os.path.join(out_dir, f"{name}.json"), aggregate=False)
    return {"TCL": tcl_dict, "FID": fid_dict}


def evaluate_sintel_obst(obst, videos, raft_apply: Callable, style_images, pyr_shapes,
                         weight_tcl: float = 0.0, out_path=None, lt_len: int = 5,
                         literal_mask_zero: bool = False):
    """OBST's streaming Sintel evaluation (``obst_eval.py:413-566``) on
    ``obst.device``. Per frame: RAFT flow against the previous frame, the fb
    mask without the occlusion term, the warm start from the warped previous
    STYLIZED frame, L-BFGS, then TCL-ST against the warm start and TCL-LT
    through RAFT to frame t−5. Frame 0 runs from the content under a zero
    mask (``obst_eval.py:507``). RAFT is fed the caffe-space frames, as vst
    feeds it.

    ``literal_mask_zero``: the living reference zeroes ``mask_last`` just
    before ``net.run`` (``obst_eval.py:510``, a leftover debug line), which
    makes the temporal term inert and TCL-ST ≡ 0; the default keeps the live
    mask, as the reference's committed JSONs show (PARITY.md rows 45–46).
    The warm start always uses the live mask.

    DT is ``obst.run`` alone, timed between two ``synchronize()``s
    (``timing.call_ms``); RAFT is timed apart (RAFT-MS, not a reference
    file). Before the timed frames, one run per (pyramid, weight) warms up.
    Returns the TCL-ST / TCL-LT / DT (/ RAFT-MS) tables, written with
    ``_mean`` keys to ``<out_path>/<ID>.json``."""
    device = obst.device
    raft_ms_acc = []

    def compute_raft(i1, i2):
        def flow():
            padder = InputPadder(i1.shape)
            a, b = padder.pad(i1, i2)
            return padder.unpad(raft_apply(a, b)[1])

        up, ms = call_ms(flow, device)
        raft_ms_acc.append(ms)
        return up

    tcl_st, tcl_lt, dt, raft_ms = {}, {}, {}, {}
    n_styles = style_images.shape[0]
    warmed = set()  # (pyramid, weight) runs already made
    for video in videos:
        frames = torch.from_numpy(np.ascontiguousarray(video.frames)).permute(0, 3, 1, 2).to(
            device)
        for sid in range(n_styles):
            obst.set_style(style_images[sid], pyr_shapes)
            key = f"{video.name}_s{sid + 1}"
            wkey = (tuple(map(tuple, pyr_shapes)), float(weight_tcl))
            if wkey not in warmed:
                warmed.add(wkey)
                img0 = obst_prep(frames[0:1])
                call_ms(lambda: obst.run(img0, img0, torch.ones_like(img0[:, :1]), pyr_shapes,
                                         weight_tcl=weight_tcl), device)
            st_vals, lt_vals, dt_vals = [], [], []
            prev_styled = None
            styled_hist = []
            for i in range(len(video)):
                img = obst_prep(frames[i:i + 1])
                if i == 0:
                    pre = img
                    mask = torch.zeros_like(img[:, :1])
                else:
                    prev = obst_prep(frames[i - 1:i])
                    ff = compute_raft(prev, img)
                    bf = compute_raft(img, prev)
                    mask = fbc_mask(ff, bf, use_occlusion=False)
                    pre = obst.warm_start(prev_styled, img, bf, mask)
                run_mask = torch.zeros_like(mask) if literal_mask_zero else mask
                styled, ms = call_ms(lambda: obst.run(pre, img, run_mask, pyr_shapes,
                                                      weight_tcl=weight_tcl), device)
                dt_vals.append(ms)
                if i > 0:
                    st_vals.append(float(tcl_value(run_mask, styled, pre)))
                if i >= lt_len:
                    past = obst_prep(frames[i - lt_len:i - lt_len + 1])
                    ff5 = compute_raft(past, img)
                    bf5 = compute_raft(img, past)
                    m5 = fbc_mask(ff5, bf5, use_occlusion=False)
                    lt_vals.append(float(tcl_value(m5, styled, warp(styled_hist[i - lt_len],
                                                                     bf5))))
                prev_styled = styled
                styled_hist.append(styled)
            tcl_st[f"TCL-ST_{key}"] = float(np.mean(st_vals)) if st_vals else 0.0
            tcl_lt[f"TCL-LT_{key}"] = float(np.mean(lt_vals)) if lt_vals else 0.0
            dt[f"DT_{key}"] = float(np.mean(dt_vals))
            if raft_ms_acc:
                raft_ms[f"RAFT-MS_{key}"] = float(np.mean(raft_ms_acc))
                raft_ms_acc.clear()

    results = {"TCL-ST": tcl_st, "TCL-LT": tcl_lt, "DT": dt}
    if out_path:
        for out_id, data in results.items():
            save_json(data, os.path.join(out_path, out_id + ".json"), num_styles=n_styles)
        if raft_ms:  # not a reference file: the port's own record
            save_json(raft_ms, os.path.join(out_path, "RAFT-MS.json"), num_styles=n_styles)
    if raft_ms:
        results["RAFT-MS"] = raft_ms
    return results


def evaluate_fc2_obst(obst, eval_batches, style_images,
                      pyr_shapes=((64, 64), (128, 128), (256, 256)), weight_tcl: float = 0.0,
                      num_domains: int = 4, out_dir=None, inception=None):
    """OBST on FC2 (``obst_eval.py:570-724``): per eval sample with
    y_trg ≠ y_org and y_trg ≠ 0, stylize frame 1 from its content under a
    zero mask, warp it with the ground-truth flow, stylize frame 2 warm
    started from the warp under the mask and the temporal weight, and take
    the masked RMS against the warp. FID per task between the references and
    the frame-1 fakes; style 3's references are grayscale (``postp2``,
    :668). Batches follow ``vst_torch.data.fc2.BATCH_KEYS`` with images in
    [0, 1] RGB; the caffe preprocessing is done here. The style targets are
    set again only when the style changes. This protocol has no LPIPS."""
    device = obst.device
    inception = inception or InceptionV3(seed=0, device=device)
    tasks = fc2_tasks(num_domains)
    tcl_vals = {t: [] for t in tasks}
    fakes = {t: [] for t in tasks}
    refs = {t: [] for t in tasks}
    style_cache = {}
    for batch in eval_batches:
        b = batch_to_device(batch, device)
        y_org, y_trg = b["y_src"], b["y_ref"]
        for k in range(y_org.shape[0]):
            if y_org[k] == y_trg[k] or y_trg[k] == 0:
                continue
            task = f"style{y_org[k]}2style{y_trg[k]}"
            if task not in tcl_vals:  # only (0,d) / (d,0) / (d,d) pairs are on the grid
                continue
            sid = int(y_trg[k]) - 1
            if sid not in style_cache:
                obst.set_style(style_images[sid], pyr_shapes)
                style_cache = {sid: True}
            c1 = obst_prep(b["x_src"][k:k + 1])
            c2 = obst_prep(b["x2_src"][k:k + 1])
            m = b["mask"][k:k + 1]
            x_fake = obst.run(c1, c1, torch.zeros_like(m), pyr_shapes, weight_tcl=weight_tcl)
            x_warp = warp(x_fake, b["flow"][k:k + 1])
            x_fake2 = obst.run(x_warp, c2, m, pyr_shapes, weight_tcl=weight_tcl)
            tcl_vals[task].append(float(tcl_value(m, x_fake2, x_warp)))
            ref = b["x_ref"][k]
            if sid == 2:  # style 3's references in grayscale (postp2)
                ref = to_nchw(to_grayscale3(ref.transpose(1, 2, 0))[None])[0]
            fakes[task].append(obst_postp(x_fake)[0].cpu().numpy())
            refs[task].append(ref)
    return _fc2_summaries(tcl_vals, fakes, refs, tasks, inception, "/", out_dir)


@torch.no_grad()
def evaluate_fc2_ruder(model, state_dict, pre_model, pre_state_dict, eval_batches,
                       num_domains: int = 4, out_dir=None, inception=None, device="cuda"):
    """Ruder on FC2 (``fast_style_transfer.py:640-676``): per (y_org,
    y_trg ≠ y_org, y_trg ≠ 0) sample, ``x_fake = bootstrap(x)``,
    ``x_warp = warp(x_fake, flow)``, ``x_fake2 = net(cat(x2, mask, x_warp))``,
    TCL = RMS(mask·(x_fake2 − x_warp)) without clamps (the reference's are
    commented out, :661-664); FID per task between the references mapped to
    [0, 1] and the clipped frame-1 fakes. Batches in [−1, 1]. The
    per-sample results stay on the device until one fetch at the end.
    ``model`` / ``pre_model`` lie on ``device`` and get their ``state_dict``
    here."""
    set_f32_precision()
    device = torch.device(device)
    for net, sd in ((model, state_dict), (pre_model, pre_state_dict)):
        net.load_state_dict(sd)
        net.eval()
    inception = inception or InceptionV3(seed=0, device=device)
    tasks = fc2_tasks(num_domains)
    tcl_vals = {t: [] for t in tasks}
    fakes = {t: [] for t in tasks}
    refs = {t: [] for t in tasks}
    for batch in eval_batches:
        b = batch_to_device(batch, device)
        y_org, y_trg = b["y_src"], b["y_ref"]
        for k in range(y_org.shape[0]):
            if y_org[k] == y_trg[k] or y_trg[k] == 0:
                continue
            task = f"style{y_org[k]}2style{y_trg[k]}"
            if task not in tcl_vals:
                continue
            sid = torch.tensor(int(y_trg[k]) - 1, device=device)
            xf = pre_model(b["x_src"][k:k + 1], 1.0, sid)[1] / 255.0
            xw = warp(xf, b["flow"][k:k + 1])
            m = b["mask"][k:k + 1]
            xf2 = model(torch.cat([b["x2_src"][k:k + 1], m, xw], 1), 1.0, sid)[1] / 255.0
            tcl_vals[task].append(tcl_value(m, xf2, xw))
            fakes[task].append(xf[0].clamp(0.0, 1.0))
            refs[task].append(np.clip((b["x_ref"][k] + 1.0) / 2.0, 0.0, 1.0))
    tcl_vals = {t: torch.stack(v).cpu().numpy() if v else v for t, v in tcl_vals.items()}
    return _fc2_summaries(tcl_vals, fakes, refs, tasks, inception, "_", out_dir)
