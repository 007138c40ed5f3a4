"""The feed-forward family's Sintel drivers, port of
``vst/eval/drivers.py:29-73`` (Johnson, Dumoulin, Huang, ReCoNet through the
generic harness) and ``:378-506`` (Ruder's streaming protocol).

The harness normalises frames with mean/std 0.5
(``fast_style_transfer.py:407-410``): the net sees [−1, 1] frames, and so
does RAFT, which applies its own 2·(x/255)−1 on top (``raft.py:89-90``).
Outputs are clamp(out/255, 0, 1); the style-3 grayscale is a save-time
effect only.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vst_torch import set_f32_precision
from vst_torch.core.timing import call_ms
from vst_torch.eval.sintel import (aggregate_results, evaluate_videos, flows_to_device,
                                   frames_to_device, tcl_value)
from vst_torch.ops.flowtools import fbc_mask
from vst_torch.ops.image import InputPadder
from vst_torch.ops.sample import warp


def faststyle_stylize_fn(model, state_dict):
    """stylize_fn for evaluate_videos, style = style id. Loads
    ``state_dict`` into ``model`` (a ``FastStyleNet``), which stands in for
    vst's (trainer, params); output clamp(model/255, 0, 1)
    (``fast_style_transfer.py:514-515``)."""
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
