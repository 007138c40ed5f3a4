"""The FastStyleNet Sintel driver, port of ``vst/eval/drivers.py:29-73``.

The harness normalises frames with mean/std 0.5
(``fast_style_transfer.py:407-410``): the net sees [−1, 1] frames, and so
does RAFT, which applies its own 2·(x/255)−1 on top (``raft.py:89-90``).
Outputs are clamp(out/255, 0, 1); the style-3 grayscale is a save-time
effect only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from vst_torch.eval.sintel import evaluate_videos


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
