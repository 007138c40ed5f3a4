"""Live stylization demo, port of ``vst/cli/demo.py`` (the reference's PyQt5
GUI, ``methods/learning-based/fs_gui.py:21-312``): a source (webcam, video
file or the synthetic clip), style switching, runtime style strength and
resolution, an FPS readout.

Headless, it writes the stylized clip to ``<out_path>.mp4`` (or vst's GIF
beside it, ``vst_torch.eval.video._writer``); with ``--show`` it also shows
each frame in an OpenCV window with vst's keys:
  0-9 style id · +/- style strength · [/] resolution scale · q quit
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from vst_torch.cli.__main__ import CKPT_NAME, load_state, synthetic_clip
from vst_torch.eval.video import _writer
from vst_torch.train.registry import method_net


class DemoStylizer:
    """The demo's net, as vst builds it: the ``method``'s FastStyleNet
    (``ruder`` runs Huang's, ``demo.py:45``) with ``n_styles`` styles, seeded
    by ``seed`` or loaded from ``ckpt_dir`` (a ``state_dict`` file, or a
    ``train-faststyle --out-dir`` holding ``model.pt``; a directory without
    one keeps the seeded net, as vst's does without a checkpoint step), in
    eval mode on ``device``. A call maps NCHW frames in [0, 1] to
    clamp(net(x, strength, sid) / 255, 0, 1)."""

    def __init__(self, method: str = "huang", n_styles: int = 3, ckpt_dir: Optional[str] = None,
                 seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        torch.manual_seed(seed)
        net = method_net("huang" if method == "ruder" else method, n_styles)
        path = os.path.join(ckpt_dir, CKPT_NAME) if ckpt_dir and os.path.isdir(ckpt_dir) \
            else ckpt_dir
        if path and os.path.exists(path):
            net.load_state_dict(load_state(path))
        elif path:
            print(f"no checkpoint at {path}; the net seeded by {seed}", flush=True)
        self.net = net.to(self.device).eval()
        self._sids = {}  # style id → a device tensor, so a call copies no index to the card

    def __call__(self, x: torch.Tensor, strength: float, sid: int) -> torch.Tensor:
        if sid not in self._sids:
            self._sids[sid] = torch.tensor(sid, device=self.device)
        _, out = self.net(x, strength, self._sids[sid])
        return (out / 255.0).clamp(0.0, 1.0)


def _frames(source: Optional[str], n_frames: int, hw, seed: int):
    """(frames (H, W, 3) float32 in [0, 1] one by one, the capture or None):
    a webcam or video file through cv2, each frame resized to ``hw``, or,
    without one (or one that does not open), vst's synthetic clip."""
    import cv2

    cap = None
    if source is not None:
        cap = cv2.VideoCapture(0 if source == "webcam" else source)
        if not cap.isOpened():
            print(f"could not open source {source!r}; using synthetic clip")
            cap = None
    if cap is None:
        return iter(synthetic_clip(hw, n_frames, seed)[0]), None

    def read():
        for _ in range(n_frames):
            ok, bgr = cap.read()
            if not ok:
                break
            rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            yield cv2.resize(rgb, (hw[1], hw[0])).astype(np.float32) / 255.0

    return read(), cap


def run_demo(source: Optional[str] = None, ckpt_dir: Optional[str] = None,
             method: str = "huang", n_styles: int = 3, n_frames: int = 60, hw=(128, 192),
             out_path: str = "demo_out", show: bool = False, seed: int = 0, device="cuda"):
    """Stylize ``n_frames`` frames of ``source`` (see :func:`_frames`) one by
    one at int(hw · scale) // 4 · 4 (each frame through ``cv2.resize``, as
    vst's), writing each to the video and, with ``show``, to a window whose
    keys change the style, strength and scale. Prints vst's line, then one
    JSON line (frames, hw, the FPS readout, the file written) and returns it."""
    import cv2

    stylize = DemoStylizer(method, n_styles, ckpt_dir, seed, device)
    frames, cap = _frames(source, n_frames, hw, seed)
    out_file, writer = _writer(out_path + ".mp4", fps=18)
    sid, strength, scale = 0, 1.0, 1.0
    t_last, fps, done, size = time.perf_counter(), 0.0, 0, list(hw)
    with writer, torch.inference_mode():
        for frame in frames:
            h = int(hw[0] * scale) // 4 * 4
            w = int(hw[1] * scale) // 4 * 4
            f = cv2.resize(frame, (w, h)).astype(np.float32)
            x = torch.from_numpy(f).to(stylize.device).permute(2, 0, 1)[None]
            out = stylize(x, strength, sid)[0].permute(1, 2, 0).cpu().numpy()
            now = time.perf_counter()
            fps = 0.9 * fps + 0.1 / max(now - t_last, 1e-6)
            t_last = now
            vis = (np.clip(out, 0, 1) * 255).astype(np.uint8)
            writer.append_data(vis)
            done, size = done + 1, [h, w]
            if show:
                cv2.putText(vis, f"s{sid} x{strength:.1f} {fps:.0f}fps", (4, 14),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255))
                cv2.imshow("vst demo", cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
                key = cv2.waitKey(1) & 0xFF
                if key == ord("q"):
                    break
                if ord("0") <= key <= ord("9"):
                    sid = min(int(chr(key)), n_styles - 1)
                if key == ord("+"):
                    strength = min(strength + 0.1, 3.0)
                if key == ord("-"):
                    strength = max(strength - 0.1, 0.0)
                if key == ord("]"):
                    scale = min(scale * 1.25, 4.0)
                if key == ord("["):
                    scale = max(scale / 1.25, 0.25)
    if cap is not None:
        cap.release()
    if show:
        cv2.destroyAllWindows()
    print(f"demo wrote {out_file} ({fps:.1f} fps)")
    line = {"frames": done, "hw": size, "fps": fps, "video": out_file,
            "device": str(stylize.device)}
    print(json.dumps(line), flush=True)
    return line
