"""Optical-flow colouring, port of ``vst/flow/viz.py`` (the Baker colour
wheel of ``utils/raft/raft/flow_viz.py``).

Host-side numpy, a copy of vst's, so the uint8 images are vst's bit for
bit; :func:`flow_tensor_to_images` takes the port's NCHW flow tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# hue segment lengths of the Baker wheel as (length, from, to) RGB keypoint
# transitions: R→Y→G→C→B→M→R
_SEGMENTS = (
    (15, (255, 0, 0), (255, 255, 0)),    # RY
    (6, (255, 255, 0), (0, 255, 0)),     # YG
    (4, (0, 255, 0), (0, 255, 255)),     # GC
    (11, (0, 255, 255), (0, 0, 255)),    # CB
    (13, (0, 0, 255), (255, 0, 255)),    # BM
    (6, (255, 0, 255), (255, 0, 0)),     # MR
)


def make_colorwheel() -> np.ndarray:
    """The 55-entry Baker colour wheel, the hue keypoints lerped."""
    rows = []
    for length, c_from, c_to in _SEGMENTS:
        t = np.floor(255 * np.arange(length) / length) / 255.0
        c_from = np.asarray(c_from, np.float64)
        c_to = np.asarray(c_to, np.float64)
        step = np.sign(c_to - c_from)
        rows.append(c_from + step * t[:, None] * 255.0)
    return np.concatenate(rows, axis=0)


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray, convert_to_bgr: bool = False) -> np.ndarray:
    """Normalised flow components → (..., 3) uint8 colours."""
    wheel = make_colorwheel() / 255.0  # (ncols, 3)
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    angle = np.arctan2(-v, -u) / np.pi  # [−1, 1]
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    frac = (fk - k0)[..., None]

    col = (1 - frac) * wheel[k0] + frac * wheel[k1]  # (..., 3)
    inside = (rad <= 1)[..., None]
    col = np.where(inside, 1 - rad[..., None] * (1 - col), col * 0.75)
    out = np.floor(255 * col).astype(np.uint8)
    if convert_to_bgr:
        out = out[..., ::-1]
    return out


def flow_to_image(flow: np.ndarray, clip_flow: Optional[float] = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """flow (H, W, 2) → (H, W, 3) uint8, the colour wheel over the flow
    divided by its largest magnitude."""
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow_to_image takes (H, W, 2), got {flow.shape}")
    if clip_flow is not None:
        flow = np.clip(flow, 0, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    rad_max = max(rad.max(), 1e-5)
    return flow_uv_to_colors(u / rad_max, v / rad_max, convert_to_bgr)


def flow_tensor_to_images(flow: torch.Tensor, clip_flow: Optional[float] = None,
                          convert_to_bgr: bool = False) -> np.ndarray:
    """A (B, 2, H, W) flow tensor on any device → (B, H, W, 3) uint8, each
    image normalised by its own largest magnitude."""
    flows = flow.detach().float().permute(0, 2, 3, 1).cpu().numpy()
    return np.stack([flow_to_image(f, clip_flow, convert_to_bgr) for f in flows])
