"""Bilinear sampling and warping (NCHW), port of ``vst/ops/sample.py``.

The reference's grid_sample conventions that this slice uses:

1. ``utils/flowtools.py:18-32`` (``warp``): the grid is normalised by
   ``W-1`` but sampled with ``align_corners=False``, so the effective sample
   point is ``(x+u)·W/(W-1) − 0.5``. Kept as a quirk (PARITY.md).
2. ``utils/raft/raft/utils/utils.py:57-71`` (``bilinear_sampler``):
   normalised by ``W-1`` with ``align_corners=True`` — exact pixel
   coordinates, which is :func:`bilinear_sample_pixel`.

All sample bilinearly with zero padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_sample_pixel(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                          padding_mode: str = "zeros") -> torch.Tensor:
    """Sample img (B, C, H, W) at float pixel coordinates x, y (B, Ho, Wo).

    'zeros': each of the four neighbours outside the image contributes 0;
    'border': the coordinate is clipped into the image first.
    """
    B, C, H, W = img.shape
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx1 = x - x0f
    wy1 = y - y0f
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    x0 = x0f.long()
    y0 = y0f.long()
    flat = img.reshape(B, C, H * W)

    def corner(yi, xi, w):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        w = w * valid.to(w.dtype)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, 1, -1)
        v = torch.gather(flat, 2, idx.expand(B, C, idx.shape[-1]))
        return v.reshape(B, C, *x.shape[1:]) * w[:, None]

    return (corner(y0, x0, wy0 * wx0) + corner(y0, x0 + 1, wy0 * wx1)
            + corner(y0 + 1, x0, wy1 * wx0) + corner(y0 + 1, x0 + 1, wy1 * wx1))


def grid_sample(img: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """F.grid_sample, bilinear. img (B, C, H, W); grid (B, Ho, Wo, 2) with
    normalised (x, y) in [-1, 1]."""
    return F.grid_sample(img, grid, mode="bilinear", padding_mode=padding_mode,
                         align_corners=align_corners)


def _base_grid(B: int, H: int, W: int, like: torch.Tensor) -> torch.Tensor:
    """Pixel grid (B, 2, H, W), channel 0 = x, 1 = y."""
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=like.dtype, device=like.device),
        torch.arange(W, dtype=like.dtype, device=like.device), indexing="ij")
    return torch.stack([xs, ys], 0)[None].expand(B, 2, H, W)


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp, ``utils/flowtools.py:18-32`` with its quirk: the grid
    is normalised by ``max(W-1, 1)`` / ``max(H-1, 1)`` and sampled with
    ``align_corners=False``. x (B, C, H, W); flow (B, 2, H, W) pixels (u, v)."""
    B, C, H, W = x.shape
    vgrid = _base_grid(B, H, W, x) + flow.to(x.dtype)
    gx = 2.0 * vgrid[:, 0] / max(W - 1, 1) - 1.0
    gy = 2.0 * vgrid[:, 1] / max(H - 1, 1) - 1.0
    return grid_sample(x, torch.stack([gx, gy], -1), align_corners=False)
