"""Inputs made from the seed, on the device, in a few large calls.

A scene is a texture of smoothed noise at several scales (3 channels in
[0, 1]); a clip views it through a camera whose affine motion (translation,
rotation, zoom) changes smoothly from frame to frame; a training pair is two
such views with the exact backward flow between them and the mask of the
pixels whose source lies inside the first view. Every draw comes from one
``torch.Generator`` on the device, so a seed gives the same inputs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

OCTAVES = (4, 16, 64)


def texture(gen: torch.Generator, n: int, h: int, w: int) -> torch.Tensor:
    """(n, 3, h, w) smoothed noise in [0, 1] on the generator's device."""
    dev = gen.device
    out = torch.zeros(n, 3, h, w, device=dev)
    for i, cells in enumerate(OCTAVES):
        coarse = torch.randn(n, 3, max(2, h // cells), max(2, w // cells), generator=gen,
                             device=dev)
        out += F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False) / 2 ** i
    return torch.sigmoid(1.5 * out)


def _affine(gen: torch.Generator, n_views: int, n: int, step: float):
    """Per view: (n, 2, 3) affine maps of output pixels into the texture's
    normalised coordinates: smooth motion, at most ``step`` of the frame a view."""
    dev = gen.device
    p = torch.rand(n_views, 6, generator=gen, device=dev) * 2 - 1
    t = torch.arange(n, device=dev, dtype=torch.float32)[None]
    angle = 0.02 * p[:, 0:1] * t
    zoom = 0.8 * (1 + 0.01 * p[:, 1:2] * t)
    tx = 0.5 * step * p[:, 2:3] * t + 0.05 * p[:, 4:5] * torch.sin(t / 3)
    ty = 0.5 * step * p[:, 3:4] * t + 0.05 * p[:, 5:6] * torch.cos(t / 3)
    cos, sin = torch.cos(angle) * zoom, torch.sin(angle) * zoom
    theta = torch.stack([torch.stack([cos, -sin, tx], -1), torch.stack([sin, cos, ty], -1)], -2)
    return theta  # (n_views, n, 2, 3)


def _view(tex: torch.Tensor, theta: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    grid = F.affine_grid(theta, [theta.shape[0], 3, *hw], align_corners=False)
    return F.grid_sample(tex.expand(theta.shape[0], -1, -1, -1), grid, mode="bilinear",
                         padding_mode="reflection", align_corners=False)


def clips(gen: torch.Generator, n_clips: int, n_frames: int, hw: Sequence[int]) -> List[np.ndarray]:
    """``n_clips`` clips, each (n_frames, H, W, 3) float32 in [0, 1] in host memory."""
    H, W = hw
    tex = texture(gen, n_clips, 2 * H, 2 * W)
    theta = _affine(gen, n_clips, n_frames, step=0.01)
    return [_view(tex[c:c + 1], theta[c], hw).permute(0, 2, 3, 1).contiguous().cpu().numpy()
            for c in range(n_clips)]


def _pixel_to_norm(hw, like):
    H, W = hw
    ys, xs = torch.meshgrid(torch.arange(H, device=like.device, dtype=torch.float32),
                            torch.arange(W, device=like.device, dtype=torch.float32),
                            indexing="ij")
    return (2 * xs + 1) / W - 1, (2 * ys + 1) / H - 1


def advcon_batches(gen: torch.Generator, n_batches: int, batch: int, img: int,
                   num_domains: int, latent_dim: int) -> List[Dict[str, torch.Tensor]]:
    """A pool of AdvCon batches on the device: x_real and x_real2 (two views of
    one scene a frame apart), x_ref (a view of another scene), in [-1, 1];
    ``flow`` the exact backward flow x_real2 -> x_real in pixels; ``mask`` 1
    where that flow lands inside x_real; y_org, y_trg domain ids; z latents."""
    hw = (img, img)
    n = n_batches * batch
    tex = texture(gen, 2 * n, 2 * img, 2 * img)
    theta = _affine(gen, n, 2, step=0.02)  # (n, 2, 2, 3): frames 0 and 1 of each pair
    x1 = _view(tex[:n], theta[:, 0], hw)
    x2 = _view(tex[:n], theta[:, 1], hw)
    xr = _view(tex[n:], theta[:, 0], hw)
    # a pixel p of x2 shows texture point A2 p; x1 shows it at A1^-1 (A2 p)
    gx, gy = _pixel_to_norm(hw, x1)
    pts = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(1, -1, 3)
    tex_pts = pts @ theta[:, 1].transpose(1, 2)  # (n, HW, 2)
    a1 = theta[:, 0, :, :2]
    src = torch.linalg.solve(a1, (tex_pts - theta[:, 0, None, :, 2]).transpose(1, 2))
    sx = ((src[:, 0] + 1) * img - 1) / 2
    sy = ((src[:, 1] + 1) * img - 1) / 2
    px = ((gx + 1) * img - 1) / 2
    py = ((gy + 1) * img - 1) / 2
    flow = torch.stack([sx.reshape(n, img, img) - px, sy.reshape(n, img, img) - py], 1)
    inside = ((sx >= 0) & (sx <= img - 1) & (sy >= 0) & (sy <= img - 1)).reshape(n, 1, img, img)
    y = torch.randint(0, num_domains, (2, n), generator=gen, device=gen.device)
    z = torch.randn(n, latent_dim, generator=gen, device=gen.device)
    parts = {"x_real": x1 * 2 - 1, "x_real2": x2 * 2 - 1, "x_ref": xr * 2 - 1, "flow": flow,
             "mask": inside.float(), "y_org": y[0], "y_trg": y[1], "z": z}
    return [{k: v[i * batch:(i + 1) * batch].contiguous() for k, v in parts.items()}
            for i in range(n_batches)]

