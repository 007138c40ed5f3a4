"""Chairs-like training pairs made on the device from a seed, for RAFT's
training cell.

FlyingChairs (Dosovitskiy et al. 2015) lays chairs over a background photo
and moves each, and the background, by an affine motion of its own. A pair
here is made the same way: a textured background under one affine motion
and 3 to 6 textured foreground shapes (superellipses of random size,
aspect, angle and squareness), each under its own affine motion, the later
shapes in front of the earlier ones in both images. Motion boundaries and
occlusions come with it. The flow is the exact forward flow of every pixel
of image 1: the motion of the front-most object there, as FlyingChairs'
ground truth.

Motions are ``p -> c + t + s R(a) (p - c)`` in pixels, c the object's centre
(the frame's for the background): translations of ``move_px`` times u², u
uniform in [0, 1], and a share ``tail_share`` of them uniform between
``move_px`` and ``tail_px`` (a few pixels to about 40, a tail to about 100,
Chairs' spread); the background's at ``bg_move_px`` likewise. Images are RGB
in [0, 255]; ``valid`` is 1 where the flow is shorter than 400 px. Every
draw comes from one ``torch.Generator`` on the device.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from vstbench import data

MARGIN = 128  # pixels of background texture beyond the frame on each side
FG_TEXTURE = 64  # the side of a foreground shape's texture


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _shift(gen, shape, move_px, tail_px, tail_share):
    """(shape, 2) translations: length move_px·u² or, for a ``tail_share`` of
    them, uniform in [move_px, tail_px]; direction uniform."""
    length = move_px * torch.rand(shape, generator=gen, device=gen.device) ** 2
    tail = torch.rand(shape, generator=gen, device=gen.device) < tail_share
    length = torch.where(tail, _uniform(gen, shape, move_px, tail_px), length)
    angle = _uniform(gen, shape, 0.0, 2 * math.pi)
    return torch.stack([length * torch.cos(angle), length * torch.sin(angle)], -1)


def _motion(gen, shape, centre, move, turn_deg, zoom):
    """(shape, 2, 3) affine maps of pixels: a turn about ``centre`` of up to
    ``turn_deg``, a zoom within 1 ± ``zoom`` and a translation ``move``."""
    a = torch.deg2rad(_uniform(gen, shape, -turn_deg, turn_deg))
    s = _uniform(gen, shape, 1 - zoom, 1 + zoom)
    lin = torch.stack([torch.stack([s * torch.cos(a), -s * torch.sin(a)], -1),
                       torch.stack([s * torch.sin(a), s * torch.cos(a)], -1)], -2)
    off = centre + move - (lin @ centre.unsqueeze(-1)).squeeze(-1)
    return torch.cat([lin, off.unsqueeze(-1)], -1)


def _apply(m, p):
    """Affine maps m (..., 2, 3) applied to points p (..., N, 2)."""
    return p @ m[..., :2].transpose(-1, -2) + m[..., None, :, 2]


def _invert(m):
    """The inverses of affine maps (..., 2, 3)."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    lin = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    lin = lin / det[..., None, None]
    return torch.cat([lin, -(lin @ m[..., 2:])], -1)


def _sample(tex, pts_norm, hw):
    """tex (B, 3, h, w) at normalised points (B, N, 2), as (B, 3, H, W)."""
    grid = pts_norm.reshape(tex.shape[0], *hw, 2)
    return F.grid_sample(tex, grid, mode="bilinear", padding_mode="reflection",
                         align_corners=True)


def batch(gen: torch.Generator, n: int, hw: Sequence[int], p: Dict) -> Dict[str, torch.Tensor]:
    """One batch of ``n`` pairs at ``hw``: ``image1``, ``image2`` (n, 3, H, W)
    in [0, 255], ``flow`` (n, 2, H, W), ``valid`` (n, H, W); ``p`` the
    mix's generator parameters."""
    H, W = hw
    dev = gen.device
    K = p["shapes"][1]
    bg = data.texture(gen, n, (H + 2 * MARGIN) // 2, (W + 2 * MARGIN) // 2)
    fg = data.texture(gen, n * K, FG_TEXTURE, FG_TEXTURE).reshape(n, K, 3, FG_TEXTURE,
                                                                 FG_TEXTURE)
    shown = (torch.arange(K, device=dev)[None]
             < torch.randint(p["shapes"][0], K + 1, (n, 1), generator=gen, device=dev))
    frame_c = torch.tensor([(W - 1) / 2, (H - 1) / 2], device=dev).expand(n, 2)
    bg_motion = _motion(gen, (n,), frame_c,
                        _shift(gen, (n,), p["bg_move_px"], p["tail_px"], p["tail_share"]),
                        p["bg_turn_deg"], p["bg_zoom"])
    centre = torch.stack([_uniform(gen, (n, K), 0, W - 1), _uniform(gen, (n, K), 0, H - 1)], -1)
    radii = _uniform(gen, (n, K, 2), *p["shape_px"])
    angle = _uniform(gen, (n, K), 0, math.pi)
    power = _uniform(gen, (n, K), *p["squareness"])
    moves = _motion(gen, (n, K), centre,
                    _shift(gen, (n, K), p["move_px"], p["tail_px"], p["tail_share"]),
                    p["turn_deg"], p["zoom"])
    # a shape's placement in image 1: its local square [-1, 1]^2 to pixels
    cos, sin = torch.cos(angle), torch.sin(angle)
    place = torch.stack([torch.stack([radii[..., 0] * cos, -radii[..., 1] * sin, centre[..., 0]],
                                     -1),
                         torch.stack([radii[..., 0] * sin, radii[..., 1] * cos, centre[..., 1]],
                                     -1)], -2)
    to_local = _invert(place)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(1, H * W, 2).expand(n, -1, -1)
    box = torch.tensor([W - 1 + 2 * MARGIN, H - 1 + 2 * MARGIN], device=dev)

    def render(bg_pts, shape_pts):
        """Image and front-most object index (-1: background) at the points
        whose background and per-shape source points are given."""
        image = _sample(bg, 2 * (bg_pts + MARGIN) / box - 1, hw)
        front = torch.full((n, H * W), -1, device=dev, dtype=torch.long)
        for k in range(K):
            local = _apply(to_local[:, k], shape_pts(k))
            inside = ((local.abs() ** power[:, k, None, None]).sum(-1) <= 1) & shown[:, k, None]
            image = torch.where(inside.reshape(n, 1, H, W),
                                _sample(fg[:, k], local.clamp(-1, 1), hw), image)
            front = torch.where(inside, k, front)
        return image * 255.0, front

    image1, front = render(pix, lambda k: pix)
    inv_moves = _invert(moves)
    image2, _ = render(_apply(_invert(bg_motion), pix), lambda k: _apply(inv_moves[:, k], pix))
    flow = _apply(bg_motion, pix) - pix
    for k in range(K):
        flow = torch.where((front == k)[..., None], _apply(moves[:, k], pix) - pix, flow)
    flow = flow.reshape(n, H, W, 2).permute(0, 3, 1, 2).contiguous()
    valid = (flow.square().sum(1).sqrt() < 400).float()
    return {"image1": image1.contiguous(), "image2": image2.contiguous(), "flow": flow,
            "valid": valid}
