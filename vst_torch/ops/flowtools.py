"""Forward-backward consistency mask (NCHW), port of ``vst/ops/flowtools.py``.

``forward_interpolate`` (RAFT's warm start) is not on the TCL path and is
not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vst_torch.ops.sample import warp


def gradient(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded central difference (``utils/flowtools.py:12-16``).

    x: (B, H, W). Returns (2, B, H, W) = (dx, dy); neighbours outside the map
    count as 0, so border entries are ±x[neighbour]/2.
    """
    right = F.pad(x, (0, 1))[:, :, 1:]
    left = F.pad(x, (1, 0))[:, :, :-1]
    down = F.pad(x, (0, 0, 0, 1))[:, 1:, :]
    up = F.pad(x, (0, 0, 1, 0))[:, :-1, :]
    return torch.stack([(right - left) / 2.0, (down - up) / 2.0], 0)


def fbc_mask(ff: torch.Tensor, bf: torch.Tensor, use_occlusion: bool = True) -> torch.Tensor:
    """Forward-backward consistency and motion-boundary mask
    (``utils/flowtools.py:34-57``, ``fbcCheckTorch``).

    ff, bf: (B, 2, H, W) forward / backward flow. Returns (B, 1, H, W):
    1 = consistent, 0 = occluded or on a motion boundary.

    occ:  |warp(ff,bf) + bf|² > 0.01·(|wf|² + |bf|²) + 0.5
    mob:  |∇bf_u|² + |∇bf_v|² > 0.01·|bf|² + 0.002

    ``use_occlusion=False`` is the optimization-based variant, which drops
    the occ term.
    """
    norm_b = torch.sum(bf * bf, dim=1)
    gu = gradient(bf[:, 0])
    gv = gradient(bf[:, 1])
    mob = (torch.sum(gu * gu, 0) + torch.sum(gv * gv, 0)) > (0.01 * norm_b + 0.002)
    mask = torch.ones_like(norm_b)
    if use_occlusion:
        wf = warp(ff, bf)
        norm_wb = torch.sum((wf + bf) ** 2, dim=1)
        norm_w = torch.sum(wf * wf, dim=1)
        occ = norm_wb > (0.01 * (norm_w + norm_b) + 0.5)
        mask = mask.masked_fill(occ, 0.0)
    return mask.masked_fill(mob, 0.0)[:, None]
