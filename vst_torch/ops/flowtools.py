"""Forward-backward consistency mask (NCHW) and RAFT's warm-start
``forward_interpolate`` (on the host, through SciPy), port of
``vst/ops/flowtools.py``.
"""

from __future__ import annotations

import numpy as np
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


def forward_interpolate(flow: torch.Tensor) -> torch.Tensor:
    """Forward-splat a flow field and re-interpolate it onto the regular
    grid (``utils/raft/raft/utils/utils.py:26-54``), RAFT's warm start: each
    pixel moves by its own vector, and the scattered (dx, dy) samples are
    interpolated back onto the grid by nearest neighbour (SciPy
    ``griddata``, on the host, as vst and the reference do: a scatter that
    depends on the data). Points outside the open interval (0, W)×(0, H) are
    dropped, the reference's test.

    flow: (2, H, W), the reference's layout, on any device. Returns (2, H, W)
    float32 on the same device."""
    from scipy import interpolate

    f = flow.detach().cpu().numpy().astype(np.float32)
    dx, dy = f[0], f[1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dxf, dyf = x1[valid], y1[valid], dxf[valid], dyf[valid]
    flow_x = interpolate.griddata((x1, y1), dxf, (x0, y0), method="nearest", fill_value=0)
    flow_y = interpolate.griddata((x1, y1), dyf, (x0, y0), method="nearest", fill_value=0)
    out = np.stack([flow_x, flow_y], axis=0).astype(np.float32)
    return torch.from_numpy(out).to(flow.device)
