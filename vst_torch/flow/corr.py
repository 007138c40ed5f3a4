"""All-pairs correlation pyramid and windowed bilinear lookup, port of
``vst/flow/corr.py`` (``utils/raft/raft/corr.py:12-60``, CorrBlock).

The (B·H·W, 1, H, W) correlation volume is one float32 matmul per frame
pair, average-pooled into a pyramid; every GRU iteration samples a
(2r+1)² window per query at exact pixel coordinates with zero padding.
:func:`lookup_pyramid` is the plain PyTorch version of the Hopper kernel in
``vst_torch/kernels/corr_lookup.py``; RAFT calls the kernel's wrapper.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from vst_torch.ops.image import avg_pool2d


def build_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                  num_levels: int = 4) -> Tuple[torch.Tensor, ...]:
    """fmap1/2: (B, C, H, W) at 1/8 resolution. Returns num_levels tensors
    of shape (B·H·W, 1, H/2^i, W/2^i), query-major: row q = b·H·W + y·W + x
    holds query q's correlation with every pixel of fmap2.

    Float32 throughout; the caller keeps TF32 off (``set_f32_precision``),
    as the reference runs this volume at HIGHEST precision.
    """
    B, C, H, W = fmap1.shape
    f1 = fmap1.float().reshape(B, C, H * W).transpose(1, 2)
    f2 = fmap2.float().reshape(B, C, H * W)
    corr = torch.matmul(f1, f2) / math.sqrt(C)
    corr = corr.reshape(B * H * W, 1, H, W)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        if corr.shape[2] < 2 or corr.shape[3] < 2:
            # tiny inputs (tests): pooling a 1-pixel map would leave an empty
            # level, so the coarsest map repeats; H, W ≥ 64 never get here
            pyramid.append(corr)
            continue
        corr = avg_pool2d(corr, 2, 2)
        pyramid.append(corr)
    return tuple(pyramid)


def lookup_pyramid(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """coords: (B, 2, H, W) level-0 pixel coordinates (x, y) into fmap2.
    Returns (B, L·(2r+1)², H, W): an NCHW view of a channel-last
    (B, H, W, L·(2r+1)²) tensor, channels in the reference's order.

    Transposed window (reference ``corr.py:37-43``): the X offset varies
    along the FIRST window axis, so channel k = a·(2r+1) + b samples
    (x + a − r, y + b − r). Pretrained motion-encoder weights depend on it.
    Each query owns its map, so every corner is one flat gather over the
    level (index q·h·w + y·w + x).
    """
    r = radius
    n = 2 * r + 1
    B, _, H, W = coords.shape
    Q = B * H * W
    d = torch.linspace(-r, r, n, dtype=coords.dtype, device=coords.device)
    da, db = torch.meshgrid(d, d, indexing="ij")
    centroid = coords.permute(0, 2, 3, 1).reshape(Q, 1, 1, 2)
    qidx = torch.arange(Q, device=coords.device).reshape(Q, 1, 1)
    out = []
    for i, corr in enumerate(pyramid):
        h, w = corr.shape[-2:]
        c = centroid / (2 ** i)
        x = c[..., 0] + da
        y = c[..., 1] + db
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx1 = x - x0
        wy1 = y - y0
        x0i = x0.long()
        y0i = y0.long()
        flat = corr.reshape(Q * h * w)
        qbase = qidx * (h * w)

        def corner(yi, xi, wgt):
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = qbase + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            return flat[idx] * wgt * valid

        s = (corner(y0i, x0i, (1 - wy1) * (1 - wx1))
             + corner(y0i, x0i + 1, (1 - wy1) * wx1)
             + corner(y0i + 1, x0i, wy1 * (1 - wx1))
             + corner(y0i + 1, x0i + 1, wy1 * wx1))
        out.append(s.reshape(Q, n * n))
    return torch.cat(out, 1).reshape(B, H, W, -1).permute(0, 3, 1, 2)
