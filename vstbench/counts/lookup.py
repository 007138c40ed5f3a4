"""The least time of one correlation-window lookup, copied from the port's
``chip_smoke.py:lookup_bound``: the bytes the windows at these coordinates
need (each in-bounds map element of every query's (2r+2)^2 patch read once,
the coordinates read once, the output written once) over the memory rate,
against the float32 operations over the float32 rate."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from vstbench.counts.peaks import bound_s

# f32 operations per lookup output: level scale and offset (2 per axis), floor
# fractions and complements (4), 4 corner weights, 4 products, 3 sums
OPS_PER_OUTPUT = 17


def lookup_bytes_ops(level_hw: Sequence[Tuple[int, int]], coords: torch.Tensor,
                     r: int) -> Tuple[int, int]:
    """(bytes, operations) of one lookup: pyramid levels of (h, w) per query,
    coords (B, 2, H, W) in level-0 pixels."""
    B, _, H, W = coords.shape
    q = B * H * W
    c = coords.permute(0, 2, 3, 1).reshape(q, 2).double()
    read = 0
    for i, (h, w) in enumerate(level_hw):
        lo = torch.floor(c / 2 ** i) - r
        hi = lo + 2 * r + 1
        nx = (hi[:, 0].clamp(max=w - 1.0) - lo[:, 0].clamp(min=0.0) + 1).clamp_min(0)
        ny = (hi[:, 1].clamp(max=h - 1.0) - lo[:, 1].clamp(min=0.0) + 1).clamp_min(0)
        read += int((nx * ny).sum().item()) * 4
    outputs = q * len(level_hw) * (2 * r + 1) ** 2
    return read + q * 2 * 4 + outputs * 4, outputs * OPS_PER_OUTPUT


def lookup_bound_s(level_hw, coords, r) -> float:
    return bound_s(*lookup_bytes_ops(level_hw, coords, r))
