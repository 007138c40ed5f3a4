"""The least time of one correlation-window lookup's backward: the bytes at
the op's boundary over the memory rate. It reads the gradient of the windows
(one float a query, level and window tap) and the coordinates (two floats a
query), and writes the gradient of every pyramid level densely (one float a
query and level pixel, the volume of about 430 MB at RAFT's chairs stage).
The count is the op's, not an implementation's: whatever computes the
backward is held to it."""

from __future__ import annotations

from typing import Sequence, Tuple

from vstbench.counts.peaks import PEAK_BYTES_PER_S

FLOAT = 4


def lookup_bwd_bytes(level_hw: Sequence[Tuple[int, int]], queries: int, r: int) -> int:
    """Bytes of one backward: pyramid levels of (h, w) per query, ``queries``
    = B·H·W, window radius ``r``."""
    window = len(level_hw) * (2 * r + 1) ** 2
    dense = sum(h * w for h, w in level_hw)
    return FLOAT * queries * (window + 2 + dense)


def lookup_bwd_bound_s(level_hw, queries: int, r: int) -> float:
    return lookup_bwd_bytes(level_hw, queries, r) / PEAK_BYTES_PER_S
