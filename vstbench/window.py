"""The arithmetic of the measured window, with no device in it.

* A closed loop runs units of work while window time remains; the unit in
  flight when the time is up completes and counts (:func:`run`).
* A rate is the work of every unit over the time from the window's start to
  the end of the last unit, stalls included (:func:`rate`).
* A tail is the nearest-rank percentile over every sample (:func:`percentile`).
* The device's busy time is the union of its intervals; the idle gaps are
  what lies between them inside the window (:func:`union`, :func:`gaps`).
* A uniform sample of the units, drawn from the seed as they come
  (:class:`Reservoir`), decides before each unit whether to keep its output.
"""

from __future__ import annotations

import math
import random
import time
from typing import Callable, List, Sequence, Tuple


def run(seconds: float, unit: Callable[[int], None],
        clock: Callable[[], float] = time.perf_counter,
        finish: Callable[[], None] = lambda: None) -> Tuple[int, float, float]:
    """Call ``unit(i)`` for i = 0, 1, ... while ``seconds`` have not passed since
    the first call started; the call in flight when they pass completes, and
    ``finish()`` (a synchronize, where units return before the device is
    done) ends the window. Returns (units, start, end) in ``clock``'s seconds."""
    t0 = clock()
    n = 0
    while n == 0 or clock() - t0 < seconds:
        unit(n)
        n += 1
    finish()
    return n, t0, clock()


def rate(work: float, start: float, end: float) -> float:
    """Work per second over the whole window."""
    if end <= start:
        raise ValueError("a window must have a positive length")
    return work / (end - start)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of every value."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100.0 * len(ordered))) - 1]


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The merged, sorted union of closed intervals (start, end)."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def covered(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def gaps(intervals: Sequence[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, in order."""
    out, t = [], lo
    for s, e in union(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class Reservoir:
    """Keeps a uniform sample of ``k`` of the units seen, drawn from ``seed``:
    :meth:`offer` says, before unit i runs, whether to keep it and which kept
    slot it replaces."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0

    def offer(self) -> int:
        """The slot (0 .. k-1) the next unit takes, or -1 to drop it."""
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else -1
