"""Timing of chained device work: CUDA events after a synchronize on the
card, the host clock ended by a sync elsewhere."""

from __future__ import annotations

import time
from typing import Callable, List

import torch


def chain_ms(fn: Callable, x, iters: int) -> float:
    """Mean ms per call of ``iters`` chained calls x = fn(x), on x's device."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            x = fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        x = fn(x)
    float(x.sum())
    return (time.perf_counter() - t0) / iters * 1000.0


def windows_ms(fn: Callable, x, iters: int, windows: int = 3) -> List[float]:
    """One warm-up call, then the ms per call of each of ``windows`` windows
    of ``iters`` chained calls (``chain_ms``)."""
    fn(x)
    return [chain_ms(fn, x, iters) for _ in range(windows)]
