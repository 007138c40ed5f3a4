"""Timing of device work: chains by CUDA events after a synchronize on the
card (the host clock ended by a sync elsewhere); a function's device time
alone, from a CUDA graph over inputs that are cold in L2; the host's time to
issue it."""

from __future__ import annotations

import math
import time
from typing import Callable, List, Sequence, Tuple

import torch

# more than twice the H100's 50 MB L2: a graph over a pool this large finds
# each call's input evicted since its last use
POOL_BYTES = 100_000_000
GRAPH_WINDOWS = 3
HOST_CALLS = 200


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


def call_ms(fn: Callable, device: torch.device) -> Tuple[object, float]:
    """(fn(), ms of that one call). On CUDA: a synchronize first, so the
    device has drained earlier work, then CUDA events around the call; on
    the CPU, where a call returns when its work is done, the host clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1000.0


def windows_ms(fn: Callable, x, iters: int, windows: int = 3) -> List[float]:
    """One warm-up call, then the ms per call of each of ``windows`` windows
    of ``iters`` chained calls (``chain_ms``)."""
    fn(x)
    return [chain_ms(fn, x, iters) for _ in range(windows)]


def _require_cuda(tensors: Sequence[torch.Tensor], what: str) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what} times device work and takes CUDA tensors only")


def cold_pool(x: torch.Tensor) -> List[torch.Tensor]:
    """x and copies of it: distinct tensors of ``POOL_BYTES`` or more
    together, for ``graph_ms``."""
    count = math.ceil(POOL_BYTES / (x.numel() * x.element_size()))
    return [x] + [x.clone() for _ in range(count - 1)]


def graph_ms(fn: Callable, inputs: Sequence[torch.Tensor], iters: int) -> float:
    """ms per call of ``fn`` on the device alone: ``fn`` applied once to
    each tensor of ``inputs`` (``POOL_BYTES`` or more together, so that each
    call finds its input cold in L2, as a bytes bound assumes; every output
    kept, so none is written over) captured in one CUDA graph, the graph
    replayed in ``GRAPH_WINDOWS`` windows of ``iters`` replays, each timed
    by CUDA events after a synchronize; the best window. Raises on CPU
    tensors, on a pool under ``POOL_BYTES`` and on a capture that fails."""
    _require_cuda(inputs, "graph_ms")
    if sum(t.numel() * t.element_size() for t in inputs) < POOL_BYTES:
        raise ValueError(f"graph_ms needs a pool of {POOL_BYTES} bytes or more (cold_pool)")
    device = inputs[0].device
    side = torch.cuda.Stream(device)  # one call before the capture: builds, first-launch set-up
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(inputs[0])
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = [fn(t) for t in inputs]
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(GRAPH_WINDOWS):
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (iters * len(inputs)))
    del outputs, graph
    return min(times)


def host_ms(fn: Callable, x: torch.Tensor, calls: int = HOST_CALLS) -> float:
    """The host's ms per call of issuing ``calls`` calls fn(x), by the wall
    clock read before the closing synchronize: what the caller's thread
    pays, not the device. After one warm-up call and a synchronize, so the
    launch queue starts empty. Raises on a CPU tensor."""
    _require_cuda([x], "host_ms")
    fn(x)
    torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(x)
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize(x.device)
    return ms
