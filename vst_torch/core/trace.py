"""Profiling hooks, port of ``vst/core/trace.py``.

* :func:`profile_trace`: a ``torch.profiler.profile`` context (CPU and, where
  there is a card, CUDA activity) that writes a Chrome trace, which
  TensorBoard and Perfetto read, into ``log_dir`` or the directory named by
  ``VST_PROFILE_DIR``; with neither it is a no-op, so call sites wrap their
  loops unconditionally.
* :func:`annotate`: ``torch.profiler.record_function``, a named range on the
  trace's timeline. Call sites put it around a phase, never inside a timed
  loop.
* :class:`ChainTimer`: per-step wall clock that waits for the step's output:
  ``sink`` synchronizes the output's CUDA device, and fetches a scalar from
  an output on the CPU, as vst's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

_ENV = "VST_PROFILE_DIR"


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Profile the block into ``log_dir`` (``VST_PROFILE_DIR`` when None);
    a no-op when neither names a directory."""
    log_dir = log_dir or os.environ.get(_ENV)
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """A named range on the profiler's timeline."""
    return torch.profiler.record_function(name)


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else out if isinstance(out, (list, tuple)) else ()
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


class ChainTimer:
    """Per-step wall-clock times that end when the step's output exists::

        timer = ChainTimer()
        for frame in frames:
            with timer:
                out = stylize(frame)
                timer.sink(out)
        timer.mean_ms
    """

    def __init__(self):
        self.times_ms = []
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sink(self, out) -> None:
        """Wait for ``out`` (a tensor or a list, tuple or dict holding one)."""
        leaf = _first_tensor(out)
        if leaf is None:
            return
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        else:
            float(leaf.reshape(-1)[0])

    def __exit__(self, *exc):
        self.times_ms.append((time.perf_counter() - self._t0) * 1000.0)
        return False

    @property
    def mean_ms(self) -> float:
        return sum(self.times_ms) / max(len(self.times_ms), 1)
