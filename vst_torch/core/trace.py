"""Profiling and tracing of the port, port of ``vst/core/trace.py``.

* :func:`profile_trace`: a ``torch.profiler.profile`` context (CPU and, where
  there is a card, CUDA activity) that writes a Chrome trace, which
  TensorBoard and Perfetto read, into ``log_dir`` or the directory named by
  ``VST_PROFILE_DIR``; with neither it is a no-op, so call sites wrap their
  loops unconditionally.
* :func:`span`: a named range at a layer boundary. While no
  ``torch.profiler`` runs it is one check and records nothing. While one
  runs (``profile_trace``, or any profiler a caller starts), it enters
  ``record_function(name)``, so the range lands on the profiler's timeline
  beside the kernels it launched, and records its host start and end, its
  enclosing span and, once CUDA is initialised, a pair of timing events on
  the current stream.
* :func:`count`: a counter, under the same gate.
* :func:`snapshot` / :func:`reset`: the totals recorded since the last reset.

Every name starts with ``vst.``, so no span reads as a kernel by name. The
spans and counters of the port:

=====================================  =============================================================
``vst.eval.call``                      ``evaluate_videos``' body (root)
``vst.eval.upload``                    ``frames_to_device``: the host transform, the copy
``vst.eval.dt``                        the DT chain of one (video, style)
``vst.eval.ops``                       one pair's fb mask, warp and masked RMS
``vst.eval.frames_scored``             counter: frames with a TCL value
``vst.eval.stylize_calls``             counter: calls of the harness's ``stylize_fn``
``vst.eval.stylize_reuses``            counter: stylized frames a pass took from its store
``vst.eval.host_reads``                counter: values the harness reads to the host
``vst.eval.load``                      FastStyleNet's weights loaded for an evaluation
``vst.raft.call``                      ``RAFT.forward``
``vst.raft.encode``                    RAFT's feature and context encoders
``vst.raft.corr``                      the correlation pyramid
``vst.raft.update``                    the update loop with its lookups and the upsample
``vst.raft.gru``                       one SepConvGRU call (both passes) in the update loop
``vst.gru.launches``                   counter: launches of the SepConvGRU kernels
``vst.corr_lookup.launches``           counter: launches of the lookup kernel
``vst.corr_lookup.backward``           the lookup's backward (the backward kernel on CUDA)
``vst.corr_lookup.backwards``          counter: the lookup's backward passes
``vst.corr_lookup.backward_launches``  counter: launches of the backward kernel
``vst.stream.call``                    ``stylize_frames`` (root)
``vst.stream.upload``                  a chunk from numpy to the device in its dtype
``vst.stream.download``                a styled chunk back to numpy
``vst.stream.frames``                  counter: frames styled
``vst.stream.pageable_bytes``          counter: bytes of both pageable copies
``vst.train.iteration``                ``train_iteration`` of StarGAN2Trainer and RAFTTrainer (root)
``vst.train.d_loss``                   a D step's forward, R1's double backward included
``vst.train.g_loss``                   a G step's forward
``vst.train.loss``                     RAFT's training forward and its sequence loss
``vst.train.backward``                 ``loss.backward()`` of a step
``vst.train.optimizer``                zero_grad, the all-reduce or clip, AdamW, the schedule
``vst.train.ema``                      the EMA update
``vst.train.iterations``               counter: iterations
``vst.bench.<name>``                   one config of ``vst_torch.bench``
=====================================  =============================================================
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Optional

import torch

_ENV = "VST_PROFILE_DIR"
_profiling = torch.autograd._profiler_enabled


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


class _Totals:
    __slots__ = ("parent", "calls", "host_ns", "timed", "device_ms")

    def __init__(self, parent: Optional[str]):
        self.parent = parent  # the enclosing span of its first call
        self.calls = self.host_ns = self.timed = 0
        self.device_ms = 0.0


class Registry:
    """Spans and counters, folded into totals per name. A span's pair of
    CUDA events waits in a queue until the device has passed it; the queue
    is folded whenever it holds ``FOLD_AT`` pairs (those done so far) and
    waited on past ``MAX_PENDING``, so memory stays bounded."""

    FOLD_AT = 256
    MAX_PENDING = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._spans: Dict[str, _Totals] = {}
            self._child_ms: Dict[str, float] = collections.defaultdict(float)
            self._counters: Dict[str, int] = collections.defaultdict(int)
            self._pending = collections.deque()
            self._pool = []

    def stack(self) -> list:
        """The names of this thread's open spans, innermost last."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def event(self) -> Optional[torch.cuda.Event]:
        """A timing event recorded on the current stream, or None before
        CUDA is initialised (the work is on the host)."""
        if not torch.cuda.is_initialized():
            return None
        try:
            ev = self._pool.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add(self, name: str, n) -> None:
        with self._lock:
            self._counters[name] += n

    def finish(self, name: str, parent: Optional[str], host_ns: int, start, end) -> None:
        with self._lock:
            t = self._spans.get(name)
            if t is None:
                t = self._spans[name] = _Totals(parent)
            t.calls += 1
            t.host_ns += host_ns
            if start is not None:
                self._pending.append((name, parent, start, end))
                if len(self._pending) >= self.FOLD_AT:
                    self._fold(wait=len(self._pending) >= self.MAX_PENDING)

    def _fold(self, wait: bool) -> None:
        while self._pending:
            name, parent, start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            ms = start.elapsed_time(end)
            t = self._spans[name]
            t.timed += 1
            t.device_ms += ms
            if parent is not None:
                self._child_ms[parent] += ms
            self._pool += (start, end)

    def snapshot(self) -> Dict:
        """``{"spans": {name: {calls, host_ms, device_ms, self_device_ms,
        parent}}, "counters": {name: n}}``: inclusive milliseconds, self
        device milliseconds less the spans opened inside; device times are
        None for spans that ran before CUDA was initialised. Synchronises
        the device once."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        with self._lock:
            self._fold(wait=True)
            spans = {}
            for name, t in self._spans.items():
                dev = t.device_ms if t.timed else None
                spans[name] = {"calls": t.calls, "host_ms": t.host_ns / 1e6, "device_ms": dev,
                               "self_device_ms": None if dev is None
                               else dev - self._child_ms.get(name, 0.0),
                               "parent": t.parent}
            return {"spans": spans, "counters": dict(self._counters)}


REGISTRY = Registry()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "range", "start", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = REGISTRY.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = torch.autograd.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = REGISTRY.event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        end = REGISTRY.event() if self.start is not None else None
        self.range.__exit__(*exc)
        REGISTRY.stack().pop()
        REGISTRY.finish(self.name, self.parent, host_ns, self.start, end)
        return False


def span(name: str):
    """A context manager that records ``name`` while a profiler runs and
    does nothing otherwise."""
    return _Span(name) if _profiling() else _OFF


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` while a profiler runs."""
    if _profiling():
        REGISTRY.add(name, n)


def snapshot() -> Dict:
    """:meth:`Registry.snapshot` of the port's registry."""
    return REGISTRY.snapshot()


def reset() -> None:
    """Clear the port's spans and counters."""
    REGISTRY.reset()
