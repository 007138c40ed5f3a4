"""What a traced run reads from the program without editing it.

* :class:`Spans`: CUDA events recorded, never synchronised, around calls into
  a layer, by forward hooks on a module or by wrapping an instance's method.
  After the window, :meth:`Spans.ms` synchronises once and sums each span's
  device-timeline milliseconds.
* :func:`profile`: ``torch.profiler`` over a short sub-window, reduced to a
  summary: the device's busy seconds (the union of its kernel, copy and set
  intervals) inside the sub-window, the sub-window's length, milliseconds by
  kernel name, the operations that took most time and the longest idle gaps,
  each labelled with the host operation active in it. No trace file is kept.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Tuple

import torch

from vstbench import window

SUBWINDOW = "vstbench.subwindow"
TOP = 10


class Spans:
    def __init__(self):
        self.events: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self.on = False
        self._open: Dict[str, list] = collections.defaultdict(list)
        self._handles = []

    def _start(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._open[name].append(ev)

    def _end(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, self._open[name].pop(), ev))

    def hook(self, module: torch.nn.Module, name: str) -> None:
        """Span ``name`` around every forward call of ``module`` while on."""
        self._handles.append(module.register_forward_pre_hook(
            lambda *_: self._start(name) if self.on else None))
        self._handles.append(module.register_forward_hook(
            lambda *_: self._end(name) if self.on and self._open[name] else None))

    def wrap(self, obj, attr: str, name: str) -> None:
        """Span ``name`` around every call of ``obj.attr`` while on (an
        instance attribute that shadows the method)."""
        fn = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            self._start(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self._end(name)

        setattr(obj, attr, wrapped)

    def ms(self) -> Dict[str, float]:
        """Milliseconds of device timeline under each span name."""
        totals: Dict[str, float] = collections.defaultdict(float)
        if self.events:
            self.events[-1][2].synchronize()
        for name, start, end in self.events:
            totals[name] += start.elapsed_time(end)
        return dict(totals)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(e, host_names) -> str:
    """The activity type of a kineto event (the events carry none), from its
    device and name: a device event named as a host event is the device's
    copy of an annotation."""
    name = e.name()
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return "user_annotation" if name == SUBWINDOW else "cpu_op"
    if name in host_names:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _kineto_events(prof):
    """(name, activity kind, start_us, end_us) of every event the profiler kept."""
    raw = prof.profiler.kineto_results.events()
    host = {e.name() for e in raw if e.device_type() != torch.autograd.DeviceType.CUDA}
    return [(e.name(), _kind(e, host), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3) for e in raw]


def summarise(events) -> Dict:
    """The summary of :func:`profile` from (name, kind, start_us, end_us)
    events, ``kind`` the profiler's activity type: the device's are
    ``DEVICE_KINDS``, the host's the rest but the device's annotations. The
    sub-window is the span of the ``SUBWINDOW`` annotation on the host."""
    marks = [(s, e) for n, kind, s, e in events if kind == "user_annotation" and n == SUBWINDOW]
    if not marks:
        raise RuntimeError("the profiled sub-window left no annotation")
    lo, hi = marks[0]
    device = [(n, max(s, lo), min(e, hi)) for n, kind, s, e in events
              if kind in DEVICE_KINDS and e > lo and s < hi]
    host = [(n, s, e) for n, kind, s, e in events
            if kind not in DEVICE_KINDS and kind != "gpu_user_annotation" and n != SUBWINDOW]
    spans = [(s, e) for _, s, e in device]
    busy = window.covered(spans, lo, hi)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in device:
        by_name[n] += e - s
    idle = []
    for s, e in sorted(window.gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:TOP]:
        mid = (s + e) / 2
        inside = [(he - hs, n) for n, hs, he in host if hs <= mid <= he]
        idle.append((min(inside)[1] if inside else "host outside any operation", (e - s) / 1e6))
    ops = sorted(by_name.items(), key=lambda t: -t[1])
    return {
        "busy_s": busy / 1e6,
        "window_s": (hi - lo) / 1e6,
        "device_ms_by_name": {n: us / 1e3 for n, us in by_name.items()},
        "device_ops": [[n[:160], us / 1e6] for n, us in ops[:TOP]],
        "idle_gaps": [[n[:160], sec] for n, sec in idle],
    }


def profile(fn: Callable[[], None]) -> Dict:
    """Run ``fn`` (which ends in a synchronize) under the profiler; its summary."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SUBWINDOW):
            fn()
    return summarise(_kineto_events(prof))

