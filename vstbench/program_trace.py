"""The program's own spans and counters (``vst_torch.core.trace``), as the
per-layer metrics that read them see them.

The program records them only while a profiler runs. In a ``--trace 1``
run that is the loop's profiled sub-window alone (``vstbench.trace.profile``:
one evaluation call, the stream's profiled frames, the profiled training
iterations), so a reader reads nothing without the ``profile`` the loop put
in ``ctx``. The program's snapshot is taken once a result line and kept in
``ctx["program_trace"]``; a test may put a snapshot of its own there. A
program without spans and counters gives None, and so does a snapshot that
lacks a span or counter a metric reads.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

KEY = "program_trace"


def snapshot(ctx: Dict) -> Optional[Dict]:
    """``{"spans": {name: {calls, host_ms, device_ms, ...}}, "counters":
    {name: n}}`` of the profiled sub-window, or None."""
    if KEY not in ctx:
        if not ctx.get("profile"):
            return None
        try:
            from vst_torch.core.trace import snapshot as program_snapshot
        except ImportError:  # a program that records no spans
            ctx[KEY] = None
        else:
            ctx[KEY] = program_snapshot()
    return ctx[KEY]


def span_per_unit(ctx: Dict, spans: Sequence[str], unit: str,
                  clock: str = "device_ms") -> Optional[float]:
    """The milliseconds of ``spans`` on ``clock`` (``device_ms`` or
    ``host_ms``), summed, over counter ``unit``."""
    snap = snapshot(ctx)
    if not snap:
        return None
    n = snap["counters"].get(unit)
    ms = [snap["spans"].get(name, {}).get(clock) for name in spans]
    if not n or None in ms:
        return None
    return sum(ms) / n


def count_per_unit(ctx: Dict, counter: str, unit: str, scale: float = 1.0) -> Optional[float]:
    """Counter ``counter`` × ``scale`` over counter ``unit``."""
    snap = snapshot(ctx)
    if not snap:
        return None
    c, n = snap["counters"].get(counter), snap["counters"].get(unit)
    return None if c is None or not n else c * scale / n
