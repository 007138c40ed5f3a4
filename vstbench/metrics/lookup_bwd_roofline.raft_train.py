"""The correlation lookup's backward, its share of its roofline over the
profiled iterations, in %: the least time of the backward of every lookup
they made (``vstbench.counts.lookup_bwd``: the op's bytes at its boundary
over the memory rate) over the device milliseconds of the span
``vst.corr_lookup.backward``. The same work is counted whatever computes the
backward, so a backward kernel is read on the yardstick of the plain
autograd it replaces."""

from vstbench.program_trace import snapshot


def read(ctx):
    snap = snapshot(ctx)
    if not snap or not ctx.get("lookups"):
        return None
    span = snap["spans"].get("vst.corr_lookup.backward") or {}
    ms = span.get("device_ms")
    if not ms or span.get("calls") != ctx["lookups"]:
        return None
    return 100.0 * ctx["lookup_bwd_bound_s"] * 1e3 / ms
