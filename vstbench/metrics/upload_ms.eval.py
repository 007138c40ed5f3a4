"""The harness's frame uploads (span ``vst.eval.upload``: the host transform
and the pageable copy), host milliseconds per scored frame (counter
``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.eval.upload"], "vst.eval.frames_scored", clock="host_ms")
