"""The stream's downloads (span ``vst.stream.download``: the styled frame
back to numpy), device milliseconds per frame (counter ``vst.stream.frames``)
of the profiled frames."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.stream.download"], "vst.stream.frames")
