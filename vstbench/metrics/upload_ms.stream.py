"""The stream's uploads (span ``vst.stream.upload``: numpy to the card in the
net's dtype), host milliseconds per frame (counter ``vst.stream.frames``) of
the profiled frames. The card has drained by then: each frame's download
waited for it."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.stream.upload"], "vst.stream.frames", clock="host_ms")
