"""The four steps' ``loss.backward()`` (span ``vst.train.backward``), device
milliseconds per iteration (counter ``vst.train.iterations``) of the profiled
iterations."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.train.backward"], "vst.train.iterations")
