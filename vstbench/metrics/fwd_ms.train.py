"""The four steps' forward passes, R1's double backward included (spans
``vst.train.d_loss`` and ``vst.train.g_loss``), device milliseconds per
iteration (counter ``vst.train.iterations``) of the profiled iterations."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.train.d_loss", "vst.train.g_loss"], "vst.train.iterations")
