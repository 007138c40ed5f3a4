"""RAFT's training forward and the sequence loss (span ``vst.train.loss``),
device milliseconds per iteration (counter ``vst.train.iterations``) of the
profiled iterations."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.train.loss"], "vst.train.iterations")
