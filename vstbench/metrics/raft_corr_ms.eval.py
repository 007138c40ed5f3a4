"""RAFT's correlation pyramid (span ``vst.raft.corr``), device milliseconds
per scored frame (counter ``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.raft.corr"], "vst.eval.frames_scored")
