"""RAFT's two encoders (span ``vst.raft.encode``), device milliseconds per
scored frame (counter ``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.raft.encode"], "vst.eval.frames_scored")
