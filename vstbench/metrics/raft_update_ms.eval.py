"""RAFT's update loop with its lookups and the upsample (span
``vst.raft.update``), device milliseconds per scored frame (counter
``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.raft.update"], "vst.eval.frames_scored")
