"""RAFT's SepConvGRU calls in the update loop (span ``vst.raft.gru``, both
passes of each iteration), device milliseconds per scored frame (counter
``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.raft.gru"], "vst.eval.frames_scored")
