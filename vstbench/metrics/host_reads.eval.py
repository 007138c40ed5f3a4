"""Values the harness reads to the host (counter ``vst.eval.host_reads``)
per scored frame (counter ``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import count_per_unit


def read(ctx):
    return count_per_unit(ctx, "vst.eval.host_reads", "vst.eval.frames_scored")
