"""The fb masks, warps and masked RMS of the harness (span ``vst.eval.ops``,
one a frame pair), device milliseconds per scored frame (counter
``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.eval.ops"], "vst.eval.frames_scored")
