"""zero_grad, the gradient's clip, AdamW and the schedule's step (span
``vst.train.optimizer``), device milliseconds per iteration (counter
``vst.train.iterations``) of the profiled iterations."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.train.optimizer"], "vst.train.iterations")
