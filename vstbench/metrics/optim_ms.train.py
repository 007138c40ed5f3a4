"""zero_grad, the gradient all-reduce and AdamW's steps (span
``vst.train.optimizer``) and the EMA update (span ``vst.train.ema``), device
milliseconds per iteration (counter ``vst.train.iterations``) of the profiled
iterations."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.train.optimizer", "vst.train.ema"], "vst.train.iterations")
