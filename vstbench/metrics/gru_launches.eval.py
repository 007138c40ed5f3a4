"""Launches of the SepConvGRU kernels (counter ``vst.gru.launches``: gru_zr
and gru_q, each pass of each iteration) per scored frame (counter
``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import count_per_unit


def read(ctx):
    return count_per_unit(ctx, "vst.gru.launches", "vst.eval.frames_scored")
