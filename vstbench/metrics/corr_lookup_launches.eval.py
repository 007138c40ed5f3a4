"""Launches of the ``corr_lookup`` kernel (counter ``vst.corr_lookup.launches``)
per scored frame (counter ``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import count_per_unit


def read(ctx):
    return count_per_unit(ctx, "vst.corr_lookup.launches", "vst.eval.frames_scored")
