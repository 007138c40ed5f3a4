"""Launches of the correlation lookup's backward kernel (counter
``vst.corr_lookup.backward_launches``) per iteration (counter
``vst.train.iterations``) of the profiled iterations: one a lookup's
backward pass. A program whose backward launches no kernel of its own
records no such counter, and the reader gives None."""

from vstbench.program_trace import count_per_unit


def read(ctx):
    return count_per_unit(ctx, "vst.corr_lookup.backward_launches", "vst.train.iterations")
