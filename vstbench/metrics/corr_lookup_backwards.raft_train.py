"""The correlation lookup's backward passes (counter
``vst.corr_lookup.backwards``) per iteration (counter
``vst.train.iterations``) of the profiled iterations: one a RAFT iteration."""

from vstbench.program_trace import count_per_unit


def read(ctx):
    return count_per_unit(ctx, "vst.corr_lookup.backwards", "vst.train.iterations")
