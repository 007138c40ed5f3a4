"""The correlation lookup's backward passes (span
``vst.corr_lookup.backward``, read by name: on autograd's device thread it
has no parent), device milliseconds per iteration (counter
``vst.train.iterations``) of the profiled iterations."""

from vstbench.program_trace import span_per_unit


def read(ctx):
    return span_per_unit(ctx, ["vst.corr_lookup.backward"], "vst.train.iterations")
