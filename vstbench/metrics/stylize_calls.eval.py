"""Calls of the stylize function the harness makes (counter
``vst.eval.stylize_calls``: warm-up, DT chain, TCL pairs) per scored frame
(counter ``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import count_per_unit


def read(ctx):
    return count_per_unit(ctx, "vst.eval.stylize_calls", "vst.eval.frames_scored")
