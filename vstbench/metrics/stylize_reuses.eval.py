"""Stylized frames the harness's TCL pairs took from the (video, style)
pass's store instead of calling the stylize function again (counter
``vst.eval.stylize_reuses``) per scored frame (counter
``vst.eval.frames_scored``) of the profiled call."""

from vstbench.program_trace import count_per_unit


def read(ctx):
    return count_per_unit(ctx, "vst.eval.stylize_reuses", "vst.eval.frames_scored")
