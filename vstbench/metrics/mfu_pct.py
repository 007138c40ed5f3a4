"""The whole step's share of the chip's float32 peak over the traced window,
in %: the operations the reference needs a unit of work
(``vstbench.counts.flops``) times the units, over the window's seconds on
the host's clock and 67 TFLOP/s (TF32 is off). Shared by every mix
(``mfu_pct.<mix>``)."""

from vstbench.counts.peaks import PEAK_F32_OPS_PER_S


def read(ctx):
    if not ctx.get("unit_flops") or not ctx.get("units"):
        return None
    return 100.0 * ctx["unit_flops"] * ctx["units"] / ctx["window_s"] / PEAK_F32_OPS_PER_S
