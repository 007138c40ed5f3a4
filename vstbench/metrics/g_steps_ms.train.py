"""The two G steps' device milliseconds per iteration over the traced
window (spans around the trainer's ``g_step``)."""


def read(ctx):
    ms = ctx.get("spans_ms", {}).get("g_steps")
    return None if ms is None else ms / ctx["units"]
