"""The two D steps' device milliseconds per iteration over the traced
window (spans around the trainer's ``d_step``)."""


def read(ctx):
    ms = ctx.get("spans_ms", {}).get("d_steps")
    return None if ms is None else ms / ctx["units"]
