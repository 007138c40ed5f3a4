"""The stylize net's device milliseconds per frame over the traced window
(the spans around every forward of the net)."""


def read(ctx):
    ms = ctx.get("spans_ms", {}).get("stylize")
    return None if ms is None else ms / ctx["work"]
