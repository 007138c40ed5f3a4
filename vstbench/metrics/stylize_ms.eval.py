"""The stylize nets' device milliseconds per scored frame over the traced
window (the spans around every forward of the stylize nets, the timing
chain's calls included)."""


def read(ctx):
    ms = ctx.get("spans_ms", {}).get("stylize")
    return None if ms is None else ms / ctx["work"]
