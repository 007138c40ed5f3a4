"""RAFT's device milliseconds per scored frame over the traced window (the
spans around every forward of the RAFT module)."""


def read(ctx):
    ms = ctx.get("spans_ms", {}).get("raft")
    return None if ms is None else ms / ctx["work"]
