"""Milliseconds per frame of the ``stylize_frames`` loop outside the net:
the mean frame wall (host frame in, styled host frame out) minus the net's
span."""


def read(ctx):
    ms = ctx.get("spans_ms", {}).get("stylize")
    walls = ctx.get("frame_walls")
    if ms is None or not walls:
        return None
    return (sum(walls) * 1e3 - ms) / len(walls)
