"""Window milliseconds per scored frame outside the stylize and RAFT spans:
the evaluation harness and ``vst_torch.ops`` (clip copy, masks, warps, RMS,
host reads) and the time the device waits for them."""


def read(ctx):
    spans = ctx.get("spans_ms", {})
    if "raft" not in spans or "stylize" not in spans:
        return None
    return (ctx["window_s"] * 1e3 - spans["raft"] - spans["stylize"]) / ctx["work"]
