"""``corr_lookup``'s share of its roofline over the profiled iterations, in
%: the least time of every forward lookup they made
(``vstbench.counts.lookup``, from the coordinates each received) over the
profiler's time in kernels whose name holds ``corr_lookup``."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not ctx.get("lookups"):
        return None
    ms = sum(v for k, v in prof["device_ms_by_name"].items() if "corr_lookup" in k)
    return None if ms <= 0 else 100.0 * ctx["lookup_bound_s"] * 1e3 / ms
