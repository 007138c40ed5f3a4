"""The device's idle share of the profiled sub-window, in %: 100 x (1 - the
union of its kernel, copy and set intervals over the sub-window's wall).
Shared by every mix (``device_idle_pct.<mix>``)."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
