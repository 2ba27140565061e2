"""The share of a short profiled window in which no operation ran on the
device: 1 - the union of the trace's device intervals over the window."""


def read(ctx):
    t = ctx.trace
    if not t or "busy_s" not in t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
