"""Host ms until the detect call returns (the served fn's checks, the
copy into the captured graph's input, the replay's launch, the outputs'
clones), averaged over the window's batches."""

import statistics


def read(ctx):
    ms = ctx.window.host_ms
    return statistics.fmean(ms) if ms else None
