"""The 95th percentile over every batch submitted in the window of the
time from its submission to its per-frame detections on the host."""

import numpy as np


def read(ctx):
    lat = ctx.window.latencies_ms
    return float(np.percentile(lat, 95)) if lat else None
