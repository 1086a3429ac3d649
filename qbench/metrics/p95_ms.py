"""95th percentile latency, in ms, over every query answered in the window
(all of them, not a median of chunks, so one stall moves it)."""
import numpy as np


def read(ctx):
    lat = ctx.latencies()
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
