"""Median latency, in ms, over every query answered in the window: from
when the client issued it (closed loop) or it was due (open loop) to when
the host held its answer."""
import numpy as np


def read(ctx):
    lat = ctx.latencies()
    return float(np.percentile(lat, 50)) * 1e3 if len(lat) else None
