"""95th percentile latency, in ms, over every query answered in the window,
as ``p95_ms`` reads it, reported per layer in the cells whose runs spread
too widely for ``p95_ms``'s bound (a host-bound round)."""
import numpy as np


def read(ctx):
    lat = ctx.latencies()
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
