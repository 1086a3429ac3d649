"""Engine round: 95th percentile of a query's time from admission to its
answer, in ms, over the queries retired in the window (``SlotStats.
service_times``)."""
import numpy as np


def read(ctx):
    s = ctx.stats["service_times"]
    return float(np.percentile(s, 95)) * 1e3 if s else None
