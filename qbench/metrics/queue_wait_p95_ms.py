"""Runtime: 95th percentile of the time a query waited for a slot, in ms,
over the queries retired in the window (``SlotStats.queue_waits``)."""
import numpy as np


def read(ctx):
    w = ctx.stats["queue_waits"]
    return float(np.percentile(w, 95)) * 1e3 if w else None
