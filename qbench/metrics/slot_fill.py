"""Runtime (``core/runtime.py`` SlotRuntime): live slots per round over the
capacity C, in %, averaged over the window's rounds (``SlotStats.
slot_occupancy``)."""
import numpy as np


def read(ctx):
    occ = ctx.stats["slot_occupancy"]
    return float(np.mean(occ)) / ctx.capacity * 100.0 if occ else None
