"""Device: the share of the traced window, in %, in which no kernel, copy
or set runs, with the intervals of ``qbench.count`` taken out of the window
and its operations out of the busy time."""
from qbench import trace


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    kept = trace.measure(trace.kept_window(s))
    if kept <= 0:
        return None
    return (1.0 - trace.measure(trace.busy(s)) / kept) * 100.0
