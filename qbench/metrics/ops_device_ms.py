"""Apps and backend (``apps/*.py``, ``kernels/ops.py``): device time per
superstep, in ms, of every operation launched outside the ``qbench.
propagate`` and ``qbench.count`` spans, from the traced window."""


def read(ctx):
    s = ctx.summary
    steps = len(ctx.stats["round_times"]) * ctx.steps_per_round
    if s is None or not steps:
        return None
    lo, hi = s.window
    t = sum(b - a for a, b, _, region in s.device if region == "other" and lo <= a < hi)
    return t / steps * 1e3
