"""Runtime admission (``QuegelEngine._admit``: the queries' host-to-device
copy, ``init`` and the slot writes): the mean of the traced window's
``quegel.admit`` spans, in ms; the fused round opens one only when it
admits a query.  Host time under the profiler: compare traced runs only
with traced runs."""


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    lo, hi = s.window
    t = [b - a for a, b, name, _ in s.host if name == "quegel.admit" and lo <= a and b <= hi]
    return sum(t) / len(t) * 1e3 if t else None
