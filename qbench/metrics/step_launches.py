"""Apps and backend dispatch: the device work a superstep launches, as the
host's launch calls (kernels, copies, sets) made inside each of the traced
window's ``quegel.step`` spans (the program's ``QuegelEngine._superstep``,
the gate and kernel spans nested in it included), those inside
``qbench.count`` left out, per span.  A trace with no launch call (the
CPU's) gives nothing."""
import bisect

from qbench import trace

LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    lo, hi = s.window
    steps = sorted((a, b) for a, b, name, _ in s.host
                   if name == "quegel.step" and lo <= a and b <= hi)
    if not steps:
        return None
    starts = [a for a, _ in steps]
    cnt = trace._intervals(s.count_spans)
    n = 0
    for a, _, name, _ in s.host:
        if name.startswith(LAUNCHES) and not trace._inside(*cnt, a):
            i = bisect.bisect_right(starts, a) - 1
            n += i >= 0 and a <= steps[i][1]
    return n / len(steps) if n else None
