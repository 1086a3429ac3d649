"""Engine round: the mean time of a round, in ms, not spent blocked at its
barrier: each of the traced window's ``quegel.round`` spans (the program's
``SlotRuntime.run_round``) less the ``quegel.sync`` span inside it (the
``done``/``step`` readback), so the host's admission, dispatch,
collection and retirement.  Host time under the profiler: compare traced
runs only with traced runs."""
import bisect


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    lo, hi = s.window
    rounds = sorted((a, b) for a, b, name, _ in s.host
                    if name == "quegel.round" and lo <= a and b <= hi)
    if not rounds:
        return None
    starts = [a for a, _ in rounds]
    sync = 0.0
    for a, b, name, _ in s.host:
        if name == "quegel.sync":
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and b <= rounds[i][1]:
                sync += b - a
    return (sum(b - a for a, b in rounds) - sync) / len(rounds) * 1e3
