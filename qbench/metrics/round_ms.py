"""Engine round (``QuegelEngine.slot_round`` with the runtime's admission
and retirement around it): the window's ``SlotStats.round_times`` summed
over its rounds, in ms."""


def read(ctx):
    r = ctx.stats["round_times"]
    return sum(r) / len(r) * 1e3 if r else None
