"""Queries answered inside the window, per second of the window."""


def read(ctx):
    return len(ctx.answered) / ctx.seconds
