"""Seconds from the process's start to the first timed submission: CUDA
context, input generation, the port's graph views and tables, the engine
and the warm-up queries."""


def read(ctx):
    return ctx.setup_s
