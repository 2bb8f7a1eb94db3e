"""Seconds from the process's first line to the window: imports, the
card's context, the kernel library (built on a checkout's first run),
weights and frames, the plan and the warm-up."""


def read(ctx):
    return ctx.setup_s
