"""Percent: the model FLOPs (work.py) of the frames completed in the
traced sub-window, over its length, against the 495 TFLOP/s peak."""
from portbench import work


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    flops = work.frame_flops(ctx.layers) * ctx.trace.frames
    return 100.0 * flops / ctx.trace.window_s / work.PEAK_FLOPS
