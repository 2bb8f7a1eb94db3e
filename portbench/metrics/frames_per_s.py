"""Frames whose outputs were synchronized inside the window, over the
window, on the host clock: the window ends with its last request."""


def read(ctx):
    return len(ctx.records) * ctx.frames_per_request / ctx.window_s
