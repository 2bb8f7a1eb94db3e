"""Host us a frame of the stream engine's event loop alone: its
execute=False twin's run over one request's frames."""


def read(ctx):
    if ctx.loop_s is None:
        return None
    return ctx.loop_s * 1e6 / ctx.frames_per_request
