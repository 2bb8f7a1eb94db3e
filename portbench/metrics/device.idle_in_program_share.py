"""Percent of the traced sub-window in which the device was idle while
the host was inside the program: the idle gaps intersected with the
union of the program's host spans, over the window.  At most
``device.idle_share``; the rest of that is idle while the client, not
the program, held the host.  None where the program emits no span."""

SPANS = ("step.apply", "executor.table", "executor.nodes", "stream.serve",
         "stream.setup", "stream.plan", "stream.build", "stream.submit",
         "stream.loop", "exec", "stream.outputs")


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    union = []
    for s, e in sorted((s, e) for name, s, e in tr.host if name in SPANS):
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], e)
        else:
            union.append([s, e])
    if not union:
        return None
    idle = sum(max(0.0, min(ge, ue) - max(gs, us))
               for gs, ge in tr.gaps() for us, ue in union)
    return 100.0 * idle / tr.window_s
