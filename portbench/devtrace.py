"""The card's activity in a traced sub-window, read from ``torch.profiler``.

``record`` runs a function under the profiler inside a named host range
and keeps every device operation (kernels, copies, fills) and every host
event that falls inside it, on the profiler's one clock, in seconds.
``Trace`` answers what the per-layer readers ask: device time by name,
the union of busy intervals, the idle gaps and what the host did in them.
"""
import dataclasses

WINDOW = "portbench.window"


@dataclasses.dataclass
class Trace:
    ops: list            # (name, start_s, end_s) of each device operation
    host: list           # (name, start_s, end_s) of each host event
    start: float
    end: float
    frames: int          # frames completed in the window
    passes: int          # passes of one launch batch through the network

    @property
    def window_s(self):
        return self.end - self.start

    def device_s(self, parts=None, exclude=()):
        """Device seconds of the operations whose name holds one of
        ``parts`` (all when None) and none of ``exclude``."""
        return sum(e - s for name, s, e in self.ops
                   if (parts is None or any(p in name for p in parts))
                   and not any(x in name for x in exclude))

    def busy(self):
        """The union of the device operations' intervals, merged."""
        merged = []
        for _, s, e in sorted(self.ops, key=lambda op: op[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self):
        return sum(e - s for s, e in self.busy())

    def gaps(self):
        """Idle intervals of the device inside the window."""
        out, t = [], self.start
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end > t:
            out.append((t, self.end))
        return out

    def _host_at(self, t):
        """The innermost host event running at ``t``."""
        best = None
        for name, s, e in self.host:
            if s <= t < e and (best is None or s > best[1]):
                best = (name, s)
        return best[0] if best else "host idle"

    def breakdown(self, n=10):
        by_name = {}
        for name, s, e in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self._host_at(s), e - s] for s, e in gaps]}


def record(torch, fn, *, frames, passes):
    """Run ``fn`` (which ends in a synchronize) under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
    events = prof.events()
    window = next(e for e in events if e.name == WINDOW)
    start, end = window.time_range.start / 1e6, window.time_range.end / 1e6
    ops, host = [], []
    for e in events:
        s = max(e.time_range.start / 1e6, start)
        t = min(e.time_range.end / 1e6, end)
        if t <= s or e is window:
            continue
        # the window's own range, drawn on the device's timeline too
        annotation = e.name == WINDOW or getattr(e, "is_user_annotation", False)
        if e.device_type == DeviceType.CUDA and not annotation:
            ops.append((e.name, s, t))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, s, t))
    return Trace(ops=ops, host=host, start=start, end=end, frames=frames,
                 passes=passes)
