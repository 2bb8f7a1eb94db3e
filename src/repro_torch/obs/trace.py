"""Span tracing on the exact rational clock (and the host clock): the
port's own copy of the JAX package's ``obs/trace.py``.

The serving stack's whole claim is *continuous flow* — Eq. 9/10 promise
every unit stays busy at the matched data rate — but until now the repo
could only check it **after** a run, via end-of-run aggregates
(``ServeSummary.occupancy_ok``, ``WallClockReport.busy``).  A mid-run
stall, a queue spike that drains before the end, or a mis-placed device
transfer was invisible.  ``Tracer`` is the recording half of the fix:
an append-only event log that the serving engine
(``serving/cnn_stream.py``), the fleet scheduler (``fleet/scheduler``)
and the device pipeline (``distributed/device_pipeline``) emit into,
and that ``obs.audit`` replays against the analytic bounds.

Two clock domains share one trace:

* ``clock="ticks"`` — the deterministic tick model's exact rational
  clock (``fractions.Fraction`` ticks; one tick = one frame interval at
  the plan's input rate).  Every serving/fleet event lives here, so the
  trace is bit-reproducible and the drift auditor can do exact
  arithmetic against Eq. 9/10.
* ``clock="host"`` — ``time.perf_counter`` seconds, for the wall-clock
  spans around real dispatch (the stream engine's ``exec`` spans; in
  the port these time the asynchronous CUDA dispatch of a stage, not
  its execution on the card).  Tick-model and measured timelines land
  in one file, directly comparable.

``host_span`` is the one emission point for the port's host spans
(``step.apply``, ``executor.*``, ``stream.*``, ``exec``): inside a
recording ``torch.profiler`` it enters a ``record_function`` range, so
the span lands among the profiler's events on the clock of the card's
operations; given a ``Tracer`` it also records a ``clock="host"`` B/E
pair with its args.  With neither it returns a shared null context: one
branch, and no ``record_function``, which costs microseconds even with
no profiler running.

Events follow the Chrome trace-event phases: ``B``/``E`` span begin/end,
``i`` instant, ``C`` counter.  ``to_chrome()`` exports the
Perfetto-viewable JSON object format (one ``pid`` per engine / tenant /
device, one ``tid`` per stage, exact Fractions preserved in ``args`` so
``Tracer.from_chrome`` round-trips losslessly); ``spans()`` /
``counter_series()`` / ``frame_spans()`` are the plain-Python query API
the tests and the auditor use.

Recording NEVER influences the event loop: the engines only append to
the tracer, so a traced run is event-identical to an untraced one (a
property the tests pin).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Tuple

from torch.autograd import profiler as _profiler


class TraceError(ValueError):
    """Malformed trace operation (unbalanced spans, bad import...)."""


# Chrome trace-event phases this tracer emits/understands.
_PHASES = ("B", "E", "i", "C")

# tick-domain events export at 1 tick = 1 us; host-domain events are
# perf_counter seconds and export at 1 s = 1e6 us.
_HOST_US = 1_000_000.0


def _fraction_str(f: Fraction) -> str:
    return f"{f.numerator}/{f.denominator}"


def _parse_fraction(s: str) -> Fraction:
    num, den = s.split("/")
    return Fraction(int(num), int(den))


def _enc_args(args: Dict) -> Dict:
    """JSON-encode ``args``: exact Fractions become tagged strings."""
    out = {}
    for k, v in args.items():
        if isinstance(v, Fraction):
            out[k] = {"__frac__": _fraction_str(v)}
        elif isinstance(v, tuple):
            out[k] = list(v)
        else:
            out[k] = v
    return out


def _dec_args(args: Dict) -> Dict:
    out = {}
    for k, v in args.items():
        if isinstance(v, dict) and set(v) == {"__frac__"}:
            out[k] = _parse_fraction(v["__frac__"])
        elif isinstance(v, list):
            out[k] = tuple(v)
        else:
            out[k] = v
    return out


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One trace event.  ``t`` is exact: Fraction ticks in the tick
    domain, Fraction-of-seconds (from ``perf_counter``) in the host
    domain.  ``value`` is set for counter (``C``) events only."""

    name: str
    ph: str  # "B" | "E" | "i" | "C"
    t: Fraction
    pid: str
    tid: str
    clock: str = "ticks"  # "ticks" | "host"
    value: Optional[float] = None
    args: Tuple[Tuple[str, object], ...] = ()

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default


@dataclasses.dataclass(frozen=True)
class Span:
    """A paired B/E interval; ``args`` merges both ends (E wins)."""

    name: str
    pid: str
    tid: str
    start: Fraction
    end: Fraction
    clock: str = "ticks"
    args: Tuple[Tuple[str, object], ...] = ()

    @property
    def duration(self) -> Fraction:
        return self.end - self.start

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default


def _as_args(kwargs: Dict) -> Tuple[Tuple[str, object], ...]:
    return tuple(sorted(kwargs.items()))


class Tracer:
    """Append-only event log + query API (see module docstring).

    One tracer may serve many emitters (a fleet of engines, a device
    pipeline): each emitter writes under its own ``pid``.  ``metadata``
    attaches one JSON-able blob per pid — the serving engine stores its
    plan's analytic model there so ``obs.audit`` can replay the trace
    *alone*, with no live plan object in hand.
    """

    def __init__(self) -> None:
        self.events: List[TraceEvent] = []
        self.meta: Dict[str, dict] = {}

    # -- emission ------------------------------------------------------

    def emit(
        self,
        name: str,
        ph: str,
        t,
        *,
        pid: str = "0",
        tid: str = "0",
        clock: str = "ticks",
        value: Optional[float] = None,
        **args,
    ) -> None:
        if ph not in _PHASES:
            raise TraceError(f"unknown phase {ph!r} (expected {_PHASES})")
        self.events.append(
            TraceEvent(
                name=name,
                ph=ph,
                t=Fraction(t),
                pid=str(pid),
                tid=str(tid),
                clock=clock,
                value=value,
                args=_as_args(args),
            )
        )

    def begin(self, name: str, t, **kw) -> None:
        self.emit(name, "B", t, **kw)

    def end(self, name: str, t, **kw) -> None:
        self.emit(name, "E", t, **kw)

    def span(self, name: str, start, end, **kw) -> None:
        """Emit a balanced B/E pair in one call (the common case for the
        deterministic tick model, where the end is known at the start)."""
        self.begin(name, start, **kw)
        self.end(name, end, **kw)

    def instant(self, name: str, t, **kw) -> None:
        self.emit(name, "i", t, **kw)

    def counter(self, name: str, value, t, **kw) -> None:
        self.emit(name, "C", t, value=float(value), **kw)

    def metadata(self, pid: str, data: dict) -> None:
        """Attach one metadata blob to ``pid`` (exported under
        ``otherData``; the drift auditor's analytic model lives here)."""
        self.meta[str(pid)] = data

    # -- queries ---------------------------------------------------------

    def select(
        self,
        name: Optional[str] = None,
        *,
        ph: Optional[str] = None,
        pid: Optional[str] = None,
        tid: Optional[str] = None,
        clock: Optional[str] = None,
    ) -> List[TraceEvent]:
        return [
            e
            for e in self.events
            if (name is None or e.name == name)
            and (ph is None or e.ph == ph)
            and (pid is None or e.pid == str(pid))
            and (tid is None or e.tid == str(tid))
            and (clock is None or e.clock == clock)
        ]

    def pids(self) -> List[str]:
        return sorted({e.pid for e in self.events})

    def spans(
        self,
        name: Optional[str] = None,
        *,
        pid: Optional[str] = None,
        tid: Optional[str] = None,
        clock: Optional[str] = None,
    ) -> List[Span]:
        """Pair B/E events (FIFO per (pid, tid, name) — spans of one
        name on one track never overlap in this codebase) into ``Span``
        rows, in begin order.  Raises on an unbalanced track."""
        open_: Dict[Tuple[str, str, str], List[TraceEvent]] = {}
        out: List[Span] = []
        for e in self.select(name, pid=pid, tid=tid, clock=clock):
            key = (e.pid, e.tid, e.name)
            if e.ph == "B":
                open_.setdefault(key, []).append(e)
            elif e.ph == "E":
                stack = open_.get(key)
                if not stack:
                    raise TraceError(
                        f"unbalanced span: E without B for {key}"
                    )
                b = stack.pop(0)
                out.append(
                    Span(
                        name=e.name,
                        pid=e.pid,
                        tid=e.tid,
                        start=b.t,
                        end=e.t,
                        clock=b.clock,
                        args=_as_args({**dict(b.args), **dict(e.args)}),
                    )
                )
        dangling = [k for k, v in open_.items() if v]
        if dangling:
            raise TraceError(f"unbalanced span: B without E for {dangling}")
        out.sort(key=lambda s: (s.start, s.pid, s.tid))
        return out

    def counter_series(
        self,
        name: str,
        *,
        pid: Optional[str] = None,
        tid: Optional[str] = None,
    ) -> List[Tuple[Fraction, float]]:
        """The (t, value) samples of one counter track, in emit order."""
        return [
            (e.t, e.value) for e in self.select(name, ph="C", pid=pid, tid=tid)
        ]

    def frame_spans(self, rid: int, *, pid: Optional[str] = None) -> List[Span]:
        """Every stage span whose micro-batch carried frame ``rid`` —
        the per-frame lifecycle view over the batched execution.  A
        frame's span count equals the pipeline stages it crossed."""
        out = []
        for s in self.spans(pid=pid, clock="ticks"):
            rids = s.arg("rids")
            if rids is not None and rid in rids:
                out.append(s)
        return out

    def frame_instants(self, rid: int, *, pid: Optional[str] = None):
        """The instant events (submit/admit/done/shed) of one frame."""
        return [
            e
            for e in self.select(ph="i", pid=pid)
            if e.arg("rid") == rid
        ]

    # -- Chrome trace-event export / import -------------------------------

    def _ids(self) -> Tuple[Dict[str, int], Dict[Tuple[str, str], int]]:
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[str, str], int] = {}
        for e in self.events:
            pids.setdefault(e.pid, len(pids) + 1)
            tids.setdefault((e.pid, e.tid), len(tids) + 1)
        return pids, tids

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON *object format* (Perfetto-
        viewable): one numeric ``pid`` per emitter with a
        ``process_name`` metadata record, one numeric ``tid`` per
        (pid, stage) track with a ``thread_name`` record.  Tick-domain
        timestamps export at 1 tick = 1 us, host-domain at real us; the
        exact Fraction timestamp and the clock ride along in ``args``
        so ``from_chrome`` reconstructs events losslessly."""
        pids, tids = self._ids()
        events = []
        for label, npid in sorted(pids.items(), key=lambda kv: kv[1]):
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": npid,
                    "tid": 0,
                    "args": {"name": label},
                }
            )
        for (plabel, tlabel), ntid in sorted(
            tids.items(), key=lambda kv: kv[1]
        ):
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pids[plabel],
                    "tid": ntid,
                    "args": {"name": tlabel},
                }
            )
        for e in self.events:
            ts = float(e.t) * (_HOST_US if e.clock == "host" else 1.0)
            row = {
                "name": e.name,
                "ph": e.ph,
                "ts": ts,
                "pid": pids[e.pid],
                "tid": tids[(e.pid, e.tid)],
                "args": {
                    **_enc_args(dict(e.args)),
                    "__t__": _fraction_str(e.t),
                    "__clock__": e.clock,
                },
            }
            if e.ph == "i":
                row["s"] = "t"  # instant scope: thread
            if e.ph == "C":
                row["args"]["value"] = e.value
            events.append(row)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"repro_meta": self.meta},
        }

    def dumps(self) -> str:
        return json.dumps(self.to_chrome(), indent=1)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def from_chrome(cls, data) -> "Tracer":
        """Rebuild a ``Tracer`` from ``to_chrome()`` output (a dict, a
        JSON string, or a bare event list) — the round-trip the tests
        pin, and what lets the auditor run on a dumped ``trace.json``."""
        if isinstance(data, str):
            data = json.loads(data)
        if isinstance(data, list):
            data = {"traceEvents": data, "otherData": {}}
        tr = cls()
        tr.meta = dict(
            data.get("otherData", {}).get("repro_meta", {})
        )
        pid_names: Dict[int, str] = {}
        tid_names: Dict[Tuple[int, int], str] = {}
        for row in data["traceEvents"]:
            if row.get("ph") != "M":
                continue
            if row["name"] == "process_name":
                pid_names[row["pid"]] = row["args"]["name"]
            elif row["name"] == "thread_name":
                tid_names[(row["pid"], row["tid"])] = row["args"]["name"]
        for row in data["traceEvents"]:
            ph = row.get("ph")
            if ph not in _PHASES:
                continue
            args = dict(row.get("args", {}))
            clock = args.pop("__clock__", "ticks")
            t_str = args.pop("__t__", None)
            if t_str is not None:
                t = _parse_fraction(t_str)
            else:
                scale = _HOST_US if clock == "host" else 1.0
                t = Fraction(row["ts"]) / Fraction(scale)
            value = args.pop("value", None) if ph == "C" else None
            tr.events.append(
                TraceEvent(
                    name=row["name"],
                    ph=ph,
                    t=t,
                    pid=pid_names.get(row["pid"], str(row["pid"])),
                    tid=tid_names.get(
                        (row["pid"], row["tid"]), str(row["tid"])
                    ),
                    clock=clock,
                    value=value,
                    args=_as_args(_dec_args(args)),
                )
            )
        return tr

    # -- invariants --------------------------------------------------------

    def check_balanced(self) -> int:
        """Raise ``TraceError`` on any unbalanced B/E track; return the
        number of balanced spans (the tests' nesting invariant)."""
        return len(self.spans())


def resolve_tracer(trace) -> Optional[Tracer]:
    """The one knob-decoding rule: ``None``/``False`` = off, ``True`` =
    a fresh private ``Tracer``, a ``Tracer`` = shared (fleet runs pass
    one tracer to every engine)."""
    if trace is None or trace is False:
        return None
    if trace is True:
        return Tracer()
    if isinstance(trace, Tracer):
        return trace
    raise TraceError(
        f"trace={trace!r} — expected None/False, True, or an obs.Tracer"
    )


_OFF = contextlib.nullcontext()


class _HostSpan:
    """The context ``host_span`` returns while a profiler records or a
    tracer is given."""

    __slots__ = ("name", "tracer", "pid", "tid", "args", "_range", "_t0")

    def __init__(self, name, tracer, pid, tid, args) -> None:
        self.name, self.tracer, self.pid, self.tid = name, tracer, pid, tid
        self.args = args
        self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            text = ", ".join(f"{k}={v}" for k, v in self.args.items())
            self._range = _profiler.record_function(self.name, text or None)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.tracer is not None:
            self.tracer.span(
                self.name,
                Fraction(self._t0),
                Fraction(t1),
                pid=self.pid,
                tid=self.tid,
                clock="host",
                **self.args,
            )
        return False


def host_span(
    name: str, tracer: Optional[Tracer] = None, *, pid: str = "0",
    tid: str = "0", **args,
):
    """A host span around a ``with`` block (see the module docstring):
    a ``record_function(name)`` range while ``torch.profiler`` records,
    a ``clock="host"`` span with ``args`` in ``tracer`` when one is
    given, nothing otherwise."""
    if tracer is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _HostSpan(name, tracer, str(pid), str(tid), args)


def iter_spans(spans: Iterable[Span], **arg_filters) -> List[Span]:
    """Filter spans by exact args (``iter_spans(spans, rung=1)``)."""
    out = []
    for s in spans:
        if all(s.arg(k) == v for k, v in arg_filters.items()):
            out.append(s)
    return out
