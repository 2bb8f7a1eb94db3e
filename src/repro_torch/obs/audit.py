"""The continuous drift auditor: Eq. 9/10 as a per-window invariant (the
port's own copy of the JAX package's ``obs/audit.py``).

``ServeSummary.occupancy_ok`` checks the paper's continuous-flow claim
once, at the end of a run, against one scalar (``OCC_TOLERANCE``).
This module replays a serving trace (``obs.trace.Tracer``) and checks
the same calculus *continuously*:

* **Row reproduction.**  From the trace alone — stage busy/blocked
  spans, queue-depth counters, and the plan metadata the engine
  embedded at ``begin()`` — the auditor recomputes every per-(segment,
  stage) row the engine reported: measured occupancy (exact Fraction
  arithmetic, so it equals ``StageReport.measured_occupancy`` to the
  float), the analytic occupancy bound at the segment's admitted rate,
  and max queue depth vs caps.  The run-level verdicts
  (``occupancy_ok`` / ``within_queue_bounds`` / ``stall_free`` /
  ``overloaded``) are re-derived and must agree with the engine's
  ``ServeSummary`` — the cross-check ``benchmarks/table11`` pins.

* **Windowed occupancy ceiling.**  Eq. 9/10 bound what any stage can
  sustain: stage ``s`` absorbs frames at ``utilization_s`` ticks of
  service per frame and the pipeline admits at most ``BestRate``
  frames/tick plus a bounded resident backlog.  Over ANY window of
  ``W`` ticks the busy time of stage ``s`` therefore cannot exceed

      min(W, utilization_s * (BestRate_seg * W + slack_frames))

  with ``slack_frames = microbatch * (3 + sum(queue caps))`` — the
  whole-pipeline residency (every bounded queue full, one batch per
  stage in flight, one forming) that can drain through the window on
  top of steady-state admission.  Exceeding that ceiling (beyond
  ``OCC_TOLERANCE``) means the trace claims service the calculus says
  the hardware cannot deliver — a tampered/buggy timeline, flagged
  with the exact first window (``first_drift``).  Overlapping busy
  spans on one stage (physically impossible) and window queue depths
  above the analytic caps are flagged the same way.

* **Stall localization.**  Every ``blocked`` span (service complete,
  downstream queue full) becomes a ``StallRecord``; ``first_stall``
  names the stage, exact tick, and duration — turning "the run
  stalled" into "stage 2 stalled at tick 384/5 for 8/5 ticks (rung 1)".

The auditor needs no live engine or plan: ``audit(tracer)`` works on a
``Tracer.from_chrome`` round-trip of a dumped ``trace.json``.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.trace import Span, Tracer
from repro_torch.serving.telemetry import OCC_TOLERANCE


class AuditError(ValueError):
    """Trace not auditable (missing metadata, unknown pid...)."""


def _frac(v) -> Fraction:
    if isinstance(v, Fraction):
        return v
    num, den = str(v).split("/")
    return Fraction(int(num), int(den))


@dataclasses.dataclass(frozen=True)
class StallRecord:
    """One blocked interval: service done, downstream queue full."""

    stage: int
    tick: Fraction  # when service completed and blocking began
    dur_ticks: Fraction
    rung: int
    seg: int

    def describe(self) -> str:
        return (
            f"stage {self.stage} stalled at tick {self.tick} for "
            f"{self.dur_ticks}t (rung {self.rung})"
        )


@dataclasses.dataclass(frozen=True)
class WindowVerdict:
    """One (segment, stage, window) occupancy check."""

    seg: int
    rung: int
    stage: int
    start: Fraction  # ticks
    end: Fraction
    busy_frac: float
    ceiling: float
    queue_peak: float
    queue_cap: int
    ok: bool
    reason: str = ""  # "" when ok

    def describe(self) -> str:
        return (
            f"stage {self.stage} drifted at tick {self.start} (rung "
            f"{self.rung}): {self.reason}"
        )


@dataclasses.dataclass(frozen=True)
class AuditRow:
    """One per-(segment, stage) row recomputed from the trace — the
    twin of ``serving.cnn_stream.StageReport``."""

    seg: int
    rung: int
    stage: int
    utilization: Fraction
    measured_occupancy: float
    analytic_occupancy: Fraction
    busy_ticks: Fraction
    stall_ticks: Fraction
    max_queue: int
    queue_cap: int


@dataclasses.dataclass
class AuditReport:
    """Everything the auditor derived from one pid's timeline."""

    pid: str
    window_ticks: Fraction
    makespan_ticks: Fraction
    rows: List[AuditRow]
    windows: List[WindowVerdict]
    stalls: List[StallRecord]
    submitted: int
    completed: int
    shed: int
    switches: int
    best_rate: Fraction
    arrival_rate: Fraction
    # -- run-level verdicts (must agree with ServeSummary) -----------------
    bottleneck_row: int
    occupancy_ok: bool
    within_queue_bounds: bool
    stall_free: bool
    overloaded: bool

    @property
    def first_stall(self) -> Optional[StallRecord]:
        return self.stalls[0] if self.stalls else None

    @property
    def drift_windows(self) -> List[WindowVerdict]:
        return [w for w in self.windows if not w.ok]

    @property
    def first_drift(self) -> Optional[WindowVerdict]:
        bad = self.drift_windows
        return bad[0] if bad else None

    @property
    def clean(self) -> bool:
        """No window ever exceeded the calculus' ceiling."""
        return not self.drift_windows

    def matches(self, summary) -> bool:
        """Do the trace-derived run verdicts agree with an engine's
        ``ServeSummary``?  (The table11 acceptance cross-check.)"""
        return (
            self.occupancy_ok == summary.occupancy_ok
            and self.within_queue_bounds == summary.within_queue_bounds
            and self.stall_free == summary.stall_free
            and self.overloaded == summary.overloaded
            and self.completed == summary.completed
            and self.shed == summary.shed
            and self.switches == summary.switches
        )

    def localization(self) -> str:
        """The first-failure pointer: drift beats stall (drift is a
        bug, a stall above BestRate is expected backpressure)."""
        if self.first_drift is not None:
            return f"first drift: {self.first_drift.describe()}"
        if self.first_stall is not None:
            return f"first stall: {self.first_stall.describe()}"
        return "no drift, no stalls"

    def verdict_line(self) -> str:
        """The pinned one-line verdict (``benchmarks/table11``)."""
        n_ok = sum(1 for w in self.windows if w.ok)
        occ = "OK" if self.occupancy_ok else "DRIFT (bug)"
        q = "bounded" if self.within_queue_bounds else "UNBOUNDED (bug)"
        return (
            f"windows {n_ok}/{len(self.windows)} ok (W={self.window_ticks}t), "
            f"occ {occ}, queues {q}, stalls {len(self.stalls)}, "
            f"{self.localization()}"
        )


# ==========================================================================
# Trace parsing helpers
# ==========================================================================


def _stage_index(tid: str) -> int:
    if not tid.startswith("stage"):
        raise AuditError(f"span on unexpected track {tid!r}")
    return int(tid[len("stage") :])


def _seg_rungs(tracer: Tracer, pid: str, n_switches: int) -> List[int]:
    """rung active in each segment: seg 0 runs rung 0, each switch
    instant opens the next segment on its target rung."""
    rungs = [0]
    for e in tracer.select("switch", ph="i", pid=pid):
        rungs.append(int(e.arg("to_rung")))
    if len(rungs) != n_switches + 1:
        raise AuditError(
            f"segment/switch mismatch: {len(rungs) - 1} switch events, "
            f"{n_switches} expected"
        )
    return rungs


def _seg_bounds(
    tracer: Tracer, pid: str, makespan: Fraction
) -> List[Tuple[Fraction, Fraction]]:
    cuts = [e.t for e in tracer.select("switch", ph="i", pid=pid)]
    edges = [Fraction(0)] + cuts + [makespan]
    return list(zip(edges[:-1], edges[1:]))


def _window_busy(
    spans: List[Span], lo: Fraction, hi: Fraction
) -> Fraction:
    busy = Fraction(0)
    for s in spans:
        a, b = max(s.start, lo), min(s.end, hi)
        if b > a:
            busy += b - a
    return busy


# ==========================================================================
# The auditor
# ==========================================================================


def audit(
    tracer: Tracer,
    pid: Optional[str] = None,
    *,
    window_ticks=None,
    tolerance: float = OCC_TOLERANCE,
) -> AuditReport:
    """Replay one pid's tick-domain timeline against the analytic model
    the engine embedded in the trace metadata (see module docstring).

    ``window_ticks`` defaults to ``ceil(makespan / 16)`` — 16 windows
    per run, deterministic for a given trace.  Pass an explicit value
    to zoom the continuous check in or out.
    """
    if pid is None:
        pids = sorted(tracer.meta)
        if len(pids) != 1:
            raise AuditError(
                f"trace has {len(pids)} engine timelines ({pids}); pass pid="
            )
        pid = pids[0]
    meta = tracer.meta.get(str(pid))
    if meta is None:
        raise AuditError(
            f"no plan metadata for pid {pid!r} — was the engine traced?"
        )
    arrival = _frac(meta["arrival_rate"])
    microbatch = int(meta["microbatch"])
    rung_meta = meta["rungs"]

    events = tracer.select(pid=pid, clock="ticks")
    if not events:
        raise AuditError(f"no tick-domain events for pid {pid!r}")
    makespan = max(e.t for e in events)

    stage_spans = tracer.spans("stage", pid=pid, clock="ticks")
    blocked_spans = tracer.spans("blocked", pid=pid, clock="ticks")
    submitted = len(tracer.select("submit", ph="i", pid=pid))
    completed = len(tracer.select("done", ph="i", pid=pid))
    shed = len(tracer.select("shed", ph="i", pid=pid))
    switches = len(tracer.select("switch", ph="i", pid=pid))

    seg_rungs = _seg_rungs(tracer, pid, switches)
    seg_bounds = _seg_bounds(tracer, pid, makespan)
    best = max(_frac(rung_meta[r]["best_rate"]) for r in seg_rungs)
    overloaded = arrival > best or shed > 0 or switches > 0

    if window_ticks is None:
        window_ticks = Fraction(max(1, -(-int(makespan) // 16)))
    else:
        window_ticks = Fraction(window_ticks)
        if window_ticks <= 0:
            raise AuditError(f"window_ticks must be > 0, got {window_ticks}")

    # -- per-(segment, stage) rows (the StageReport twins) -----------------
    rows: List[AuditRow] = []
    row_spans: List[List[Span]] = []
    for seg, rung in enumerate(seg_rungs):
        rm = rung_meta[rung]
        utils = [_frac(u) for u in rm["utilization"]]
        caps = [int(c) for c in rm["caps"]]
        seg_admitted = min(arrival, _frac(rm["best_rate"]))
        for s in range(len(utils)):
            spans = [
                sp
                for sp in stage_spans
                if sp.arg("seg") == seg and _stage_index(sp.tid) == s
            ]
            blocked = {
                sp.arg("bid"): sp
                for sp in blocked_spans
                if sp.arg("seg") == seg and _stage_index(sp.tid) == s
            }
            busy = sum((sp.duration for sp in spans), Fraction(0))
            stall = sum(
                (sp.duration for sp in blocked.values()), Fraction(0)
            )
            occ = 0.0
            if spans:
                first = min(sp.start for sp in spans)
                # departure = end of service, or end of the blocked
                # interval when downstream held the batch
                last = max(
                    blocked[sp.arg("bid")].end
                    if sp.arg("bid") in blocked
                    else sp.end
                    for sp in spans
                )
                if last > first:
                    occ = float(busy / (last - first))
            depths = [
                e.value
                for e in tracer.select(
                    "queue_depth", ph="C", pid=pid, tid=f"stage{s}"
                )
                if e.arg("seg") == seg
            ]
            rows.append(
                AuditRow(
                    seg=seg,
                    rung=rung,
                    stage=s,
                    utilization=utils[s],
                    measured_occupancy=occ,
                    analytic_occupancy=utils[s] * seg_admitted,
                    busy_ticks=busy,
                    stall_ticks=stall,
                    max_queue=int(max(depths)) if depths else 0,
                    queue_cap=caps[s],
                )
            )
            row_spans.append(spans)

    # -- run-level verdicts (must agree with ServeSummary) -----------------
    # ServeReport.bottleneck_stage is the *stage index* of the max-
    # utilization row, and summary() indexes the row list with it —
    # reproduce that exactly so verdicts agree on switching runs too.
    bott = max(rows, key=lambda r: r.utilization).stage
    b_occ = rows[bott].measured_occupancy
    b_bound = float(rows[bott].analytic_occupancy)
    if overloaded:
        occupancy_ok = b_occ <= b_bound + tolerance
    else:
        occupancy_ok = abs(b_occ - b_bound) <= tolerance
    within_queue_bounds = all(r.max_queue <= r.queue_cap for r in rows)
    stall_free = not blocked_spans

    # -- stall records ------------------------------------------------------
    stalls = sorted(
        (
            StallRecord(
                stage=_stage_index(sp.tid),
                tick=sp.start,
                dur_ticks=sp.duration,
                rung=seg_rungs[int(sp.arg("seg"))],
                seg=int(sp.arg("seg")),
            )
            for sp in blocked_spans
        ),
        key=lambda r: (r.tick, r.stage),
    )

    # -- the continuous per-window invariant --------------------------------
    windows: List[WindowVerdict] = []
    for row, spans in zip(rows, row_spans):
        rm = rung_meta[row.rung]
        caps = [int(c) for c in rm["caps"]]
        best_seg = _frac(rm["best_rate"])
        slack_frames = microbatch * (3 + sum(caps))
        lo0, hi0 = seg_bounds[row.seg]
        depth_samples = [
            (e.t, e.value)
            for e in tracer.select(
                "queue_depth", ph="C", pid=pid, tid=f"stage{row.stage}"
            )
            if e.arg("seg") == row.seg
        ]
        overlap = _spans_overlap(spans)
        # the tick model is deterministic: a batch of n frames at stage
        # s takes EXACTLY n * utilization_s ticks (Eq. 9's service =
        # work / capacity).  Any span violating that is tampered time.
        bad_svc = [
            sp
            for sp in spans
            if sp.duration != sp.arg("frames") * row.utilization
        ]
        k = 0
        while lo0 + k * window_ticks < hi0:
            lo = lo0 + k * window_ticks
            hi = min(lo + window_ticks, hi0)
            k += 1
            width = hi - lo
            busy = _window_busy(spans, lo, hi)
            busy_frac = float(busy / width)
            ceiling = float(
                min(
                    Fraction(1),
                    row.utilization
                    * (best_seg + Fraction(slack_frames) / width),
                )
            )
            peak = max(
                (v for t, v in depth_samples if lo <= t < hi), default=0.0
            )
            ok = True
            reason = ""
            bad_here = [sp for sp in bad_svc if lo <= sp.start < hi]
            if overlap is not None and lo <= overlap < hi:
                ok, reason = False, "overlapping busy spans"
            elif bad_here:
                sp = bad_here[0]
                ok, reason = (
                    False,
                    f"service {sp.duration}t != "
                    f"{sp.arg('frames') * row.utilization}t for "
                    f"{sp.arg('frames')} frame(s)",
                )
            elif busy_frac > ceiling + tolerance:
                ok, reason = (
                    False,
                    f"busy {busy_frac:.3f} > ceiling {ceiling:.3f}",
                )
            elif peak > row.queue_cap:
                ok, reason = (
                    False,
                    f"queue {peak:.0f} > cap {row.queue_cap}",
                )
            windows.append(
                WindowVerdict(
                    seg=row.seg,
                    rung=row.rung,
                    stage=row.stage,
                    start=lo,
                    end=hi,
                    busy_frac=busy_frac,
                    ceiling=ceiling,
                    queue_peak=float(peak),
                    queue_cap=row.queue_cap,
                    ok=ok,
                    reason=reason,
                )
            )
    windows.sort(key=lambda w: (w.start, w.seg, w.stage))

    return AuditReport(
        pid=str(pid),
        window_ticks=window_ticks,
        makespan_ticks=makespan,
        rows=rows,
        windows=windows,
        stalls=stalls,
        submitted=submitted,
        completed=completed,
        shed=shed,
        switches=switches,
        best_rate=best,
        arrival_rate=arrival,
        bottleneck_row=bott,
        occupancy_ok=occupancy_ok,
        within_queue_bounds=within_queue_bounds,
        stall_free=stall_free,
        overloaded=overloaded,
    )


def _spans_overlap(spans: List[Span]) -> Optional[Fraction]:
    """First tick where two busy spans of one stage overlap (a
    physically impossible timeline), or None."""
    ordered = sorted(spans, key=lambda s: s.start)
    for a, b in zip(ordered, ordered[1:]):
        if b.start < a.end:
            return b.start
    return None


def audit_fleet(
    tracer: Tracer, **kwargs
) -> Dict[str, AuditReport]:
    """Audit every engine timeline in a shared (fleet) trace."""
    return {pid: audit(tracer, pid, **kwargs) for pid in sorted(tracer.meta)}
