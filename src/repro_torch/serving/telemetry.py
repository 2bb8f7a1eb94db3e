"""The unified serving-telemetry schema: the port's own copy of the JAX
package's ``serving/telemetry.py``.

``ServeReport`` (one engine) and ``FleetReport`` (many engines, one
shared clock) grew overlapping ad-hoc surfaces, and every benchmark
table hand-flattened report attributes into its row strings.
``ServeSummary`` is the one schema both reduce to —
``ServeReport.summary()`` / ``FleetReport.to_rows()`` — carrying the
shared fields (counts incl. ``shed``/``switches``, throughput, p50/p99
ticks, bottleneck occupancy vs bound, queue depth vs caps, stalls) plus
the canonical renderings the tables share:

* piecewise format helpers (``throughput_str`` / ``latency_str`` /
  ``occupancy_str`` / ``queue_str`` / ``stall_str``) — the exact
  fragments the pinned table6/table7 rows are built from, so the
  regression-gated strings stay byte-identical while the tables stop
  reaching into per-stage report internals;
* ``line()`` / ``fleet_line()`` — the assembled table6 / table7 rows;
* ``to_rows()`` — the canonical (name, value) rows ``table8_overload``
  pins, one compact row group per serving run.

Everything here is plain floats/ints/strings: the exact-Fraction
arithmetic stays in the reports; a summary is the rendered view.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

# measured occupancy may drift from the analytic bound by scheduling
# quantization (micro-batch granularity) — beyond this it's a bug
OCC_TOLERANCE = 0.05


@dataclasses.dataclass(frozen=True)
class ServeSummary:
    """Rendered telemetry of one serving run (engine or fleet tenant)."""

    label: str
    submitted: int
    completed: int
    shed: int
    switches: int
    throughput: float  # completed frames / makespan ticks
    p50_ticks: float  # service latency (admit -> done)
    p99_ticks: float
    p50_total_ticks: float  # total latency (submit -> done)
    p99_total_ticks: float
    stall_free: bool
    stall_ticks: float  # summed stage stalls, in ticks
    within_queue_bounds: bool
    request_queue_peak: int
    bottleneck_stage: int
    bottleneck_occupancy: float  # measured busy fraction
    bottleneck_bound: float  # analytic occupancy at the admitted rate
    max_queue: Tuple[int, ...]  # per stage row (segments concatenated)
    queue_caps: Tuple[int, ...]
    # mean offered rate above BestRate: stalls are backpressure and
    # occupancy may idle below the mean-rate bound, not bugs
    overloaded: bool = False
    # obs.MetricsRegistry.snapshot() of the run, when the engine ran
    # with tracing on (None otherwise).  Excluded from compare/repr so
    # the pinned row renderings above stay byte-identical.
    metrics: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shed_fraction(self) -> float:
        return self.shed / self.submitted if self.submitted else 0.0

    @property
    def occupancy_ok(self) -> bool:
        if self.overloaded:
            # off-phases (diurnal nights) and post-switch base-rung
            # segments legitimately idle below the mean-rate bound;
            # only *exceeding* the bound is drift
            return (
                self.bottleneck_occupancy
                <= self.bottleneck_bound + OCC_TOLERANCE
            )
        return (
            abs(self.bottleneck_occupancy - self.bottleneck_bound)
            <= OCC_TOLERANCE
        )

    # -- the shared row fragments (byte-compatible with the pinned rows) ---

    def throughput_str(self) -> str:
        return f"thr {self.throughput:.3f} f/tick"

    def latency_str(self) -> str:
        return f"p50 {self.p50_ticks:.1f} p99 {self.p99_ticks:.1f} ticks"

    def occupancy_str(self) -> str:
        verdict = "OK" if self.occupancy_ok else "DRIFT (bug)"
        return (
            f"occ[s{self.bottleneck_stage}] {self.bottleneck_occupancy:.3f} "
            f"(bound {self.bottleneck_bound:.3f}, {verdict})"
        )

    def bounded_str(self) -> str:
        return "bounded" if self.within_queue_bounds else "UNBOUNDED (bug)"

    def queue_str(self) -> str:
        return (
            f"q {list(self.max_queue)} <= cap {list(self.queue_caps)} "
            f"({self.bounded_str()})"
        )

    def stall_str(self, show_ticks: bool = False) -> str:
        if show_ticks:
            return f"upstream stalls {self.stall_ticks:.1f}t"
        if self.stall_free:
            return "stall-free"
        if self.overloaded:
            # above BestRate the continuous-flow theorem does not apply:
            # full inter-stage queues stall upstream stages by design
            return f"upstream stalls {self.stall_ticks:.1f}t (backpressure)"
        return "STALLED (bug)"

    # -- assembled lines ---------------------------------------------------

    def line(self, *, over_best: bool = False) -> str:
        """The table6 serving row (stall ticks shown above BestRate)."""
        return (
            f"{self.throughput_str()}, {self.latency_str()}, "
            f"{self.occupancy_str()}, {self.queue_str()}, "
            f"{self.stall_str(show_ticks=over_best)}, "
            f"req-q peak {self.request_queue_peak}"
        )

    def fleet_line(self) -> str:
        """The table7 per-tenant fleet row (sans the workload prefix)."""
        return (
            f"served {self.completed}, {self.throughput_str()}, "
            f"{self.latency_str()}, {self.stall_str()}, "
            f"{self.bounded_str()}"
        )

    def to_rows(self) -> List[Tuple[str, str]]:
        """Canonical (name, value) rows — what ``table8_overload`` pins.

        Three compact rows per run: what was served/shed/switched, the
        latency profile, and the pipeline-health invariants.
        """
        return [
            (
                "served",
                f"served {self.completed}/{self.submitted}, shed "
                f"{self.shed} ({self.shed_fraction:.2f}), switches "
                f"{self.switches}",
            ),
            (
                "latency",
                f"{self.throughput_str()}, {self.latency_str()}, "
                f"total p99 {self.p99_total_ticks:.1f} ticks",
            ),
            (
                "health",
                f"{self.occupancy_str()}, {self.queue_str()}, "
                f"{self.stall_str()}, req-q peak {self.request_queue_peak}",
            ),
        ]
