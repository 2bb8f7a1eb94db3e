"""Rate-calculus observability for the serving stack: the port's own copy
of the JAX package's ``obs/`` (it imports nothing of it).

Three layers, all opt-in and zero-overhead when off:

* ``obs.trace`` — per-frame lifecycle spans on the exact rational clock
  (plus host wall-clock spans), Chrome trace-event JSON export, and a
  plain-Python query API;
* ``obs.metrics`` — counters / gauges / histograms snapshotable at any
  tick and folded into ``ServeSummary``;
* ``obs.audit`` — the continuous drift auditor: replays a trace
  against the analytic Eq. 9/10 bounds per segment/rung and localizes
  the first stall/drift tick.

See ``docs/observability.md``.
"""

from repro_torch.obs.audit import (
    AuditError,
    AuditReport,
    AuditRow,
    StallRecord,
    WindowVerdict,
    audit,
    audit_fleet,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsError,
    MetricsRegistry,
    metric_key,
)
from repro_torch.obs.trace import (
    Span,
    TraceError,
    TraceEvent,
    Tracer,
    iter_spans,
    resolve_tracer,
)

__all__ = [
    "AuditError",
    "AuditReport",
    "AuditRow",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsError",
    "MetricsRegistry",
    "Span",
    "StallRecord",
    "TraceError",
    "TraceEvent",
    "Tracer",
    "WindowVerdict",
    "audit",
    "audit_fleet",
    "iter_spans",
    "metric_key",
    "resolve_tracer",
]
