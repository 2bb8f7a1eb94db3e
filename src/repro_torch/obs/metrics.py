"""The serving-stack metrics registry: the port's own copy of the JAX
package's ``obs/metrics.py``.

Counters, gauges, and histograms with Prometheus-style label sets,
snapshotable at any tick.  The serving engine keeps one registry per
run (``CNNStreamEngine.metrics``, on when tracing is on) and maintains
the canonical instrument set as the event loop runs:

* ``frames_submitted`` / ``frames_admitted`` / ``frames_completed`` /
  ``shed_total`` / ``plan_switches`` — counters;
* ``queue_depth{stage=s}`` — gauge (current + high-water mark);
* ``stage_busy_ticks{stage=s}`` / ``stage_stall_ticks{stage=s}`` —
  exact-Fraction counters (busy/stall time on the rational clock);
* ``latency_ticks`` / ``service_latency_ticks`` — histograms;
* ``transfer_bytes{edge=u->sN,dtype=d}`` — counter, maintained by the
  ``models.cnn.StagePipeline`` observe hook when boundary tensors move
  between placed stages (the measured twin of the priced
  ``StreamBuffer`` wire widths).

Counters accept exact ``fractions.Fraction`` increments so tick-domain
totals stay exact; ``snapshot()`` returns a plain dict view (floats for
histograms, exact values passed through) that folds into the unified
``serving.telemetry.ServeSummary`` without touching its pinned row
renderings.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, List, Optional, Tuple


class MetricsError(ValueError):
    """Misused metrics instrument (kind clash, bad labels...)."""


def metric_key(name: str, labels: Optional[dict] = None) -> str:
    """Canonical instrument key: ``name{k=v,...}`` with sorted labels."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone accumulator; exact when fed Fractions/ints."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise MetricsError(f"counter increments must be >= 0, got {n}")
        self.value = self.value + n

    def get(self):
        return self.value


class Gauge:
    """Last-write value plus its high-water mark."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0
        self.max_value = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.max_value:
            self.max_value = v

    def get(self):
        return self.value


class Histogram:
    """Streaming distribution: count/sum/min/max + exact percentiles
    (same nearest-rank convention as ``ServeReport``)."""

    kind = "histogram"

    def __init__(self) -> None:
        self.values: List[float] = []

    def observe(self, v) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    def percentile(self, q: float) -> float:
        if not self.values:
            return float("nan")
        ordered = sorted(self.values)
        idx = max(0, math.ceil(q * len(ordered)) - 1)
        return ordered[idx]

    def get(self) -> dict:
        vals = self.values
        return {
            "count": len(vals),
            "sum": self.sum,
            "min": min(vals) if vals else float("nan"),
            "max": max(vals) if vals else float("nan"),
            "p50": self.percentile(0.50),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Get-or-create instruments keyed by ``name{labels}``.

    One registry per serving run; ``snapshot()`` may be taken at any
    tick (the registry is maintained incrementally, not rebuilt at
    report time).
    """

    def __init__(self) -> None:
        self._instruments: Dict[str, object] = {}

    def _get(self, cls, name: str, labels: dict):
        key = metric_key(name, labels)
        inst = self._instruments.get(key)
        if inst is None:
            inst = cls()
            self._instruments[key] = inst
        elif not isinstance(inst, cls):
            raise MetricsError(
                f"{key} already registered as a {inst.kind}, not a "
                f"{cls.kind}"
            )
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def __contains__(self, key: str) -> bool:
        return key in self._instruments

    def get(self, key: str):
        """The instrument registered under a rendered key, or None."""
        return self._instruments.get(key)

    def value(self, name: str, **labels):
        """Current value of one instrument (None when never touched)."""
        inst = self._instruments.get(metric_key(name, labels))
        return None if inst is None else inst.get()

    def snapshot(self) -> Dict[str, object]:
        """A plain-dict view at this instant: counters/gauges keep
        their exact values (Fractions pass through), histograms render
        to their summary dicts.  Keys are the canonical rendered names;
        gauges additionally export a ``:max`` high-water key."""
        out: Dict[str, object] = {}
        for key in sorted(self._instruments):
            inst = self._instruments[key]
            out[key] = inst.get()
            if isinstance(inst, Gauge):
                out[f"{key}:max"] = inst.max_value
        return out

    def to_rows(self) -> List[Tuple[str, str]]:
        """Rendered (name, value) rows, sorted — for logs/benchmarks."""
        rows = []
        for key, val in self.snapshot().items():
            if isinstance(val, dict):
                body = (
                    f"count {val['count']}, p50 {val['p50']:.1f}, "
                    f"p99 {val['p99']:.1f}"
                )
            elif isinstance(val, Fraction):
                body = f"{float(val):.3f}"
            else:
                body = str(val)
            rows.append((key, body))
        return rows
