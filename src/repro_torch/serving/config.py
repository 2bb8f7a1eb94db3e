"""ServeConfig: the one serving surface (the port's own copy of the JAX
package's ``serving/config.py``).

One frozen dataclass, in four groups:

* **execution knobs** — how admitted micro-batches are computed
  (``microbatch``, ``kernel_plan``, ``impls``, ``overrides``, ``dtype``,
  ``check``, ``execute``, ``link_quant``);
* **observability** — ``trace`` / ``trace_pid`` / ``trace_chips``: the
  opt-in ``obs.Tracer`` hookup (off by default and event-identical when
  off);
* **arrival source** — a bare rate (frames/tick) or any
  ``serving.scenarios.ArrivalProcess`` (``arrival``), plus the run bound
  ``max_ticks``;
* **flush / SLA / overload policy** — ``flush_after_ticks`` (straggler
  bound on partial micro-batches) and ``overload`` (``None``,
  ``serving.overload.ShedPolicy`` or ``serving.overload.SwitchPolicy``).

``CNNStreamEngine(graph, params, plan, config)``, ``CNNApi.serve(...,
config=...)`` and ``serve_frames(..., config=...)`` consume it.

Three fields of the JAX package's ``ServeConfig`` have no counterpart
here and are left out: ``interpret`` and ``jit`` (the port's stages run
eagerly and its kernels are CUDA, so there is neither an interpret mode
nor a trace to compile), and ``pipeline_cache`` (the port keeps no
pipeline cache: building a ``StagePipeline`` is a fraction of a
millisecond of Python, so each engine builds each rung's pipeline once).
The JAX engine's deprecated keyword arguments are not carried either:
the port's engine takes a ``ServeConfig`` only.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything one serving run needs, in one frozen value.

    ``dtype=None`` resolves to the engine default (``torch.float32``).
    ``arrival`` is a constant rate in frames/tick (``Fraction``/int) or
    an ``ArrivalProcess``.  ``kernel_plan`` must be pinned to
    ``microbatch`` when given (``GraphPlan.kernel_plan(batch=B)``).
    """

    # -- execution knobs ---------------------------------------------------
    microbatch: int = 1
    kernel_plan: Optional[Mapping[str, Any]] = None
    impls: Optional[Mapping[str, Any]] = None
    overrides: Optional[Mapping[str, Any]] = None
    dtype: Any = None  # a torch.dtype; None = torch.float32
    check: bool = True
    # False = the tick model alone (no tensors, no outputs); True = run
    # the stages on the engine's device; "devices" = stage s on card
    # s % n of the engine's pool, each on a CUDA stream of its own.
    execute: Any = True
    # Quantized cut crossings (models.cnn.stage_functions link_quant):
    # None = full-precision boundaries (the default), True = the plan's
    # link_dtype, or a dtype str / per-producer / per-edge mapping.
    link_quant: Any = None
    # -- observability (obs.trace / obs.metrics) ----------------------------
    # None/False = off (the default: event-identical, no cost), True = a
    # fresh private obs.Tracer, or an obs.Tracer instance shared across
    # engines.  When on, the engine also keeps an obs.MetricsRegistry per
    # run (folded into ServeSummary.metrics).
    trace: Any = None
    # pid label this engine's trace events are recorded under
    trace_pid: str = "engine"
    # optional {stage: chip label} tags stamped onto stage spans
    trace_chips: Optional[Mapping[int, str]] = None
    # -- arrival source ----------------------------------------------------
    arrival: Any = Fraction(1)
    max_ticks: int = 1_000_000
    # -- flush / SLA / overload policy -------------------------------------
    flush_after_ticks: Optional[Fraction] = None
    overload: Optional[Any] = None

    def with_(self, **changes) -> "ServeConfig":
        """A copy with ``changes`` applied (frozen-friendly update)."""
        return dataclasses.replace(self, **changes)
