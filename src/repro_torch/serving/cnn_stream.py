"""Data-rate-aware streaming CNN serving: the paper's calculus per request.

The port's own copy of the JAX package's ``serving/cnn_stream.py``.  The
tick model, the policies and the reports are the reference's line for
line (exact ``Fraction`` arithmetic, so a run gives the reference's
``ServeReport`` field for field); what differs is the execution
underneath, which runs the staged pipeline on the engine's device (see
"On the card" below).

The paper's continuous-flow property (Eqs. 7-11) is stated per layer:
provide every arithmetic unit with data at its input rate and nothing
ever stalls.  This module lifts the same calculus one level, to the
*request* stream a serving deployment sees, and drives the multi-chip
stage partition (``core.stage_partition`` / ``models.cnn.stage_functions``)
as a software pipeline under load:

* **Service rates are inherited, not re-derived.**  A node of the
  ``GraphPlan`` absorbs ``capacity`` features/clock (the DSE's Eq. 9
  choice), so one frame — ``in_px * d_in`` features at that node —
  occupies it for ``frame_features / capacity`` cycles.  A pipeline
  stage initiates frames at the pace of its slowest node (the stage's
  initiation interval), and the *request-level BestRate* is Eq. 10 one
  level up: the slowest stage's frame rate,

      BestRate = min_s 1 / II_s = input_rate / frame_features
                 * min_n capacity_n / demand_n   [frames/cycle].

  In tick units (one tick = one frame interval at the plan's input
  rate) BestRate is exactly ``1 / max_n utilization_n`` — the plan's
  bottleneck utilization read as request headroom.

* **Admission control = Eq. 9 at the request level.**  Frames arrive
  (at a constant rate or any ``serving.scenarios.ArrivalProcess``) into
  a request queue; they are admitted into the pipeline only while the
  bottleneck stage has slack.  Mechanically the admission gate checks
  space in the stage-0 queue — the inter-stage queues are bounded and
  every stage blocks when its successor is full, so bottleneck
  saturation propagates upstream to the gate within a pipeline-depth of
  batches.  The resulting admitted rate is ``min(arrival_rate,
  BestRate)``: below BestRate everything is admitted immediately and no
  stage ever stalls; above it the engine serves at exactly BestRate
  with the excess parked *outside* the pipeline (the request queue),
  keeping the in-pipeline queues bounded.

* **Micro-batching fills the planned tiles.**  Admitted frames are
  grouped into micro-batches of ``microbatch`` frames, the batch the
  rate-matched kernel plan was pinned to (``GraphPlan.kernel_plan(
  batch=B)``): the fcu kernels then execute their planned bm exactly
  (plan-aware bm) instead of re-fitting a smaller pixel tile at their
  planned occupancy's expense.  The final partial batch is zero-padded
  (every batch runs the kernels at the pinned batch, so a frame's
  result never depends on how full its batch was) and the pad rows are
  dropped from the served outputs.

* **Bounded inter-stage queues, double-buffered stages.**  The queue
  between stages holds 2 micro-batches (one being consumed, one
  landing — double buffering) plus whatever the analytic cut buffers
  add: ``core.stage_partition.stream_buffers`` sizes the cut-crossing
  FIFOs in *pixels* (skew bound + link slack), which this engine
  converts to whole frames at the cut's activation width.  Since the
  pixel bounds are a small fraction of a frame, the conversion almost
  always floors to the bare double buffer — the analytically honest
  version of "queues of 2".

* **Overload is a policy, not a failure mode.**  Excess arrivals used
  to mean unbounded request-queue latency.  ``ServeConfig.overload``
  plugs a policy into the event loop (``serving.overload``):
  ``ShedPolicy`` drops the oldest pending frame once its *projected*
  completion misses an SLA deadline (counted in ``ServeReport.shed``;
  survivors are never reordered), and ``SwitchPolicy`` re-plans online
  — a precomputed downgrade ladder of ``GraphPlan``s keyed by
  arrival-rate bands, swapped at micro-batch boundaries by draining the
  in-flight batches before re-pinning the kernel plan, with the
  continuous-flow invariant (zero stalls at <= the *active* plan's
  BestRate) re-asserted after every switch.

* **Telemetry against the analytical model.**  The engine records
  per-stage busy/stall intervals and queue-depth events on an exact
  rational clock.  ``ServeReport`` exposes per-tick occupancy and
  queue-depth series plus aggregates that the tests assert against
  ``core.schedule.simulate_graph``: measured stage occupancy equals
  the analytic ``max_n demand_n / capacity_n`` (the same value
  simulate_graph measures per node at pixel granularity), zero stalls
  whenever the admitted rate <= BestRate, and queue depths within the
  stream-buffer bounds under backpressure above it.

Configuration is one frozen ``serving.ServeConfig`` (execution knobs +
arrival source + flush/SLA/overload policy); ``run``'s keyword
arguments override its arrival source, run bound and flush knob per
run.  Timing is a deterministic tick model (exact ``fractions.Fraction``
cycle arithmetic), never wall-clock; the execution underneath produces
the real outputs but does not influence the clock.

On the card:

* **Frames in.**  ``submit`` takes one ``[H, W, C]`` numpy array or
  tensor and moves it to the engine's device; ``submit_all`` of an
  ``[N, H, W, C]`` array or tensor moves the whole stack in one copy.
  Each request then holds a row of it, and a micro-batch is one stack of
  its rows on the device (a gather), zero-padded on the device to
  ``microbatch`` rows.
* **Frames out.**  A finished micro-batch leaves its rows on the device
  (``FrameRequest.out`` is a view of the batch's logits); ``outputs()``
  stacks the served rows, in rid order, into one tensor on the device.
  Nothing in the event loop reads a tensor back to the host, so the
  host runs ahead of the card while the kernels of earlier stages run.
* **``execute="devices"``.**  Stage s runs on card s % n of the pool and
  on a CUDA stream of its own (``models.cnn.StagePipeline``), so stages
  of different micro-batches may run at once even on one card; every
  placed cut crossing is counted into ``transfer_bytes{edge,dtype}``
  when tracing is on.
* **Bit-exactness.**  Every micro-batch runs at the pinned batch, so the
  served rows of a micro-batch equal ``models.cnn.apply_staged`` on the
  same zero-padded micro-batch bit for bit (fp32 and int8 links).  With
  int8 links a micro-batch's payload takes one scale, so the pad rows
  are part of what the real frames' payload depends on, as in the
  reference.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from collections import deque
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.replicate import lane_multiplicity, replicate_params
from repro_torch.core.stage_partition import LINK_DTYPE_BITS
from repro_torch.models import cnn
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import host_span, resolve_tracer
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.overload import ShedPolicy, SwitchPolicy
from repro_torch.serving.scenarios import ArrivalProcess
from repro_torch.serving.telemetry import ServeSummary


class ServingError(ValueError):
    """Misconfigured or inconsistent streaming-serving setup."""


def _fstr(f) -> str:
    """Exact-Fraction string ("a/b") for the trace metadata blob."""
    f = Fraction(f)
    return f"{f.numerator}/{f.denominator}"


# ==========================================================================
# Request-level rate analytics (exact, derived from the GraphPlan)
# ==========================================================================


def _frame_features(spec) -> int:
    """Features of one frame entering a node: in_px * d_in (the per-frame
    workload whose steady-state absorption Eq. 9 guarantees)."""
    return spec.in_hw[0] * spec.in_hw[1] * spec.d_in


def node_frame_cycles(plan, name: str) -> Fraction:
    """Cycles one frame occupies one node: frame features over installed
    capacity — the request-level service time of the node.

    A Multi-CLP replication lane (``plan.replications``) sees only 1 of
    every R admitted frames, so its per-admitted-frame service amortizes
    by R — which makes the request-level utilization of a lane exactly
    the DSE's ``demand/capacity`` at its dealt rate, same as every other
    node."""
    spec = plan.graph.spec(name)
    cyc = Fraction(_frame_features(spec)) / plan.impls[name].capacity
    r = lane_multiplicity(plan, name)
    return cyc / r if r > 1 else cyc


def slot_cycles(plan) -> Fraction:
    """Cycles per *tick*: one frame interval at the plan's input rate."""
    (src,) = plan.graph.input_nodes
    return Fraction(_frame_features(plan.graph.spec(src))) / plan.input_rate


@dataclasses.dataclass(frozen=True)
class StageRate:
    """Request-level service model of one pipeline stage."""

    stage: int
    nodes: Tuple[str, ...]
    bottleneck_node: str  # slowest node — sets the initiation interval
    svc_cycles: Fraction  # initiation interval: cycles per frame
    utilization: Fraction  # svc / slot == max node demand/capacity

    def occupancy_at(self, admitted_rate: Fraction) -> Fraction:
        """Busy fraction at an admitted rate (frames/tick) — the
        analytical occupancy bound the telemetry is asserted against."""
        return self.utilization * admitted_rate


def stage_rates(plan) -> List[StageRate]:
    """Per-stage initiation intervals from the plan's DSE capacities.

    A stage's nodes pipeline internally, so in steady state the stage
    initiates one frame per ``max`` over its nodes of the node's
    per-frame cycles.  The per-tick ``utilization`` equals
    ``max_n demand_n / capacity_n`` over the stage — the exact value
    ``core.schedule.simulate_graph`` measures per node, which is what
    ties this request-level model back to the pixel-level validator.
    """
    sp = plan.stage_plan
    if sp is None:
        raise ServingError(
            "GraphPlan has no stage partition — plan with "
            "plan_graph(..., n_stages=S) (S=1 is a valid single-chip "
            "pipeline)"
        )
    slot = slot_cycles(plan)
    rates: List[StageRate] = []
    for s in range(sp.n_stages):
        nodes = sp.stage_nodes(s)
        cycles = {n: node_frame_cycles(plan, n) for n in nodes}
        worst = max(nodes, key=lambda n: (cycles[n], n))
        svc = cycles[worst]
        rates.append(
            StageRate(
                stage=s,
                nodes=nodes,
                bottleneck_node=worst,
                svc_cycles=svc,
                utilization=svc / slot,
            )
        )
    return rates


def best_rate_frames(plan) -> Fraction:
    """Eq. 10 at the request level: the highest frame rate (frames/tick)
    every stage of the pipeline can absorb — the admission ceiling."""
    return min(Fraction(1) / sr.utilization for sr in stage_rates(plan))


def sustainable_rate_cycles(plan) -> Fraction:
    """BestRate in *frames per hardware cycle* — the plan-independent
    unit the downgrade ladder compares rungs in (each plan's tick is its
    own input rate, so frames/tick is not comparable across rungs)."""
    return best_rate_frames(plan) / slot_cycles(plan)


def queue_caps_batches(plan, microbatch: int) -> List[int]:
    """Capacity (in micro-batches) of each stage's input queue.

    Queue ``s`` holds the frames that crossed cut ``s-1 -> s``.  Every
    queue gets 2 batches (per-stage in-flight double buffering); the
    analytic cut buffers — ``core.stage_partition.stream_buffers``
    sized the crossing FIFOs in pixels — convert to extra whole frames
    at the cut's per-frame bit width.  Both sides of that division use
    the buffer's own ``link_dtype``: a narrower wire shrinks the FIFO
    and the frame it holds by the same factor, so quantizing a crossing
    changes the *bits* moved, not the frames parked.  Because the pixel
    bounds (join skew + link slack) are a small fraction of a frame,
    the extra term is almost always 0: the analytically sized queue IS
    the double buffer.  Queue 0 (admission) is the plain double buffer.
    """
    sp = plan.stage_plan
    if sp is None:
        raise ServingError(
            "GraphPlan has no stage partition — plan with "
            "plan_graph(..., n_stages=S)"
        )
    caps = [2] * sp.n_stages
    for s in range(1, sp.n_stages):
        buf_bits = 0
        frame_bits = 0
        for sb in plan.stream_bufs or []:
            if sb.src_stage < s <= sb.dst_stage:
                buf_bits += sb.bits
                src_spec = plan.graph.spec(sb.src)
                bpf = LINK_DTYPE_BITS[getattr(sb, "link_dtype", "int8")]
                frame_bits += (
                    bpf * sb.d * src_spec.out_hw[0] * src_spec.out_hw[1]
                )
        if frame_bits:
            caps[s] += (buf_bits // frame_bits) // microbatch
    return caps


# ==========================================================================
# Requests, micro-batches, per-stage runtime state
# ==========================================================================


@dataclasses.dataclass
class FrameRequest:
    """One frame moving through the serving engine (times in cycles)."""

    rid: int
    x: Optional[torch.Tensor]  # [H, W, C] on the device; None in timing-only runs
    t_submit: Fraction = Fraction(0)
    t_admit: Optional[Fraction] = None
    t_done: Optional[Fraction] = None
    t_shed: Optional[Fraction] = None  # SLA shed (never admitted)
    rung: int = 0  # ladder rung whose pipeline served the frame
    out: Optional[torch.Tensor] = None  # a row of its batch's output, on the device


@dataclasses.dataclass
class _Batch:
    bid: int
    frames: List[FrameRequest]
    rung: int = 0  # active rung at enqueue == rung that executes it
    # node name -> tensor, or an int8 link's {"__q__", "__s__"} payload,
    # kept whole under its producer's name (execute mode)
    boundary: Optional[Dict] = None


class _StageState:
    """Mutable per-stage bookkeeping of the event loop."""

    def __init__(self) -> None:
        self.batch: Optional[_Batch] = None
        self.busy_until: Optional[Fraction] = None
        self.busy_cycles = Fraction(0)
        self.stall_cycles = Fraction(0)  # done but blocked by downstream
        self.intervals: List[Tuple[Fraction, Fraction]] = []
        self.first_start: Optional[Fraction] = None
        self.last_done: Optional[Fraction] = None
        self.batches_served = 0
        self.frames_served = 0


@dataclasses.dataclass
class _Segment:
    """Telemetry of one plan-switch segment (archived at each switch)."""

    rung: int
    start: Fraction
    end: Fraction
    stages: List[_StageState]
    max_q: List[int]
    qev: List[List[Tuple[Fraction, int]]]


@dataclasses.dataclass
class _RunState:
    """Mutable state of one serving run (``begin`` .. ``finish``).

    Hoisted out of ``run``'s closure so the event loop is steppable:
    a multi-tenant scheduler (``fleet.scheduler``) drives several
    engines on one shared clock via ``advance`` / ``next_event``.
    ``queues``/``stages``/``qev``/``max_q`` always describe the *active*
    plan-switch segment; finished segments are archived in ``history``
    (empty unless a ``SwitchPolicy`` actually switched).
    """

    arrival_rate: Fraction
    horizon: Fraction
    max_ticks: int
    flush_cycles: Optional[Fraction]  # None = flush only at stream end
    n: int
    queues: List[deque]
    qev: List[List[Tuple[Fraction, int]]]
    max_q: List[int]
    stages: List[_StageState]
    pending: deque
    forming: List[FrameRequest]
    arr_idx: int = 0
    next_bid: int = 0
    completed: int = 0
    req_peak: int = 0
    t: Fraction = Fraction(0)
    # -- overload-policy state (inert without a policy) --------------------
    shed_rids: List[int] = dataclasses.field(default_factory=list)
    switch_target: Optional[int] = None  # draining toward this rung
    switches: List[Tuple[Fraction, int, int]] = dataclasses.field(
        default_factory=list
    )  # (t_cycles, from_rung, to_rung)
    history: List[_Segment] = dataclasses.field(default_factory=list)
    seg_start: Fraction = Fraction(0)


# ==========================================================================
# Reports
# ==========================================================================


@dataclasses.dataclass
class StageReport:
    """Telemetry + analytics for one stage over a serving run."""

    stage: int
    n_nodes: int
    bottleneck_node: str
    svc_cycles_per_frame: Fraction
    utilization: Fraction  # at the plan input rate (= svc/slot)
    analytic_occupancy: Fraction  # at the admitted rate
    measured_occupancy: float  # busy / (last_done - first_start)
    busy_cycles: Fraction
    stall_cycles: Fraction
    batches_served: int
    max_queue_batches: int
    queue_cap_batches: int
    rung: int = 0  # ladder rung this row belongs to (0 without switching)

    @property
    def stall_free(self) -> bool:
        return self.stall_cycles == 0

    @property
    def within_queue_bound(self) -> bool:
        return self.max_queue_batches <= self.queue_cap_batches


@dataclasses.dataclass
class ServeReport:
    """Deterministic tick-model results of one serving run.

    Latencies and the makespan are in *ticks* (frame slots at the
    plan's input rate); all aggregates are exact Fractions, floated
    only in the convenience percentile accessors.  With a
    ``SwitchPolicy``, ``stages`` holds one row per (segment, stage) in
    time order (``StageReport.rung`` names the segment's rung) and
    ``switches`` records every swap; without one, the layout is exactly
    the single-plan report it always was.
    """

    n_stages: int
    microbatch: int
    slot_cycles: Fraction
    best_rate: Fraction  # frames/tick (request-level Eq. 10)
    arrival_rate: Fraction  # frames/tick offered
    admitted_rate: Fraction  # min(arrival, best) — the Eq. 9 admission
    frames: int
    completed: int
    makespan_ticks: Fraction
    throughput: Fraction  # completed frames / makespan ticks
    latency_ticks: List[Fraction]  # submit -> done, in submission order
    service_latency_ticks: List[Fraction]  # admit -> done, same order
    stages: List[StageReport]
    request_queue_peak: int  # frames parked outside the pipeline
    queue_events: List[List[Tuple[Fraction, int]]]  # per stage (tick, depth)
    shed: int = 0  # frames dropped by the SLA policy
    shed_rids: Tuple[int, ...] = ()
    switches: Tuple[Tuple[Fraction, int, int], ...] = ()  # (tick, from, to)

    @property
    def stall_free(self) -> bool:
        return all(s.stall_free for s in self.stages)

    @property
    def within_queue_bounds(self) -> bool:
        return all(s.within_queue_bound for s in self.stages)

    @property
    def bottleneck_stage(self) -> int:
        return max(self.stages, key=lambda s: s.utilization).stage

    @property
    def shed_fraction(self) -> float:
        return self.shed / self.frames if self.frames else 0.0

    @staticmethod
    def _pct(values: Sequence[Fraction], q: float) -> float:
        if not values:
            return float("nan")
        ordered = sorted(values)
        idx = max(0, math.ceil(q * len(ordered)) - 1)
        return float(ordered[idx])

    def p50_latency(self) -> float:
        return self._pct(self.service_latency_ticks, 0.50)

    def p99_latency(self) -> float:
        return self._pct(self.service_latency_ticks, 0.99)

    def p50_total_latency(self) -> float:
        return self._pct(self.latency_ticks, 0.50)

    def p99_total_latency(self) -> float:
        return self._pct(self.latency_ticks, 0.99)

    def tick_occupancy(self, stage: int) -> List[float]:
        """Per-tick busy fraction of one stage — the occupancy trace the
        analytical bound is asserted against.  ``stage`` indexes
        ``self.stages`` rows (== pipeline stages without switching)."""
        n = max(1, math.ceil(self.makespan_ticks))
        out = [0.0] * n
        for start, end in self._stage_intervals[stage]:
            a, b = start / self.slot_cycles, end / self.slot_cycles
            for k in range(int(a), min(n, math.ceil(b))):
                lo, hi = max(a, Fraction(k)), min(b, Fraction(k + 1))
                if hi > lo:
                    out[k] += float(hi - lo)
        return out

    def tick_queue_depth(self, stage: int) -> List[int]:
        """Queue depth (micro-batches) sampled at every tick boundary."""
        n = max(1, math.ceil(self.makespan_ticks))
        events = self.queue_events[stage]
        out, depth, j = [], 0, 0
        for k in range(n):
            t = Fraction(k)
            while j < len(events) and events[j][0] <= t:
                depth = events[j][1]
                j += 1
            out.append(depth)
        return out

    def summary(self, label: str = "") -> ServeSummary:
        """The unified telemetry schema shared with ``FleetReport``
        (``serving.telemetry.ServeSummary``) — what the benchmark
        tables render instead of hand-flattening report attributes."""
        bott = self.stages[self.bottleneck_stage] if self.stages else None
        stall_ticks = (
            sum((s.stall_cycles for s in self.stages), Fraction(0))
            / self.slot_cycles
        )
        return ServeSummary(
            label=label,
            submitted=self.frames,
            completed=self.completed,
            shed=self.shed,
            switches=len(self.switches),
            throughput=float(self.throughput),
            p50_ticks=self.p50_latency(),
            p99_ticks=self.p99_latency(),
            p50_total_ticks=self.p50_total_latency(),
            p99_total_ticks=self.p99_total_latency(),
            stall_free=self.stall_free,
            stall_ticks=float(stall_ticks),
            within_queue_bounds=self.within_queue_bounds,
            request_queue_peak=self.request_queue_peak,
            bottleneck_stage=self.bottleneck_stage,
            bottleneck_occupancy=(
                bott.measured_occupancy if bott else 0.0
            ),
            bottleneck_bound=(
                float(bott.analytic_occupancy) if bott else 0.0
            ),
            max_queue=tuple(s.max_queue_batches for s in self.stages),
            queue_caps=tuple(s.queue_cap_batches for s in self.stages),
            # best_rate is the *fastest* rung's ceiling; a run that had
            # to shed or switch was by definition offered more than the
            # rung it was on could sustain
            overloaded=(
                self.arrival_rate > self.best_rate
                or self.shed > 0
                or bool(self.switches)
            ),
            metrics=(
                self.metrics.snapshot() if self.metrics is not None else None
            ),
        )

    def to_rows(self, prefix: str = "") -> List[Tuple[str, str]]:
        """(name, value) rows via the unified summary schema."""
        return self.summary(label=prefix).to_rows()

    # filled by the engine (not part of the dataclass repr/eq surface)
    _stage_intervals: List[List[Tuple[Fraction, Fraction]]] = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )
    # observability artifacts (None unless the run traced): the
    # obs.Tracer the engine recorded into and the run's
    # obs.MetricsRegistry (see docs/observability.md)
    trace: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    metrics: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False
    )


# ==========================================================================
# Ladder rungs (runtime view of one plan; rung 0 = the engine's base plan)
# ==========================================================================


class _Rung:
    """Runtime state of one ladder rung: the plan's request-level rates,
    queue caps, and (execute mode) the per-stage pipeline, built once."""

    def __init__(
        self,
        graph,
        params,
        plan,
        kernel_plan,
        *,
        config: ServeConfig,
        base_slot: Fraction,
        dtype: torch.dtype,
        device=None,
    ) -> None:
        self.graph = graph
        self.params = params
        self.plan = plan
        self.kernel_plan = kernel_plan
        self.rates = stage_rates(plan)  # raises without a stage partition
        self.n_stages = len(self.rates)
        self.caps = queue_caps_batches(plan, config.microbatch)
        # frames per base tick this rung sustains (cross-rung comparable)
        self.best_rate = sustainable_rate_cycles(plan) * base_slot
        self.bottleneck_svc = max(sr.svc_cycles for sr in self.rates)
        self.pipeline = None
        self._keep_after: List[set] = []
        if config.execute:
            # partition=plan (not plan.stage_plan): stage_functions
            # unwraps the GraphPlan itself, and link_quant=True needs it
            # to read the plan's link_dtype.
            self.pipeline = cnn.stage_functions(
                graph,
                partition=plan,
                impls=config.impls,
                plan=kernel_plan,
                overrides=config.overrides,
                dtype=dtype,
                check=config.check,
                link_quant=config.link_quant,
                # "devices": stage s on card s % n of the engine's pool,
                # each on a CUDA stream of its own
                placement=(True if config.execute == "devices" else None),
                device=device,
            )
            # after stage s, a batch only needs the tensors later stages
            # import (plus the graph output once the last stage ran)
            self._keep_after = self.pipeline.keep_after()


# ==========================================================================
# The engine
# ==========================================================================

_UNSET = object()


class CNNStreamEngine:
    """Streaming server for one planned CNN (see module docstring).

    ``plan`` must be a ``core.graph.GraphPlan`` carrying a stage
    partition (``plan_graph(..., n_stages=S)``; S=1 is the single-chip
    pipeline).  ``config`` is the unified ``serving.ServeConfig``
    (execution knobs + arrival source + flush/SLA/overload policy).
    ``config.kernel_plan`` optionally threads the rate-matched per-node
    kernel tiling (pass ``plan.kernel_plan(batch=microbatch)`` so the
    pixel tiles are pinned to the micro-batch — the engine checks the pin
    matches).  ``execute=False`` runs the deterministic tick model alone
    (no tensors, no outputs); ``execute=True`` runs every admitted
    micro-batch through the stages on ``device``, which resolves through
    ``models.registry.resolve_device``: ``None`` is the card, and the
    CPU only when the caller asks for it (``device="cpu"``).  A
    timing-only engine touches no device and resolves none.

    With ``config.overload = SwitchPolicy(ladder)`` the engine serves
    through whichever ladder rung matches the observed arrival rate:
    ``plan`` must be the ladder's base rung (rung 0, unreplicated), and
    each further rung gets its own pipeline, queue caps, and (when the
    base had one) batch-pinned kernel plan.  Switches happen only at
    micro-batch boundaries with the pipeline fully drained.
    """

    def __init__(
        self,
        graph,
        params,
        plan,
        config: Optional[ServeConfig] = None,
        *,
        device=None,
    ) -> None:
        if config is None:
            config = ServeConfig()
        if config.microbatch < 1:
            raise ServingError(
                f"microbatch must be >= 1, got {config.microbatch}"
            )
        if config.kernel_plan is not None:
            pinned = {
                p.batch
                for p in config.kernel_plan.values()
                if p.batch is not None
            }
            if pinned and pinned != {config.microbatch}:
                raise ServingError(
                    f"kernel plan pinned to batch {sorted(pinned)} but the "
                    f"engine micro-batches {config.microbatch} frames — "
                    f"build it with plan.kernel_plan("
                    f"batch={config.microbatch})"
                )
        self.config = config
        self.graph = graph
        self.params = params
        self.plan = plan
        self.microbatch = config.microbatch
        self.dtype = config.dtype if config.dtype is not None else torch.float32
        if config.execute not in (True, False, "devices"):
            raise ServingError(
                f"execute={config.execute!r} — expected True, False, or "
                '"devices" (per-stage device placement)'
            )
        self.execute = config.execute
        self.device = None
        if config.execute:
            from repro_torch.models.registry import resolve_device

            self.device = resolve_device(device)
        self.slot = slot_cycles(plan)
        self._shed, self._switch = self._resolve_policy(config.overload)
        self._rungs = self._build_rungs()
        self._active = 0
        self._requests: List[FrameRequest] = []
        # observability (docs/observability.md): None when off — every
        # tick-domain emission below is guarded on it, so an untraced
        # run is event-identical to pre-obs engines; the host spans
        # (obs.trace.host_span) go into it in an executed run only, so a
        # timing-only trace stays the tick model alone
        self._tracer = resolve_tracer(config.trace)
        self._host_tracer = self._tracer if config.execute else None
        self._trace_pid = config.trace_pid
        self._trace_chips = dict(config.trace_chips or {})
        self.metrics: Optional[MetricsRegistry] = None
        if self._tracer is not None and config.execute:
            # transfer_bytes{edge,dtype}: observe the placed cut
            # crossings (every pipeline is this engine's own; an
            # unplaced pipeline moves nothing and never calls the hook)
            for rung in self._rungs:
                if rung.pipeline is not None:
                    rung.pipeline.observe(self._on_transfer)

    def _resolve_policy(self, overload):
        if overload is None:
            return None, None
        if isinstance(overload, ShedPolicy):
            return overload, None
        if isinstance(overload, SwitchPolicy):
            return None, overload
        raise ServingError(
            f"unknown overload policy {type(overload).__name__} — expected "
            "serving.overload.ShedPolicy or SwitchPolicy"
        )

    def _build_rungs(self) -> List[_Rung]:
        cfg = self.config
        base = _Rung(
            self.graph,
            self.params,
            self.plan,
            cfg.kernel_plan,
            config=cfg,
            base_slot=self.slot,
            dtype=self.dtype,
            device=self.device,
        )
        if self._switch is None:
            return [base]
        ladder = self._switch.ladder
        if ladder.rungs[0].plan is not self.plan:
            raise ServingError(
                "with a SwitchPolicy the engine's plan must be the ladder's "
                "base rung — build the engine from ladder.rungs[0].plan"
            )
        if self.plan.replications:
            raise ServingError(
                "the switch ladder's base rung must be unreplicated (the "
                "engine derives replication-lane params per rung itself)"
            )
        rungs = [base]
        for lr in ladder.rungs[1:]:
            rplan = lr.plan
            rparams = self.params
            if self.execute and rplan.replications:
                rparams = replicate_params(rparams, rplan.replications)
            rkp = None
            if cfg.kernel_plan is not None:
                rkp = rplan.kernel_plan(batch=cfg.microbatch)
            rungs.append(
                _Rung(
                    rplan.graph,
                    rparams,
                    rplan,
                    rkp,
                    config=cfg,
                    base_slot=self.slot,
                    dtype=self.dtype,
                    device=self.device,
                )
            )
        return rungs

    # -- active-rung views (the single-rung attribute surface) -------------

    @property
    def rates(self) -> List[StageRate]:
        return self._rungs[self._active].rates

    @property
    def n_stages(self) -> int:
        return self._rungs[self._active].n_stages

    @property
    def caps(self) -> List[int]:
        return self._rungs[self._active].caps

    @property
    def best_rate(self) -> Fraction:
        """Sustainable frames per (base) tick of the *active* rung."""
        return self._rungs[self._active].best_rate

    @property
    def pipeline(self):
        return self._rungs[self._active].pipeline

    @property
    def active_rung(self) -> int:
        return self._active

    # -- request intake ----------------------------------------------------

    def submit(self, x, rid: Optional[int] = None) -> int:
        """Queue one frame ([H, W, C], a numpy array or a tensor, moved
        to the engine's device; None in a timing-only run); arrival times
        are assigned by ``run`` from its arrival source.  Returns the
        request id."""
        rid = len(self._requests) if rid is None else rid
        if x is not None and self.execute:
            x = torch.as_tensor(x).to(self.device)
        self._requests.append(FrameRequest(rid=rid, x=x))
        return rid

    def submit_all(self, frames) -> None:
        """Queue ``frames``: an [N, H, W, C] array or tensor goes to the
        engine's device in one copy, each request holding a row of it;
        an iterable of [H, W, C] frames is submitted frame by frame."""
        if self.execute and hasattr(frames, "shape") and len(frames.shape) == 4:
            frames = torch.as_tensor(frames).to(self.device)
        for f in frames:
            self.submit(f)

    # -- execution helpers -------------------------------------------------

    def _start_batch_exec(self, s: int, batch: _Batch) -> None:
        if not self.execute:
            return
        # host span "exec" around the stage's dispatch: on the card the
        # kernels are queued, not run, within it, so it times the host's
        # side of the stage, not its execution
        with host_span("exec", self._host_tracer, pid=self._trace_pid,
                       tid=f"stage{s}", bid=batch.bid, frames=len(batch.frames)):
            rung = self._rungs[batch.rung]
            if s == 0:
                # the batch's rows gathered on the device, zero-padded there
                # to the pinned batch (the reference's np.zeros_like pad)
                xs = [f.x for f in batch.frames]
                pad = self.microbatch - len(xs)
                if pad:
                    xs = xs + [torch.zeros_like(xs[0])] * pad
                x = torch.stack(xs).to(self.dtype)
                batch.boundary = {}
                rung.pipeline.run_stage(0, rung.params, batch.boundary, x)
            else:
                rung.pipeline.run_stage(s, rung.params, batch.boundary)
            # an int8 crossing is one {"__q__", "__s__"} value under its
            # producer's name, so pruning by name keeps each scale with its
            # payload
            keep = rung._keep_after[s]
            for k in list(batch.boundary):
                if k not in keep:
                    del batch.boundary[k]

    def _finish_batch(self, batch: _Batch, t: Fraction) -> None:
        out = None
        if self.execute:
            # the output stays on the device: each frame keeps a view of
            # its row, and nothing is copied to the host per batch (a
            # placed pipeline keeps its memory for the caller's stream,
            # which ``outputs()`` makes wait for the stages)
            rung = self._rungs[batch.rung]
            out = rung.pipeline.keep_for_caller(batch.boundary[rung.pipeline.out_name])
        for i, f in enumerate(batch.frames):
            f.t_done = t
            f.rung = batch.rung
            if out is not None:
                f.out = out[i]

    # -- observability (opt-in; every call guarded on self._tracer) --------
    #
    # The tracer only ever APPENDS: nothing here reads back into the
    # event loop, so a traced run is event-identical to an untraced one
    # (tests/obs/test_audit.py pins this).  All tick-domain
    # timestamps are emitted in ticks (cycles / slot) on the exact
    # rational clock; pid is the engine label (tenant name in a fleet),
    # tid is "stage{s}".

    def _begin_trace(self, offered: Fraction, n: int) -> None:
        """Fresh run: new metrics registry, plan metadata (the analytic
        model ``obs.audit`` replays the trace against), submit instants."""
        tr, pid = self._tracer, self._trace_pid
        self.metrics = MetricsRegistry()
        tr.metadata(
            pid,
            {
                "slot_cycles": _fstr(self.slot),
                "arrival_rate": _fstr(offered),
                "microbatch": self.microbatch,
                "frames": n,
                "rungs": [
                    {
                        "best_rate": _fstr(r.best_rate),
                        "caps": [int(c) for c in r.caps],
                        "utilization": [_fstr(sr.utilization) for sr in r.rates],
                        "bottleneck": max(
                            range(r.n_stages),
                            key=lambda s: r.rates[s].utilization,
                        ),
                    }
                    for r in self._rungs
                ],
            },
        )
        self.metrics.counter("frames_submitted").inc(n)
        for r in self._requests:
            tr.instant("submit", r.t_submit / self.slot, pid=pid, rid=r.rid)

    def _trace_queue(self, s: int, depth: int, now, seg: int) -> None:
        self._tracer.counter(
            "queue_depth",
            depth,
            now / self.slot,
            pid=self._trace_pid,
            tid=f"stage{s}",
            seg=seg,
        )
        self.metrics.gauge("queue_depth", stage=s).set(depth)

    def _trace_start(self, s: int, batch: _Batch, now, svc, seg: int) -> None:
        """One busy span per batch start — both ends at once: the tick
        model is deterministic, so the end (now + svc) is known here."""
        slot = self.slot
        args = dict(
            bid=batch.bid,
            seg=seg,
            rung=batch.rung,
            frames=len(batch.frames),
            rids=tuple(f.rid for f in batch.frames),
        )
        chip = self._trace_chips.get(s)
        if chip is not None:
            args["chip"] = chip
        self._tracer.span(
            "stage",
            now / slot,
            (now + svc) / slot,
            pid=self._trace_pid,
            tid=f"stage{s}",
            **args,
        )
        self.metrics.counter("stage_busy_ticks", stage=s).inc(svc / slot)

    def _trace_blocked(self, s: int, st: _StageState, now, seg: int) -> None:
        """Departure was held past service end (downstream full)."""
        slot = self.slot
        self._tracer.span(
            "blocked",
            st.busy_until / slot,
            now / slot,
            pid=self._trace_pid,
            tid=f"stage{s}",
            bid=st.batch.bid,
            seg=seg,
        )
        self.metrics.counter("stage_stall_ticks", stage=s).inc(
            (now - st.busy_until) / slot
        )

    def _trace_done(self, batch: _Batch, now, seg: int) -> None:
        tr, pid, slot = self._tracer, self._trace_pid, self.slot
        t = now / slot
        tr.instant("merge", t, pid=pid, bid=batch.bid, seg=seg)
        m = self.metrics
        m.counter("frames_completed").inc(len(batch.frames))
        lat = m.histogram("latency_ticks")
        svc_lat = m.histogram("service_latency_ticks")
        for f in batch.frames:
            tr.instant("done", t, pid=pid, rid=f.rid, seg=seg)
            lat.observe((now - f.t_submit) / slot)
            svc_lat.observe((now - f.t_admit) / slot)

    def _trace_admit(self, req: FrameRequest, now, seg: int) -> None:
        self._tracer.instant(
            "admit", now / self.slot, pid=self._trace_pid, rid=req.rid, seg=seg
        )
        self.metrics.counter("frames_admitted").inc()

    def _trace_shed(self, req: FrameRequest, now) -> None:
        self._tracer.instant("shed", now / self.slot, pid=self._trace_pid, rid=req.rid)
        self.metrics.counter("shed_total").inc()

    def _on_transfer(self, *, stage, name, nbytes, dtype, donated) -> None:
        """StagePipeline.observe hook: bytes crossing a placed cut —
        the measured twin of the plan's priced StreamBuffer widths."""
        if self.metrics is None:
            return  # transfer outside a run (warmup)
        self.metrics.counter(
            "transfer_bytes", edge=f"{name}->s{stage}", dtype=dtype
        ).inc(nbytes)

    # -- the event loop ----------------------------------------------------
    #
    # The loop is steppable: ``begin`` installs a fresh ``_RunState``,
    # ``advance(t)`` settles the engine at clock time t, ``next_event(t)``
    # names the next time anything can happen, and ``finish`` builds the
    # report once ``finished``.  ``run`` is the single-engine driver; a
    # fleet scheduler drives several engines' states on one shared
    # rational clock with exactly these four calls.

    def begin(
        self,
        *,
        arrival_rate=None,
        max_ticks: Optional[int] = None,
        flush_after_ticks=_UNSET,
    ) -> _RunState:
        """Install a fresh run over the submitted frames.

        The arrival source, run bound, and flush knob default to the
        engine's ``ServeConfig``; the keyword arguments override them
        per run (the pre-ServeConfig calling convention).

        ``flush_after_ticks`` bounds how long a partial micro-batch may
        wait for more arrivals: once the *oldest* admitted frame has been
        forming for that many ticks, the partial batch is flushed into
        the pipeline (padded at execution, exactly like the end-of-stream
        flush).  ``None`` keeps the original behavior — partial batches
        flush only when the stream ends.
        """
        cfg = self.config
        arrival = cfg.arrival if arrival_rate is None else arrival_rate
        max_ticks = cfg.max_ticks if max_ticks is None else max_ticks
        flush_after_ticks = (
            cfg.flush_after_ticks
            if flush_after_ticks is _UNSET
            else flush_after_ticks
        )
        flush_cycles = None
        if flush_after_ticks is not None:
            flush_cycles = Fraction(flush_after_ticks) * self.slot
            if flush_cycles < 0:
                raise ServingError(
                    f"flush_after_ticks must be >= 0, got {flush_after_ticks}"
                )
        reqs = self._requests
        n = len(reqs)
        if n == 0:
            raise ServingError("no frames submitted")
        if isinstance(arrival, ArrivalProcess):
            ticks = arrival.times(n)
            if any(b < a for a, b in zip(ticks, ticks[1:])) or ticks[0] < 0:
                raise ServingError(
                    f"{arrival.name}: arrival times must be nondecreasing "
                    "and >= 0"
                )
            for r, tk in zip(reqs, ticks):
                r.t_submit = tk * self.slot
            offered = arrival.mean_rate(n)
        else:
            rate = Fraction(arrival)
            if rate <= 0:
                raise ServingError(f"arrival_rate must be > 0, got {rate}")
            inter = self.slot / rate
            for i, r in enumerate(reqs):
                r.t_submit = i * inter
            offered = rate
        self._active = 0
        self._rt = _RunState(
            arrival_rate=offered,
            horizon=self.slot * max_ticks,
            max_ticks=max_ticks,
            flush_cycles=flush_cycles,
            n=n,
            queues=[deque() for _ in range(self.n_stages)],
            qev=[[] for _ in range(self.n_stages)],
            max_q=[0] * self.n_stages,
            stages=[_StageState() for _ in range(self.n_stages)],
            pending=deque(),
            forming=[],
        )
        if self._tracer is not None:
            self._begin_trace(offered, n)
        return self._rt

    @property
    def finished(self) -> bool:
        """Every submitted frame served or shed (begin .. finish)."""
        rt = self._rt
        return rt.completed + len(rt.shed_rids) >= rt.n

    def advance(self, t: Fraction) -> None:
        """Move the run's clock to ``t`` and settle every consequence."""
        rt = self._rt
        rt.t = t
        self._settle(t)

    def next_event(self, after: Fraction) -> Optional[Fraction]:
        """Earliest future time anything can happen, or None (deadlock)."""
        rt = self._rt
        cands = [self._requests[rt.arr_idx].t_submit] if rt.arr_idx < rt.n else []
        # a blocked stage (service done, downstream full) has no future
        # event of its own — the downstream completion that unblocks it
        # is in this list, and the settle re-examines it.
        cands += [
            st.busy_until
            for st in rt.stages
            if st.busy_until is not None and st.busy_until > after
        ]
        if rt.flush_cycles is not None and rt.forming:
            cands.append(rt.forming[0].t_admit + rt.flush_cycles)
        cands = [c for c in cands if c > after]
        return min(cands) if cands else None

    def finish(self) -> ServeReport:
        """Assemble the report once the run has drained."""
        rt = self._rt
        if not self.finished:
            raise ServingError(
                f"run not drained: {rt.completed}/{rt.n} frames served"
            )
        return self._report(rt)

    # -- overload-policy hooks ---------------------------------------------

    def _frames_in_flight(self, rt: _RunState) -> int:
        """Frames admitted but not yet served (forming + queued + in a
        stage) — the backlog ahead of the next admission."""
        n = len(rt.forming)
        n += sum(len(b.frames) for q in rt.queues for b in q)
        n += sum(
            len(st.batch.frames) for st in rt.stages if st.batch is not None
        )
        return n

    def _past_deadline(self, rt: _RunState, req: FrameRequest, now) -> bool:
        """SLA projection for the oldest pending frame: its completion,
        were it admitted now behind the current backlog, in submit-
        relative ticks vs the policy deadline.  The projection uses the
        active rung's bottleneck service time — the pace the pipeline
        provably sustains (Eq. 10), so the estimate is exact in steady
        state and conservative during drains."""
        svc = self._rungs[self._active].bottleneck_svc
        wait = (self._frames_in_flight(rt) + 1) * svc
        projected = now + wait - req.t_submit
        return projected > self._shed.deadline_ticks * self.slot

    def _recent_rate(self, rt: _RunState, now) -> Fraction:
        """Offered rate (frames/base tick) over the trailing decision
        window — arrivals are scanned backward from the admission index,
        so the estimate is exact, deterministic, and O(window)."""
        window = self._switch.window_ticks * self.slot
        lo = now - window
        cnt = 0
        i = rt.arr_idx - 1
        while i >= 0 and self._requests[i].t_submit > lo:
            cnt += 1
            i -= 1
        return Fraction(cnt) / self._switch.window_ticks

    def _pipeline_drained(self, rt: _RunState) -> bool:
        return all(st.batch is None for st in rt.stages) and all(
            not q for q in rt.queues
        )

    def _perform_switch(self, rt: _RunState, now) -> None:
        """Swap the active rung at a fully drained micro-batch boundary:
        archive the finished segment's telemetry, install the new rung's
        queues/stage states, and re-assert the continuous-flow invariant
        (the new rung is a feasible Eq. 9 plan and starts stall-free)."""
        to = rt.switch_target
        rt.history.append(
            _Segment(
                rung=self._active,
                start=rt.seg_start,
                end=now,
                stages=rt.stages,
                max_q=rt.max_q,
                qev=rt.qev,
            )
        )
        rt.switches.append((now, self._active, to))
        if self._tracer is not None:
            self._tracer.instant(
                "switch",
                now / self.slot,
                pid=self._trace_pid,
                from_rung=self._active,
                to_rung=to,
                seg=len(rt.history),
            )
            self.metrics.counter("plan_switches").inc()
        self._active = to
        rung = self._rungs[to]
        if not rung.plan.continuous_flow:
            raise ServingError(
                f"switch to rung {to} violates continuous flow: "
                f"{rung.plan.infeasible_nodes}"
            )
        rt.stages = [_StageState() for _ in range(rung.n_stages)]
        rt.queues = [deque() for _ in range(rung.n_stages)]
        rt.qev = [[] for _ in range(rung.n_stages)]
        rt.max_q = [0] * rung.n_stages
        rt.seg_start = now
        rt.switch_target = None

    def _settle(self, now: Fraction) -> None:
        rt = self._rt
        reqs = self._requests
        tr = self._tracer

        def enqueue(s: int, batch: _Batch) -> None:
            rt.queues[s].append(batch)
            rt.qev[s].append((now / self.slot, len(rt.queues[s])))
            rt.max_q[s] = max(rt.max_q[s], len(rt.queues[s]))
            if tr is not None:
                self._trace_queue(s, len(rt.queues[s]), now, len(rt.history))

        def dequeue(s: int) -> _Batch:
            batch = rt.queues[s].popleft()
            rt.qev[s].append((now / self.slot, len(rt.queues[s])))
            if tr is not None:
                self._trace_queue(s, len(rt.queues[s]), now, len(rt.history))
            return batch

        progress = True
        while progress:
            progress = False
            n_stages = self.n_stages
            # 1. completions + pushes, downstream first (drain first)
            for s in range(n_stages - 1, -1, -1):
                st = rt.stages[s]
                if st.batch is None or st.busy_until > now:
                    continue
                if s == n_stages - 1:
                    self._finish_batch(st.batch, now)
                    rt.completed += len(st.batch.frames)
                    if tr is not None:
                        self._trace_done(st.batch, now, len(rt.history))
                elif len(rt.queues[s + 1]) < self.caps[s + 1]:
                    enqueue(s + 1, st.batch)
                else:
                    continue  # blocked: downstream full (stall)
                if tr is not None and now > st.busy_until:
                    self._trace_blocked(s, st, now, len(rt.history))
                st.stall_cycles += now - st.busy_until
                st.last_done = now
                st.batch = None
                st.busy_until = None
                progress = True
            # 2. starts (a freed stage pulls from its queue)
            for s in range(n_stages - 1, -1, -1):
                st = rt.stages[s]
                if st.batch is not None or not rt.queues[s]:
                    continue
                batch = dequeue(s)
                self._start_batch_exec(s, batch)
                svc = self.rates[s].svc_cycles * len(batch.frames)
                st.batch = batch
                st.busy_until = now + svc
                st.busy_cycles += svc
                st.intervals.append((now, now + svc))
                if tr is not None:
                    self._trace_start(s, batch, now, svc, len(rt.history))
                if st.first_start is None:
                    st.first_start = now
                st.batches_served += 1
                st.frames_served += len(batch.frames)
                progress = True
            # 3. arrivals into the request queue
            while rt.arr_idx < rt.n and reqs[rt.arr_idx].t_submit <= now:
                rt.pending.append(reqs[rt.arr_idx])
                rt.arr_idx += 1
                progress = True
            rt.req_peak = max(rt.req_peak, len(rt.pending) + len(rt.forming))
            # 3a. SLA shedding: drop pending-head frames whose projected
            # completion misses the deadline (FIFO pops — survivors are
            # never reordered; shed frames are never admitted)
            if self._shed is not None:
                while rt.pending and self._past_deadline(
                    rt, rt.pending[0], now
                ):
                    req = rt.pending.popleft()
                    req.t_shed = now
                    rt.shed_rids.append(req.rid)
                    if tr is not None:
                        self._trace_shed(req, now)
                    progress = True
            # 3b. plan switching: pick the ladder rung for the observed
            # arrival rate; a decided switch first drains the pipeline
            # (admission below holds new batches back), then swaps at
            # the empty micro-batch boundary
            if self._switch is not None:
                if rt.switch_target is None:
                    est = self._recent_rate(rt, now) / self.slot
                    target = self._switch.target(est, self._active)
                    if target != self._active:
                        rt.switch_target = target
                if rt.switch_target is not None and self._pipeline_drained(rt):
                    self._perform_switch(rt, now)
                    progress = True
            draining = rt.switch_target is not None
            # 4. admission (Eq. 9 gate: pipeline slack at the gate)
            while rt.pending or rt.forming:
                if len(rt.forming) == self.microbatch:
                    if draining or len(rt.queues[0]) >= self.caps[0]:
                        break  # backpressured (or draining for a switch)
                    enqueue(0, _Batch(rt.next_bid, rt.forming, self._active))
                    rt.next_bid += 1
                    rt.forming = []
                    progress = True
                elif rt.pending:
                    req = rt.pending.popleft()
                    req.t_admit = now
                    rt.forming.append(req)
                    if tr is not None:
                        self._trace_admit(req, now, len(rt.history))
                    progress = True
                else:
                    break
            # 5. flush the partial batch: at end of stream, or once its
            # oldest frame has waited flush_after_ticks (straggler bound)
            flush_due = (
                rt.flush_cycles is not None
                and rt.forming
                and now - rt.forming[0].t_admit >= rt.flush_cycles
            )
            if (
                rt.forming
                and not draining
                and len(rt.queues[0]) < self.caps[0]
                and (flush_due or (rt.arr_idx == rt.n and not rt.pending))
            ):
                if tr is not None:
                    self._tracer.instant(
                        "flush",
                        now / self.slot,
                        pid=self._trace_pid,
                        frames=len(rt.forming),
                        reason="straggler" if flush_due else "stream_end",
                    )
                enqueue(0, _Batch(rt.next_bid, rt.forming, self._active))
                rt.next_bid += 1
                rt.forming = []
                progress = True

    def run(
        self,
        *,
        arrival_rate=None,
        max_ticks: Optional[int] = None,
        flush_after_ticks=_UNSET,
    ) -> ServeReport:
        """Serve every submitted frame; return the telemetry report.

        With no arguments the run uses the engine's ``ServeConfig``
        (arrival source, run bound, flush knob); the keyword arguments
        override it per run.  ``arrival_rate`` is a constant rate in
        frames/tick (1 = frames arriving exactly at the plan's input
        rate; ``best_rate`` is the sustainable ceiling) or any
        ``ArrivalProcess``.  The run is a deterministic discrete-event
        loop on an exact rational clock; it ends when the pipeline
        drains (every frame served or shed).
        """
        with host_span("stream.loop", self._host_tracer, pid=self._trace_pid,
                       tid="host"):
            rt = self.begin(
                arrival_rate=arrival_rate,
                max_ticks=max_ticks,
                flush_after_ticks=flush_after_ticks,
            )
            while True:
                self.advance(rt.t)
                if self.finished:
                    break
                nxt = self.next_event(rt.t)
                if nxt is None:
                    raise ServingError(
                        f"serving deadlock at tick {float(rt.t / self.slot):.1f} "
                        f"({rt.completed}/{rt.n} frames served)"
                    )
                if nxt > rt.horizon:
                    raise ServingError(
                        f"exceeded max_ticks={rt.max_ticks} with {rt.completed}/"
                        f"{rt.n} frames served"
                    )
                rt.t = nxt
            return self.finish()

    # -- report assembly ---------------------------------------------------

    def _report(self, rt: _RunState) -> ServeReport:
        segments = rt.history + [
            _Segment(
                rung=self._active,
                start=rt.seg_start,
                end=rt.t,
                stages=rt.stages,
                max_q=rt.max_q,
                qev=rt.qev,
            )
        ]
        best = max(self._rungs[seg.rung].best_rate for seg in segments)
        admitted = min(rt.arrival_rate, best)
        reports: List[StageReport] = []
        intervals: List[List[Tuple[Fraction, Fraction]]] = []
        qev_rows: List[List[Tuple[Fraction, int]]] = []
        for seg in segments:
            rung = self._rungs[seg.rung]
            # within a segment admission was gated at *this* rung's
            # ceiling, so its analytic occupancy is bounded by it even
            # when a later (faster) rung lifts the run-level admitted
            # rate above this rung's capacity
            seg_admitted = min(rt.arrival_rate, rung.best_rate)
            for s, (sr, st) in enumerate(zip(rung.rates, seg.stages)):
                span = Fraction(0)
                if st.first_start is not None and st.last_done is not None:
                    span = st.last_done - st.first_start
                occ = float(st.busy_cycles / span) if span else 0.0
                reports.append(
                    StageReport(
                        stage=s,
                        n_nodes=len(sr.nodes),
                        bottleneck_node=sr.bottleneck_node,
                        svc_cycles_per_frame=sr.svc_cycles,
                        utilization=sr.utilization,
                        analytic_occupancy=sr.occupancy_at(seg_admitted),
                        measured_occupancy=occ,
                        busy_cycles=st.busy_cycles,
                        stall_cycles=st.stall_cycles,
                        batches_served=st.batches_served,
                        max_queue_batches=seg.max_q[s],
                        queue_cap_batches=rung.caps[s],
                        rung=seg.rung,
                    )
                )
                intervals.append(st.intervals)
                qev_rows.append(seg.qev[s])
        makespan = rt.t / self.slot
        done = [r for r in self._requests if r.t_done is not None]
        report = ServeReport(
            n_stages=self._rungs[0].n_stages,
            microbatch=self.microbatch,
            slot_cycles=self.slot,
            best_rate=best,
            arrival_rate=rt.arrival_rate,
            admitted_rate=admitted,
            frames=len(self._requests),
            completed=len(done),
            makespan_ticks=makespan,
            throughput=Fraction(len(done)) / makespan if makespan else Fraction(0),
            latency_ticks=[(r.t_done - r.t_submit) / self.slot for r in done],
            service_latency_ticks=[
                (r.t_done - r.t_admit) / self.slot for r in done
            ],
            stages=reports,
            request_queue_peak=rt.req_peak,
            queue_events=qev_rows,
            shed=len(rt.shed_rids),
            shed_rids=tuple(rt.shed_rids),
            switches=tuple(
                (t / self.slot, a, b) for t, a, b in rt.switches
            ),
        )
        report._stage_intervals = intervals
        report.trace = self._tracer
        report.metrics = self.metrics
        return report

    # -- results -----------------------------------------------------------

    def outputs(self) -> torch.Tensor:
        """Served outputs stacked in request order into one tensor on the
        engine's device (execute mode only); SLA-shed frames are skipped
        — ``ServeReport.shed_rids`` names them."""
        if not self.execute:
            raise ServingError("engine ran with execute=False — no outputs")
        missing = [
            r.rid
            for r in self._requests
            if r.out is None and r.t_shed is None
        ]
        if missing:
            raise ServingError(f"frames not served yet: {missing[:5]}")
        with host_span("stream.outputs", self._host_tracer, pid=self._trace_pid,
                       tid="host"):
            ordered = sorted(
                (r for r in self._requests if r.out is not None),
                key=lambda r: r.rid,
            )
            if not ordered:
                raise ServingError("every frame was shed — no outputs")
            for rung in self._rungs:
                rung.pipeline.join()
            return torch.stack([r.out for r in ordered])


# ==========================================================================
# One-call convenience (what ``registry.CNNApi.serve`` wires up)
# ==========================================================================


def serve_frames(
    graph,
    params,
    frames,
    *,
    input_rate,
    n_stages: int = 1,
    config: Optional[ServeConfig] = None,
    arrival_rate=None,
    microbatch: Optional[int] = None,
    rate_matched: bool = False,
    dtype=None,
    check: Optional[bool] = None,
    execute=None,
    max_ticks: Optional[int] = None,
    flush_after_ticks=_UNSET,
    plan_cache: Optional[dict] = None,
    device=None,
    **dse_kwargs,
):
    """Plan, stream, and serve ``frames`` through a staged pipeline.

    Runs the DAG DSE at ``input_rate`` with an ``n_stages`` partition,
    optionally lowers the rate-matched per-node kernel plan pinned to
    the micro-batch (``rate_matched=True``), and serves every frame
    from the configured arrival source on ``device`` (the card unless
    the caller asks for the CPU).  ``config`` is the unified
    ``serving.ServeConfig``; the individual keyword arguments override
    its fields.  Returns ``(outputs, report)``: ``outputs`` is one
    tensor on the device, in rid order, or None when ``execute=False``
    (timing model only).  A ``replicate=`` kwarg flows through to
    ``plan_graph`` — the engine then runs the rewritten graph with the
    hot node's params aliased onto the lanes.  ``link_dtype=`` /
    ``bram_budget=`` flow through the same way; pair them with
    ``config.link_quant`` to make the executed boundaries match the
    priced wire format.

    ``plan_cache`` memoizes the DSE result per (graph, rate, stages,
    kwargs), the graph by identity (``CNNApi.serve`` passes its
    registry's ``plans`` dict, whose graphs it memoizes per config).

    Host spans (``obs.trace.host_span``): ``stream.serve`` around the
    call, ``stream.setup`` around the run's set-up split into
    ``stream.plan`` (the cache lookup or the DSE, replication, the kernel
    plan), ``stream.build`` (the engine) and ``stream.submit``; inside
    the engine ``stream.loop``, ``exec`` and ``stream.outputs``.  An
    executed run with ``config.trace`` records them in its tracer too,
    under ``trace_pid``, on track ``host``.
    """
    from repro_torch.core.graph import plan_graph

    cfg = config if config is not None else ServeConfig()
    overrides = {
        "microbatch": microbatch,
        "dtype": dtype,
        "check": check,
        "execute": execute,
        "arrival": arrival_rate,
        "max_ticks": max_ticks,
    }
    overrides = {k: v for k, v in overrides.items() if v is not None}
    if flush_after_ticks is not _UNSET:
        overrides["flush_after_ticks"] = flush_after_ticks
    if overrides:
        cfg = cfg.with_(**overrides)

    tracer = resolve_tracer(cfg.trace)
    if cfg.trace is True:  # the engine records into the same tracer
        cfg = cfg.with_(trace=tracer)
    span = functools.partial(
        host_span, tracer=tracer if cfg.execute else None, pid=cfg.trace_pid,
        tid="host")
    n_frames = int(frames) if isinstance(frames, int) else len(frames)

    with span("stream.serve", frames=n_frames):
        with span("stream.setup"):
            with span("stream.plan"):
                plan = key = None
                if plan_cache is not None:
                    try:
                        key = (graph, Fraction(input_rate), n_stages,
                               tuple(sorted(dse_kwargs.items())))
                        plan = plan_cache.get(key)
                    except TypeError:  # unhashable rate / kwargs: plan fresh
                        key = None
                if plan is None:
                    plan = plan_graph(graph, input_rate, n_stages=n_stages,
                                      **dse_kwargs)
                    if key is not None:
                        plan_cache[key] = plan
                if plan.replications:
                    graph = plan.graph
                    params = replicate_params(params, plan.replications)
                if rate_matched:
                    cfg = cfg.with_(
                        kernel_plan=plan.kernel_plan(batch=cfg.microbatch))
            with span("stream.build"):
                engine = CNNStreamEngine(graph, params, plan, cfg, device=device)
            with span("stream.submit"):
                if cfg.execute:
                    engine.submit_all(frames)
                else:
                    for _ in range(n_frames):
                        engine.submit(None)
        report = engine.run()
        outputs = engine.outputs() if cfg.execute else None
    return outputs, report
