"""Multi-tenant serving loop over a packed chip pool.

The port's own copy of the JAX package's ``fleet/scheduler.py``.  One
``serving.CNNStreamEngine`` per tenant — built from the tenant's chosen
``PoolPlan`` candidate — pumped on a *shared* deterministic rational
clock.  The engines expose a steppable event loop (``begin`` /
``advance`` / ``next_event`` / ``finish``); the scheduler is the
textbook multi-queue discrete-event driver on top:

    t = 0
    while any tenant unfinished:
        advance every unfinished tenant to t (settle all consequences)
        t = min over unfinished tenants of next_event(t)

Tenants share the clock but **not** chips (the pool packer assigns one
stage per chip, exclusively), so the fleet run of a tenant is
event-for-event identical to its standalone ``engine.run()``.
Admission stays per-tenant: each engine gates at its own BestRate (Eq.
10 at the tenant's planned rate), so one tenant's burst never stalls
another.

Configuration is the unified ``serving.ServeConfig``: the scheduler
takes a fleet-wide config (execution knobs shared by every engine) and
``TenantWorkload.config`` replaces it per tenant — per-tenant arrival
scenarios, overload policies and batch-pinned kernel plans included.
Executing engines run on the scheduler's ``device`` (the card unless
the caller names the CPU); with ``execute="devices"`` each tenant's
stages run on streams of their own.

``FleetReport`` aggregates per-tenant telemetry (p50/p99 service
latency, stall/bound flags, shed/switch counts) with per-chip occupancy
over the fleet makespan — the pool-level utilization the planner
promised, measured on the tick clock.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.core.replicate import replicate_params
from repro_torch.fleet.pool import PoolPlan
from repro_torch.obs.trace import Tracer, resolve_tracer
from repro_torch.serving.cnn_stream import CNNStreamEngine, ServeReport, ServingError
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.telemetry import ServeSummary


class FleetError(ServingError):
    """Raised when the fleet run cannot serve its workloads."""


@dataclasses.dataclass(frozen=True)
class TenantWorkload:
    """One tenant's offered load for a fleet run.

    ``frames`` is an ``[N, H, W, C]`` array or tensor of frames when the
    engines execute, or a bare count for the timing model.  ``config``
    is the tenant's full ``serving.ServeConfig`` (arrival source, flush,
    SLA/overload policy, per-tenant execution knobs); None takes the
    scheduler's fleet-wide config.
    """

    tenant: str
    frames: object
    config: Optional[ServeConfig] = None


@dataclasses.dataclass
class FleetReport:
    """Fleet-wide results: per-tenant reports + per-chip occupancy."""

    reports: Dict[str, ServeReport]
    outputs: Dict[str, Optional[torch.Tensor]]
    makespan_cycles: Fraction  # latest tenant finish, shared clock
    chip_occupancy: Dict[str, float]  # busy cycles / fleet makespan
    # host wall-clock per tenant (seconds first dispatch -> last), from
    # the shared obs.Tracer's "exec" spans; empty unless the fleet ran
    # with tracing on AND execute
    tenant_wall_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the shared obs.Tracer the engines recorded into (None when off)
    trace: Optional[object] = None

    @property
    def all_stall_free(self) -> bool:
        return all(r.stall_free for r in self.reports.values())

    @property
    def all_within_bounds(self) -> bool:
        return all(r.within_queue_bounds for r in self.reports.values())

    def p50_latency(self, tenant: str) -> float:
        return self.reports[tenant].p50_latency()

    def p99_latency(self, tenant: str) -> float:
        return self.reports[tenant].p99_latency()

    def measured_fps(self, tenant: str) -> float:
        """Served frames over host wall-clock (tracing + execute only):
        the measured twin of the tick-domain throughput column."""
        wall = self.tenant_wall_s.get(tenant, 0.0)
        if wall <= 0.0:
            raise FleetError(
                f"no wall-clock span for {tenant!r} — fleet must run with "
                "tracing on and execute=True for measured fps"
            )
        return self.reports[tenant].completed / wall

    def summaries(self) -> Dict[str, ServeSummary]:
        """Per-tenant views in the unified telemetry schema."""
        return {
            name: r.summary(label=name) for name, r in self.reports.items()
        }

    def to_rows(self) -> List[Tuple[str, str]]:
        """Canonical (name, value) rows via the unified schema — the
        fleet-side twin of ``ServeReport.to_rows``."""
        rows: List[Tuple[str, str]] = []
        for name, s in sorted(self.summaries().items()):
            for suffix, val in s.to_rows():
                rows.append((f"{name}/{suffix}", val))
        for chip, occ in sorted(self.chip_occupancy.items()):
            rows.append((chip, f"occupancy={occ:.3f}"))
        return rows

    def summary_rows(self) -> List[Tuple[str, str]]:
        """(name, value) rows for logging / a benchmark table."""
        rows = []
        for name, s in sorted(self.summaries().items()):
            rows.append(
                (
                    f"{name}",
                    f"served={s.completed} thr={s.throughput:.3f} "
                    f"p50={s.p50_ticks:.1f} p99={s.p99_ticks:.1f} "
                    f"stall_free={s.stall_free}",
                )
            )
        for chip, occ in sorted(self.chip_occupancy.items()):
            rows.append((chip, f"occupancy={occ:.3f}"))
        return rows


class FleetScheduler:
    """Drive every pooled tenant's pipeline on one shared clock.

    ``params`` maps tenant name -> that family's (unreplicated) params;
    required per served tenant when executing (the scheduler aliases the
    hot node's weights onto replication lanes itself).  ``config`` is the
    fleet-wide ``serving.ServeConfig`` (default: the timing model,
    ``execute=False``); a ``TenantWorkload.config`` replaces it for its
    tenant.  Executing engines run on ``device`` (the card unless the
    caller names the CPU; a timing-only fleet resolves none).
    """

    def __init__(
        self,
        pool: PoolPlan,
        *,
        params: Optional[Mapping[str, object]] = None,
        config: Optional[ServeConfig] = None,
        device=None,
    ) -> None:
        self.pool = pool
        self.params = dict(params or {})
        self.config = config if config is not None else ServeConfig(execute=False)
        self.device = device
        # one shared tracer for the whole fleet: every tenant's engine
        # records under its own pid (the tenant name), stage spans tagged
        # with the pool's chip assignment
        self.tracer = resolve_tracer(self.config.trace)

    @property
    def execute(self):
        return self.config.execute

    def init_params(self, tenant: str, generator: torch.Generator) -> None:
        """Initialize (and store) one tenant's params from its config, on
        the scheduler's device."""
        from repro_torch.models.registry import get_cnn_api

        cand = self.pool.candidate_for(tenant)
        t = next(t for t in self.pool.tenants if t.name == tenant)
        api = get_cnn_api(t.family, device=self.device)
        self.params[tenant] = api.init(cand.cfg, generator)

    def _tenant_config(self, w: TenantWorkload, cand) -> ServeConfig:
        cfg = w.config if w.config is not None else self.config
        if cfg.dtype is None:
            dtype = getattr(cand.cfg, "dtype", None)
            if dtype is not None:
                cfg = cfg.with_(dtype=dtype)
        if self.tracer is not None and not isinstance(cfg.trace, Tracer):
            # fleet tracing on: every tenant records into the SHARED
            # tracer under its own pid (tenant name), stage spans tagged
            # with the pool's chip assignment — unless the tenant's own
            # config carries an explicit Tracer of its own
            cfg = cfg.with_(
                trace=self.tracer,
                trace_pid=w.tenant,
                trace_chips={
                    a.stage: a.chip
                    for a in self.pool.assignments
                    if a.tenant == w.tenant
                },
            )
        return cfg

    def _engine(self, w: TenantWorkload) -> CNNStreamEngine:
        cand = self.pool.candidate_for(w.tenant)
        cfg = self._tenant_config(w, cand)
        params = self.params.get(w.tenant)
        if cfg.execute:
            if params is None:
                raise FleetError(
                    f"execute={cfg.execute!r} but no params for tenant "
                    f"{w.tenant!r} (pass params= or call init_params)"
                )
            if cand.plan.replications:
                params = replicate_params(params, cand.plan.replications)
        engine = CNNStreamEngine(
            cand.plan.graph, params, cand.plan, cfg, device=self.device
        )
        if cfg.execute:
            engine.submit_all(w.frames)
        else:
            n = w.frames if isinstance(w.frames, int) else len(w.frames)
            for _ in range(n):
                engine.submit(None)
        return engine

    def serve(
        self,
        workloads: List[TenantWorkload],
        *,
        max_ticks: int = 1_000_000,
    ) -> FleetReport:
        """Serve every workload to completion on the shared clock."""
        if not workloads:
            raise FleetError("no workloads to serve")
        seen = set()
        for w in workloads:
            if w.tenant not in self.pool.chosen:
                raise FleetError(
                    f"workload names unpooled tenant {w.tenant!r}; pooled: "
                    f"{sorted(self.pool.chosen)}"
                )
            if w.tenant in seen:
                raise FleetError(f"duplicate workload for {w.tenant!r}")
            seen.add(w.tenant)

        engines = {w.tenant: self._engine(w) for w in workloads}
        runs = {
            w.tenant: engines[w.tenant].begin(max_ticks=max_ticks)
            for w in workloads
        }

        t = Fraction(0)
        active = dict(engines)
        finish_at: Dict[str, Fraction] = {}
        while active:
            for name in list(active):
                e = active[name]
                e.advance(t)
                if e.finished:
                    finish_at[name] = t
                    del active[name]
            if not active:
                break
            nxts = []
            for name, e in active.items():
                nxt = e.next_event(t)
                if nxt is None:
                    continue
                if nxt > runs[name].horizon:
                    raise FleetError(
                        f"tenant {name!r} exceeded max_ticks={max_ticks} "
                        f"({runs[name].completed}/{runs[name].n} served)"
                    )
                nxts.append(nxt)
            if not nxts:
                stuck = {
                    n: f"{runs[n].completed}/{runs[n].n}" for n in active
                }
                raise FleetError(f"fleet deadlock at t={t}: {stuck}")
            t = min(nxts)

        reports = {name: e.finish() for name, e in engines.items()}
        outputs = {
            name: (e.outputs() if e.execute else None)
            for name, e in engines.items()
        }
        makespan = max(finish_at.values())
        occupancy: Dict[str, float] = {c.name: 0.0 for c in self.pool.chips}
        for a in self.pool.assignments:
            r = reports.get(a.tenant)
            if r is None or makespan == 0:
                continue  # tenant pooled but not served this run
            # stage rows of the base rung only — the pool packer pinned
            # one (base-plan) stage per chip
            busy = sum(
                (
                    s.busy_cycles
                    for s in r.stages
                    if s.stage == a.stage and s.rung == 0
                ),
                Fraction(0),
            )
            occupancy[a.chip] = float(busy / makespan)
        wall: Dict[str, float] = {}
        if self.tracer is not None:
            for name in reports:
                spans = self.tracer.spans("exec", pid=name, clock="host")
                if spans:
                    wall[name] = float(
                        max(s.end for s in spans) - min(s.start for s in spans)
                    )
        return FleetReport(
            reports=reports,
            outputs=outputs,
            makespan_cycles=makespan,
            chip_occupancy=occupancy,
            tenant_wall_s=wall,
            trace=self.tracer,
        )
