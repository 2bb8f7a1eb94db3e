"""Chip-pool planner: pack N rate-targeted tenants onto a chip budget.

The port's own copy of the JAX package's ``fleet/pool.py``: pure
planning over the port's ``core`` (exact ``Fraction`` arithmetic), so a
pool plans here exactly as it does there.

A *tenant* is a CNN registry family plus the input rate its frames
arrive at (features/clock, exact Fraction).  A *chip* is a resource
budget (DSP / BRAM36 / LUT axes of ``core.hw.FPGASpec``).  The planner
answers: which stage partition — and, when it helps, which Multi-CLP
replication — should each tenant run, and which chip hosts which stage,
so that every tenant sustains its target rate on the given pool?

The search is deliberately simple and exact:

1. **Candidates** (``enumerate_candidates``): per tenant, sweep the
   stage count S and optionally the bottleneck replication
   (``core.replicate.best_replication``).  Each candidate is a full
   ``GraphPlan`` at the tenant's rate, priced per stage by
   ``resource_model.estimate_stages`` (nodes + join FIFOs + incoming
   stream buffers).  A candidate survives only if *every* stage fits on
   at least one chip of the pool — rate feasibility is already
   guaranteed by the DSE (scheme 'ours' satisfies Eq. 9 per node at the
   post-cut rate).
2. **Packing** (``plan_pool``): enumerate one candidate per tenant
   (capped cartesian product), assign stages to chips best-fit by DSP
   demand (one stage per chip — the stage is a synchronous pipeline;
   chips are not shared across tenants), and keep the feasible combo
   with the lexicographically least (total multipliers, total chips).

``PoolPlan.utilization()`` reports per-chip occupancy of each axis;
``PoolPlan.fair_share()`` is the advisory continuous-flow split of the
same pool via ``stage_partition.allocate_chips`` (what a cost-
proportional allocator would give each tenant) for comparison.
"""

from __future__ import annotations

import dataclasses
import itertools
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import GraphPlan, plan_graph
from repro_torch.core.hw import XCVU37P
from repro_torch.core.replicate import best_replication
from repro_torch.core.resource_model import ResourceEstimate, estimate_stages
from repro_torch.core.stage_partition import LinkDtype, allocate_chips


def pool_bram_budget(chips: Sequence["Chip"]) -> int:
    """Stream-buffer bit budget the partitioner plans against: the
    largest chip's BRAM, in bits.  Deliberately optimistic — the packer
    may later place a stage on a smaller chip, but ``_candidate``'s
    fits() check still gates that exactly; the budget's job is to stop
    the DP from ever *proposing* a cut no chip in the pool could host.
    """
    return max(c.bram36 for c in chips) * XCVU37P.bram36_kbits * 1024


class PoolError(ValueError):
    """Raised when tenants cannot be served on the offered pool."""


@dataclasses.dataclass(frozen=True)
class Chip:
    """One FPGA's budget along the axes the packer checks.

    Defaults are the paper's xcvu37p; heterogeneous pools mix sizes.
    """

    name: str
    dsp: int = XCVU37P.dsps
    bram36: int = XCVU37P.bram36
    lut: int = XCVU37P.luts

    def fits(self, est: ResourceEstimate) -> bool:
        return (
            est.dsp <= self.dsp
            and est.bram36 <= self.bram36
            and est.lut <= self.lut
        )


def chip_pool(n: int, *, prefix: str = "chip", **axes) -> Tuple[Chip, ...]:
    """A homogeneous pool of ``n`` chips (axes override the xcvu37p)."""
    return tuple(Chip(name=f"{prefix}{i}", **axes) for i in range(n))


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One serving customer: a registry family at a target input rate."""

    name: str
    family: str  # models.registry.cnn_families() key
    input_rate: Fraction  # features/clock the tenant's frames arrive at
    input_hw: Tuple[int, int] = (32, 32)
    num_classes: int = 10

    def config(self):
        from repro_torch.models.registry import make_cnn_config

        return make_cnn_config(
            self.family, input_hw=self.input_hw, num_classes=self.num_classes
        )


@dataclasses.dataclass(frozen=True)
class TenantCandidate:
    """One feasible way to serve a tenant: a priced, partitioned plan."""

    tenant: str
    n_stages: int
    replicated: bool  # True when the plan carries a Multi-CLP rewrite
    plan: GraphPlan = dataclasses.field(compare=False)
    cfg: object = dataclasses.field(compare=False)
    stage_costs: Tuple[ResourceEstimate, ...] = dataclasses.field(compare=False)
    total_mults: int = 0
    bottleneck_mults: int = 0

    @property
    def label(self) -> str:
        rep = "+rep" if self.replicated else ""
        return f"{self.tenant}:S{self.n_stages}{rep}"


@dataclasses.dataclass(frozen=True)
class ChipAssignment:
    """One chip hosting one tenant's pipeline stage."""

    chip: str
    tenant: str
    stage: int
    dsp_frac: float
    bram_frac: float
    lut_frac: float


def _candidate(
    tenant: Tenant, cfg, plan: GraphPlan, chips: Sequence[Chip]
) -> Optional[TenantCandidate]:
    """Price a plan and admit it iff every stage fits some pool chip."""
    costs = tuple(estimate_stages(plan))
    if not all(any(c.fits(est) for c in chips) for est in costs):
        return None
    return TenantCandidate(
        tenant=tenant.name,
        n_stages=plan.stage_plan.n_stages,
        replicated=bool(plan.replications),
        plan=plan,
        cfg=cfg,
        stage_costs=costs,
        total_mults=plan.total_mults,
        bottleneck_mults=max(plan.stage_mults()),
    )


def enumerate_candidates(
    tenant: Tenant,
    chips: Sequence[Chip],
    *,
    s_options: Tuple[int, ...] = (1, 2, 3),
    try_replicate: bool = True,
    r_options: Tuple[int, ...] = (2,),
    scheme: str = "ours",
    link_dtype: LinkDtype = "int8",
) -> List[TenantCandidate]:
    """All feasible (S, replication) plans for one tenant on this pool.

    Each S contributes the plain plan and, when ``try_replicate`` and
    the replication DSE actually improves the bottleneck, the
    replicated one — both planned at the tenant's target rate, with
    cut-crossing streams at ``link_dtype`` width and the partition DP
    constrained to the pool's BRAM budget (``pool_bram_budget``): an S
    whose every cut would overflow the largest chip is skipped here,
    before ``_candidate`` even prices it.
    """
    cfg = tenant.config()
    graph = cfg.graph()
    budget = pool_bram_budget(chips)
    out: List[TenantCandidate] = []
    for s in s_options:
        plans = []
        try:
            plans.append(
                plan_graph(
                    graph,
                    tenant.input_rate,
                    n_stages=s,
                    scheme=scheme,
                    link_dtype=link_dtype,
                    bram_budget=budget,
                )
            )
        except ValueError:
            pass  # no S-stage cut fits the pool's BRAM — drop this S
        if try_replicate:
            try:
                rep = best_replication(
                    graph,
                    tenant.input_rate,
                    n_stages=s,
                    r_options=r_options,
                    scheme=scheme,
                    link_dtype=link_dtype,
                    bram_budget=budget,
                )
                if rep.replications:  # baseline competes: empty = no win
                    plans.append(rep)
            except ValueError:
                pass
        for plan in plans:
            cand = _candidate(tenant, cfg, plan, chips)
            if cand is not None:
                out.append(cand)
    return out


def _assign(
    stages: List[Tuple[str, int, ResourceEstimate]],
    chips: Sequence[Chip],
) -> Optional[List[ChipAssignment]]:
    """Best-fit-decreasing matching: biggest stage first, smallest chip
    that fits — keeps the large chips free for the large stages."""
    stages = sorted(stages, key=lambda s: s[2].dsp, reverse=True)
    free = sorted(chips, key=lambda c: (c.dsp, c.bram36, c.lut))
    out: List[ChipAssignment] = []
    for tenant, stage, est in stages:
        chip = next((c for c in free if c.fits(est)), None)
        if chip is None:
            return None
        free.remove(chip)
        out.append(
            ChipAssignment(
                chip=chip.name,
                tenant=tenant,
                stage=stage,
                dsp_frac=est.dsp / chip.dsp,
                bram_frac=est.bram36 / chip.bram36,
                lut_frac=est.lut / chip.lut,
            )
        )
    return out


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """The packed pool: one chosen candidate per tenant, chips assigned."""

    tenants: Tuple[Tenant, ...]
    chips: Tuple[Chip, ...]
    chosen: Dict[str, TenantCandidate] = dataclasses.field(compare=False)
    assignments: Tuple[ChipAssignment, ...] = ()

    @property
    def total_mults(self) -> int:
        return sum(c.total_mults for c in self.chosen.values())

    @property
    def chips_used(self) -> int:
        return len(self.assignments)

    @property
    def spare_chips(self) -> Tuple[str, ...]:
        used = {a.chip for a in self.assignments}
        return tuple(c.name for c in self.chips if c.name not in used)

    def candidate_for(self, tenant: str) -> TenantCandidate:
        return self.chosen[tenant]

    def utilization(self) -> Dict[str, Dict[str, float]]:
        """Per-chip axis occupancy (0 for spare chips)."""
        out = {
            c.name: {"dsp": 0.0, "bram36": 0.0, "lut": 0.0}
            for c in self.chips
        }
        for a in self.assignments:
            out[a.chip] = {
                "dsp": a.dsp_frac,
                "bram36": a.bram_frac,
                "lut": a.lut_frac,
            }
        return out

    def fair_share(self) -> Dict[str, int]:
        """Advisory cost-proportional chip split over the same pool
        (largest-remainder, every tenant >= 1) — the continuous-flow
        allocator's answer, to compare against the exact packing."""
        names = [t.name for t in self.tenants]
        shares = allocate_chips(
            [self.chosen[n].total_mults for n in names], len(self.chips)
        )
        return dict(zip(names, shares))


def plan_pool(
    tenants: Sequence[Tenant],
    chips: Sequence[Chip],
    *,
    s_options: Tuple[int, ...] = (1, 2, 3),
    try_replicate: bool = True,
    r_options: Tuple[int, ...] = (2,),
    scheme: str = "ours",
    link_dtype: LinkDtype = "int8",
    max_combos: int = 4096,
) -> PoolPlan:
    """Pack every tenant onto the pool (see module docstring).

    Candidates are planned with ``link_dtype`` crossings under the
    pool's BRAM budget (see ``enumerate_candidates``), so every packed
    plan is BRAM-feasible by construction, not just by the fits() check.
    Raises ``PoolError`` when a tenant has no feasible candidate or no
    candidate combination packs onto the chips.
    """
    tenants = tuple(tenants)
    chips = tuple(chips)
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise PoolError(f"duplicate tenant names: {names}")
    if not tenants:
        raise PoolError("no tenants to place")
    if not chips:
        raise PoolError("no chips in the pool")

    cand_lists: List[List[TenantCandidate]] = []
    for t in tenants:
        cands = enumerate_candidates(
            t,
            chips,
            s_options=s_options,
            try_replicate=try_replicate,
            r_options=r_options,
            scheme=scheme,
            link_dtype=link_dtype,
        )
        if not cands:
            raise PoolError(
                f"tenant {t.name!r} ({t.family} @ rate {t.input_rate}) has "
                f"no stage plan that fits any chip in the pool"
            )
        cand_lists.append(cands)

    n_combos = 1
    for lst in cand_lists:
        n_combos *= len(lst)
    if n_combos > max_combos:
        raise PoolError(
            f"{n_combos} candidate combinations exceed max_combos="
            f"{max_combos}; restrict s_options or raise the cap"
        )

    best: Optional[Tuple[Tuple[int, int], Dict, List[ChipAssignment]]] = None
    for combo in itertools.product(*cand_lists):
        n_stages = sum(c.n_stages for c in combo)
        if n_stages > len(chips):
            continue
        stages = [
            (c.tenant, s, c.stage_costs[s])
            for c in combo
            for s in range(c.n_stages)
        ]
        assigned = _assign(stages, chips)
        if assigned is None:
            continue
        key = (sum(c.total_mults for c in combo), n_stages)
        if best is None or key < best[0]:
            best = (key, {c.tenant: c for c in combo}, assigned)
    if best is None:
        raise PoolError(
            f"no combination of per-tenant plans packs onto "
            f"{len(chips)} chips"
        )
    return PoolPlan(
        tenants=tenants,
        chips=chips,
        chosen=best[1],
        assignments=tuple(best[2]),
    )
