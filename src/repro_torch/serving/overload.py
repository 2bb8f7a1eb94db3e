"""Overload policies: SLA shedding and online plan switching (the port's
own copy of the JAX package's ``serving/overload.py``).

The engine's admission gate (Eq. 9 at the request level) keeps the
*pipeline* stall-free at any offered load — but above BestRate the
excess parks in the request queue, and with sustained overload that
queue (and the latency of everything in it) grows without bound.  The
continuous-flow calculus says nothing about that regime; these policies
do.  Both plug into ``ServeConfig.overload`` and act inside the
engine's deterministic event loop:

* ``ShedPolicy(deadline_ticks)`` — SLA-aware shedding.  At every
  admission opportunity the engine projects the completion time of the
  oldest pending frame were it admitted behind the current backlog
  (backlog x bottleneck service time — exact in steady state, since the
  pipeline provably serves at the bottleneck pace).  If the projection
  exceeds the deadline, the frame is dropped *before* admission: it
  never occupies a queue slot, survivors keep their submission order,
  and ``admitted + shed == submitted`` holds by construction.  Above
  BestRate the pending queue stabilizes at the deadline's worth of
  backlog — p99 latency of the *served* frames is bounded by the
  deadline, which is the entire point.

* ``SwitchPolicy(ladder)`` — online plan switching.  The DSE already
  enumerates a whole ladder of configurations for one graph
  (``core.dse.plan_ladder``): higher planned input rates (coarser
  ``(j, h)`` tiles at higher per-node capacity), and Multi-CLP
  replication variants in the spirit of Shen et al. (resource
  partitioning) at the top.  ``PlanLadder.build`` prices each rung by
  its *absolute* sustainable rate (frames per hardware cycle —
  frames/tick is not comparable across rungs, every plan defines its
  own tick) and keeps the strictly-improving prefix.  The engine
  estimates the offered rate over a trailing window and asks
  ``SwitchPolicy.target`` for the cheapest rung that sustains it; a
  decided switch first *drains* — admission holds new micro-batches
  back until every in-flight batch has left the pipeline — then swaps
  queues, stage state, and the batch-pinned kernel plan at the empty
  boundary and re-asserts the continuous-flow invariant.  Because a
  batch never crosses a switch, each frame is served end-to-end by
  exactly one rung: outputs are bit-exact vs running that rung's plan
  monolithically on the same frames (tested).

Switching *down* (traffic subsided) uses ``down_headroom`` hysteresis:
the estimate must fall below the cheaper rung's capacity with margin,
so rate estimates bouncing around a rung boundary do not thrash the
pipeline with drain cycles.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Tuple


class OverloadError(ValueError):
    """Misconfigured overload policy or ladder."""


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """Drop pending frames whose projected completion misses the SLA.

    ``deadline_ticks`` is the submit-to-done budget in ticks (frame
    slots at the base plan's input rate).  Shedding happens at the
    admission gate only — frames already admitted are never dropped,
    and survivors are never reordered.
    """

    deadline_ticks: Fraction = Fraction(32)

    def __post_init__(self):
        d = Fraction(self.deadline_ticks)
        if d <= 0:
            raise OverloadError(
                f"deadline_ticks must be > 0, got {self.deadline_ticks}"
            )
        object.__setattr__(self, "deadline_ticks", d)


@dataclasses.dataclass(frozen=True)
class LadderRung:
    """One downgrade-ladder entry: a planned configuration priced by the
    absolute rate it sustains (frames per hardware cycle)."""

    label: str
    plan: Any  # core.graph.GraphPlan (with a stage partition)
    rate_cycles: Fraction  # request-level BestRate, frames/cycle


@dataclasses.dataclass(frozen=True)
class PlanLadder:
    """Rungs in ascending sustainable rate; rung 0 is the serving base.

    Build with :meth:`build` (DSE enumeration + pricing + pruning), or
    construct directly from hand-planned rungs — the only requirements
    are that every rung's plan carries a stage partition and that rates
    strictly increase (checked).
    """

    rungs: Tuple[LadderRung, ...]

    def __post_init__(self):
        if not self.rungs:
            raise OverloadError("a ladder needs at least one rung")
        rates = [r.rate_cycles for r in self.rungs]
        if any(b <= a for a, b in zip(rates, rates[1:])):
            raise OverloadError(
                "ladder rungs must strictly increase in sustainable rate, "
                f"got {[str(r) for r in rates]}"
            )

    @classmethod
    def build(
        cls,
        graph,
        input_rate,
        *,
        n_stages: int = 1,
        rate_factors=(1, 2),
        try_replicate: bool = False,
        r_options=(2, 3),
        **plan_kwargs,
    ) -> "PlanLadder":
        """Enumerate, price, and prune the downgrade ladder.

        ``core.dse.plan_ladder`` plans the graph at ``input_rate`` times
        each of ``rate_factors`` (cheapest first; factor 1 **must** be
        included — it becomes the serving base rung) and optionally adds
        the best Multi-CLP replication variant at the top rate.  Rungs
        that do not strictly improve the request-level sustainable rate
        over the previous kept rung are pruned (a higher planned rate
        does not always buy request throughput — the bottleneck may be
        structural).
        """
        from repro_torch.core.dse import plan_ladder
        from repro_torch.serving.cnn_stream import sustainable_rate_cycles

        factors = sorted({Fraction(f) for f in rate_factors})
        if Fraction(1) not in factors:
            raise OverloadError(
                f"rate_factors must include 1 (the serving base rung), "
                f"got {rate_factors}"
            )
        plans = plan_ladder(
            graph,
            input_rate,
            n_stages=n_stages,
            rate_factors=factors,
            try_replicate=try_replicate,
            r_options=r_options,
            **plan_kwargs,
        )
        rungs = []
        for plan in plans:
            rate = sustainable_rate_cycles(plan)
            rep = ""
            if plan.replications:
                rep = "+rep(" + ",".join(
                    f"{r.node}x{r.r}" for r in plan.replications
                ) + ")"
            label = f"r={plan.input_rate}{rep}"
            if rungs and rate <= rungs[-1].rate_cycles:
                continue  # no request-level improvement — prune
            rungs.append(LadderRung(label=label, plan=plan, rate_cycles=rate))
        if plans and plans[0] is not rungs[0].plan:
            raise OverloadError("base rung (factor 1) was pruned")
        return cls(rungs=tuple(rungs))

    def describe(self) -> str:
        return " -> ".join(
            f"{r.label} ({float(r.rate_cycles):.4g} f/cyc)" for r in self.rungs
        )


@dataclasses.dataclass(frozen=True)
class SwitchPolicy:
    """Serve through the cheapest ladder rung that sustains the traffic.

    ``window_ticks`` is the trailing window (in base-plan ticks) the
    engine estimates the offered rate over; ``down_headroom`` in (0, 1]
    is the hysteresis for switching back down: a cheaper rung is taken
    only once the estimate falls below ``headroom x`` its capacity.
    """

    ladder: PlanLadder
    window_ticks: Fraction = Fraction(8)
    down_headroom: Fraction = Fraction(3, 4)

    def __post_init__(self):
        w = Fraction(self.window_ticks)
        h = Fraction(self.down_headroom)
        if w <= 0:
            raise OverloadError(f"window_ticks must be > 0, got {w}")
        if not 0 < h <= 1:
            raise OverloadError(f"down_headroom must be in (0, 1], got {h}")
        object.__setattr__(self, "window_ticks", w)
        object.__setattr__(self, "down_headroom", h)

    def target(self, est_rate_cycles: Fraction, active: int) -> int:
        """The rung to serve the estimated offered rate through.

        ``est_rate_cycles`` is the trailing-window estimate in frames
        per hardware cycle (the ladder's pricing unit).  Up-switches
        take the cheapest rung whose capacity covers the estimate (the
        top rung if none does); down-switches additionally require the
        ``down_headroom`` margin.
        """
        rates = [r.rate_cycles for r in self.ladder.rungs]
        cand = next(
            (i for i, rc in enumerate(rates) if rc >= est_rate_cycles),
            len(rates) - 1,
        )
        if cand > active:
            return cand
        if cand < active and est_rate_cycles <= rates[cand] * self.down_headroom:
            return cand
        return active
