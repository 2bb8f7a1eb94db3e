"""Multi-CLP bottleneck replication (Shen et al., resource partitioning).

The port's own copy of the JAX package's ``core/replicate.py``.

The min-bottleneck stage partition (``core.stage_partition``) keeps
stages contiguous in topological order, so the best achievable balance
is capped by the single most expensive node: no cut can make a stage
cheaper than the dominant layer's mult count.  Shen et al. ("Maximizing
CNN Accelerator Efficiency Through Resource Partitioning") break that
cap by instantiating multiple convolutional layer processors for the hot
layer, each handling a share of the frames.

This module is that idea expressed in the paper's rate calculus.  A
replication rewrites the graph *around* the bottleneck node::

        pred -> hot -> succ
    becomes
        pred -> hot__split -> hot__r0 ... hot__r{R-1} -> hot__merge -> succ

    * ``hot__split`` ('split' kind) round-robin-deals whole frames over
      the R lanes, so each lane sees pixel rate q / R — its (j, h) is
      selected by the ordinary DSE at demand rate/R (Eq. 9 on the lane).
    * each lane ``hot__r{k}`` is a verbatim clone of the hot LayerSpec
      (same kernel, stride, activation — only the name differs).
    * ``hot__merge`` ('merge' kind) re-interleaves the lane streams in
      frame order and emits q_out = q_lane * R — exactly the rate the
      unreplicated node emitted, so every downstream demand, and hence
      Eq. 9/10 continuous flow, is preserved bit-for-bit.

    Both new kinds are wiring (no multipliers); their deal/skew FIFOs are
    sized exactly by ``graph.deal_buffers`` / ``graph.join_buffers`` and
    priced by the ordinary resource model and ``stream_buffers``.

The DP then re-partitions the replicated graph: the lanes are separate
nodes it may cut *between*, so the bottleneck stage can shrink below the
original dominant layer — measured in ``benchmarks/table7_fleet.py``.

Entry points: ``plan_graph(replicate=...)`` (the planner front door),
``replicate_node`` (the graph rewrite), ``replicate_params`` (alias the
hot node's weights under the lane names for the executor), and
``select_bottleneck`` (the DSE-selected hot node).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Mapping, Optional, Tuple, Union

from .graph import GraphError, GraphPlan, LayerGraph, plan_graph
from .rate import LayerSpec

# Kinds worth replicating: only multiplier-bearing nodes can be a mult
# bottleneck, and the frame-dealing semantics need a single-producer node.
REPLICABLE_KINDS = ("conv", "dwconv", "pointwise", "dense")

# A GraphPlan planned over a replicated graph (``.replications`` lists the
# applied rewrites) — the "ReplicatedPlan" of the fleet subsystem.  It is
# structurally an ordinary GraphPlan: every consumer (executor, serving
# engine, resource model) works on it unchanged.
ReplicatedPlan = GraphPlan

ReplicateArg = Union[int, Tuple[str, int], Mapping[str, int]]


@dataclasses.dataclass(frozen=True)
class Replication:
    """Record of one applied Multi-CLP rewrite."""

    node: str  # the original bottleneck node (absent from the new graph)
    r: int  # lane count R
    split: str  # the round-robin frame splitter node
    merge: str  # the order-preserving merger node
    lanes: Tuple[str, ...]  # the R clone nodes, in deal order


@dataclasses.dataclass(frozen=True)
class ReplicatedGraph:
    """A rewritten graph plus the record of the rewrite that produced it."""

    graph: LayerGraph
    replication: Replication


def replicable_nodes(graph: LayerGraph) -> List[str]:
    """Nodes eligible for replication, in topological order."""
    return [
        n for n in graph.topo_order() if graph.spec(n).kind in REPLICABLE_KINDS
    ]


def select_bottleneck(plan: GraphPlan) -> str:
    """The DSE-selected hot node: max mults, ties to the earliest in topo
    order (the first node to reach the max is kept by the strict >)."""
    best = None
    best_mults = 0
    for name, impl in plan.impls.items():
        if impl.mults > best_mults:
            best, best_mults = name, impl.mults
    if best is None:
        raise GraphError("no multiplier-bearing node to replicate")
    return best


def replicate_node(graph: LayerGraph, name: str, r: int) -> ReplicatedGraph:
    """Rewrite ``graph`` with ``name`` cloned ``r`` ways (see module doc)."""
    if r < 2:
        raise GraphError(f"replicate {name!r}: R must be >= 2, got {r}")
    if name not in graph:
        raise GraphError(f"replicate: unknown node {name!r}")
    spec = graph.spec(name)
    if spec.kind not in REPLICABLE_KINDS:
        raise GraphError(
            f"replicate {name!r}: kind {spec.kind!r} is not replicable "
            f"(needs one of {REPLICABLE_KINDS})"
        )
    rep = Replication(
        node=name,
        r=r,
        split=f"{name}__split",
        merge=f"{name}__merge",
        lanes=tuple(f"{name}__r{k}" for k in range(r)),
    )
    for new in (rep.split, rep.merge, *rep.lanes):
        if new in graph:
            raise GraphError(f"replicate {name!r}: node {new!r} already exists")

    g = LayerGraph()
    rewired: Dict[str, str] = {}
    for n in graph.topo_order():
        s = graph.spec(n)
        preds = [rewired[p] for p in graph.preds(n)]
        if n != name:
            g.add(s, preds)
            rewired[n] = n
            continue
        g.add(
            LayerSpec(
                name=rep.split,
                kind="split",
                d_in=s.d_in,
                d_out=s.d_in,
                in_hw=s.in_hw,
                out_hw=s.in_hw,
            ),
            preds,
        )
        for lane in rep.lanes:
            g.add(dataclasses.replace(s, name=lane), [rep.split])
        g.add(
            LayerSpec(
                name=rep.merge,
                kind="merge",
                d_in=s.d_out,
                d_out=s.d_out,
                in_hw=s.out_hw,
                out_hw=s.out_hw,
            ),
            list(rep.lanes),
        )
        rewired[n] = rep.merge
    return ReplicatedGraph(graph=g, replication=rep)


def apply_replications(
    graph: LayerGraph,
    replicate: ReplicateArg,
    *,
    input_rate: Fraction = Fraction(1),
    scheme: str = "ours",
) -> Tuple[LayerGraph, Tuple[Replication, ...]]:
    """Normalize a ``plan_graph(replicate=...)`` argument and apply it.

    ``replicate`` may be a bare ``R`` (auto-select the bottleneck via an
    unreplicated plan at the same rate/scheme), a ``(node, R)`` pair, or
    a ``{node: R}`` mapping applied in insertion order.
    """
    if isinstance(replicate, bool):
        raise GraphError(f"replicate: expected node/R spec, got {replicate!r}")
    if isinstance(replicate, int):
        base = plan_graph(graph, input_rate, scheme=scheme)
        items = [(select_bottleneck(base), replicate)]
    elif isinstance(replicate, Mapping):
        items = list(replicate.items())
    else:
        node, r = replicate
        items = [(node, int(r))]
    reps: List[Replication] = []
    for node, r in items:
        rg = replicate_node(graph, node, int(r))
        graph = rg.graph
        reps.append(rg.replication)
    return graph, tuple(reps)


def replicate_params(params: Mapping, replications) -> dict:
    """Alias a name-keyed mapping (params / q_params / scales) onto the
    lane names so the executor finds the hot node's weights under every
    clone.  The original key is kept — lanes *share* the weights (the
    whole point of Multi-CLP: R processors, one layer)."""
    out = dict(params)
    for rep in replications:
        if rep.node in out:
            for lane in rep.lanes:
                out[lane] = out[rep.node]
    return out


def lane_multiplicity(plan: GraphPlan, name: str) -> int:
    """R if ``name`` is a replication lane of ``plan``, else 1 — a lane
    serves 1 of every R frames, so per-frame service amortizes by R."""
    for rep in getattr(plan, "replications", ()) or ():
        if name in rep.lanes:
            return rep.r
    return 1


def plan_replicated(
    graph: LayerGraph,
    input_rate: Fraction,
    *,
    r: int,
    node: Optional[str] = None,
    **plan_kwargs,
) -> ReplicatedPlan:
    """Convenience front door: replicate ``node`` (or the auto-selected
    bottleneck) R ways and plan the rewritten graph.  ``plan_kwargs``
    pass through to ``plan_graph`` (scheme, objective, n_stages, ...)."""
    rep_arg: ReplicateArg = r if node is None else (node, r)
    return plan_graph(graph, input_rate, replicate=rep_arg, **plan_kwargs)


def best_replication(
    graph: LayerGraph,
    input_rate: Fraction,
    *,
    n_stages: int,
    r_options: Tuple[int, ...] = (2, 3),
    candidates: Optional[List[str]] = None,
    **plan_kwargs,
) -> ReplicatedPlan:
    """Replication DSE: sweep (node, R) and keep the plan with the best
    min-bottleneck stage balance.

    The global max-mults node is *not* always the right thing to split —
    what caps balance is the dominant node of the **bottleneck stage**
    (the DP may already have isolated the global maximum).  So the sweep
    runs over the replicable nodes of the baseline plan's bottleneck
    stage (or an explicit ``candidates`` list) times ``r_options``, and
    keeps the lexicographic best of (bottleneck stage mults, total
    mults, R): first restore balance, then don't pay arithmetic for it.
    The unreplicated baseline competes too, so the result is never worse
    than ``plan_graph(n_stages=...)`` — strict improvement is measured,
    not assumed (``benchmarks/table7_fleet.py`` pins it for ResNet-18).
    """
    base = plan_graph(graph, input_rate, n_stages=n_stages, **plan_kwargs)
    if candidates is None:
        sp = base.stage_plan
        mults = base.stage_mults()
        s_bot = max(range(sp.n_stages), key=lambda s: (mults[s], -s))
        candidates = [
            n
            for n in sp.stage_nodes(s_bot)
            if graph.spec(n).kind in REPLICABLE_KINDS
        ]

    def key(plan: GraphPlan, r: int) -> Tuple[int, int, int]:
        return (max(plan.stage_mults()), plan.total_mults, r)

    best, best_key = base, key(base, 1)
    for node in candidates:
        for r in r_options:
            if r < 2:
                continue
            plan = plan_graph(
                graph,
                input_rate,
                n_stages=n_stages,
                replicate=(node, r),
                **plan_kwargs,
            )
            k = key(plan, r)
            if k < best_key:
                best, best_key = plan, k
    return best
