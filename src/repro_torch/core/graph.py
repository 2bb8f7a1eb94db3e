"""DAG rate graph — branch/join rate propagation, skew sizing, DAG DSE.

The port's own copy of the JAX package's ``core/graph.py``.  It lifts
the paper's rate calculus onto an explicit producer/consumer graph,
sizes the join skew FIFOs a branchy dataflow needs, and (with
``n_stages``) cuts the DAG into pipeline stages whose cut-crossing edges
become inter-chip stream buffers (``core.stage_partition``).

Timing model (exact fractions): a node's steady-state output stream is
affine, t_out(m) = offset + (m+1)/q_out, with

    offset(v) = max_{u in preds(v)} offset(u) + C(v) + fill(v),
    fill(v)   = ((k_h-1)//2 * W_in + (k_w-1)//2) / q_in(v).

Plan-threading contract: ``plan_graph`` is the single producer of
per-node kernel plans.  ``GraphPlan.kernel_plan()`` lowers every node's
``LayerImpl`` into an ``ImplPlan`` carrying a concrete Hopper tile
(``core.tiles.select_tile_for_impl``); the graph executor
``models/cnn.py`` dispatches each arithmetic node's kernel with its own
tile and asserts that the tile the kernel executed equals the plan.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from .dse import NON_ARITH_KINDS, LayerImpl, select_impl
from .rate import LayerSpec, RatePoint
from .stage_partition import (
    EdgeTraffic,
    GraphStagePlan,
    LinkDtype,
    StreamBuffer,
    partition_graph,
    plan_node_costs,
    round_robin_placement,
    stage_stream_bits,
    stream_buffers,
)
from .tiles import TileChoice, select_tile_for_impl

JOIN_KINDS = ("add", "concat")


class GraphError(ValueError):
    """Structural or rate inconsistency in a LayerGraph."""


class LayerGraph:
    """A DAG of ``LayerSpec`` nodes with producer→consumer edges.

    Nodes are added in topological order by construction (``add`` requires
    every producer to exist already), so ``topo_order()`` is simply the
    insertion order.
    """

    def __init__(self) -> None:
        self._specs: "OrderedDict[str, LayerSpec]" = OrderedDict()
        self._preds: Dict[str, List[str]] = {}
        self._succs: Dict[str, List[str]] = {}

    def add(self, spec: LayerSpec, inputs: Sequence[str] = ()) -> str:
        name = spec.name
        if name in self._specs:
            raise GraphError(f"duplicate node {name!r}")
        preds = list(inputs)
        for p in preds:
            if p not in self._specs:
                raise GraphError(f"{name}: unknown producer {p!r}")
        self._check_shapes(spec, preds)
        self._specs[name] = spec
        self._preds[name] = preds
        self._succs[name] = []
        for p in preds:
            self._succs[p].append(name)
        return name

    def _check_shapes(self, spec: LayerSpec, preds: List[str]) -> None:
        if spec.kind in JOIN_KINDS:
            if len(preds) < 2:
                raise GraphError(
                    f"{spec.name}: join kind {spec.kind!r} "
                    f"needs >=2 producers, got {len(preds)}"
                )
            for p in preds:
                if self._specs[p].out_hw != spec.in_hw:
                    raise GraphError(
                        f"{spec.name}: producer {p} emits {self._specs[p].out_hw}"
                        f" but join expects {spec.in_hw}"
                    )
            d_ops = [self._specs[p].d_out for p in preds]
            if spec.kind == "add":
                if any(d != spec.d_in for d in d_ops) or spec.d_out != spec.d_in:
                    raise GraphError(
                        f"{spec.name}: add needs equal operand channels "
                        f"(=d_in=d_out), got operands {d_ops}, "
                        f"d_in={spec.d_in}, d_out={spec.d_out}"
                    )
            elif sum(d_ops) != spec.d_in or spec.d_out != spec.d_in:
                raise GraphError(
                    f"{spec.name}: concat d_in must equal sum of operand "
                    f"channels {sum(d_ops)}, got d_in={spec.d_in}, "
                    f"d_out={spec.d_out}"
                )
        elif spec.kind == "merge":
            if len(preds) < 2:
                raise GraphError(
                    f"{spec.name}: merge needs >=2 lane producers, "
                    f"got {len(preds)}"
                )
            for p in preds:
                if self._specs[p].out_hw != spec.in_hw:
                    raise GraphError(
                        f"{spec.name}: lane {p} emits {self._specs[p].out_hw}"
                        f" but merge expects {spec.in_hw}"
                    )
                if self._specs[p].d_out != spec.d_in:
                    raise GraphError(
                        f"{spec.name}: lane {p} has "
                        f"d_out={self._specs[p].d_out}, merge d_in={spec.d_in}"
                    )
            if spec.d_out != spec.d_in or spec.out_hw != spec.in_hw:
                raise GraphError(
                    f"{spec.name}: merge is wiring only — needs "
                    f"d_out == d_in and out_hw == in_hw"
                )
        else:
            if len(preds) > 1:
                raise GraphError(
                    f"{spec.name}: kind {spec.kind!r} takes at "
                    f"most one producer, got {len(preds)}"
                )
            if spec.kind == "split" and (
                spec.d_out != spec.d_in or spec.out_hw != spec.in_hw
            ):
                raise GraphError(
                    f"{spec.name}: split is wiring only — needs "
                    f"d_out == d_in and out_hw == in_hw"
                )
            if preds:
                pred = self._specs[preds[0]]
                if pred.d_out != spec.d_in:
                    raise GraphError(
                        f"{spec.name}: d_in={spec.d_in} but "
                        f"producer {pred.name} has d_out={pred.d_out}"
                    )
                if pred.out_hw != spec.in_hw:
                    raise GraphError(
                        f"{spec.name}: in_hw={spec.in_hw} but "
                        f"producer {pred.name} emits {pred.out_hw}"
                    )

    @classmethod
    def from_chain(cls, layers: Sequence[LayerSpec]) -> "LayerGraph":
        g = cls()
        prev: Optional[str] = None
        for spec in layers:
            prev = g.add(spec, [prev] if prev is not None else [])
        return g

    def spec(self, name: str) -> LayerSpec:
        return self._specs[name]

    def preds(self, name: str) -> List[str]:
        return list(self._preds[name])

    def succs(self, name: str) -> List[str]:
        return list(self._succs[name])

    def topo_order(self) -> List[str]:
        return list(self._specs)

    def __len__(self) -> int:
        return len(self._specs)

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    @property
    def input_nodes(self) -> List[str]:
        return [n for n in self._specs if not self._preds[n]]

    @property
    def output_nodes(self) -> List[str]:
        return [n for n in self._specs if not self._succs[n]]

    def joins(self) -> List[str]:
        return [n for n in self._specs if len(self._preds[n]) > 1]


def propagate_graph(
    graph: LayerGraph, input_rate: Fraction
) -> Tuple[Dict[str, Fraction], Dict[str, RatePoint]]:
    """Exact steady-state rates over the DAG.

    Returns ``(demands, out_points)``: the features/clock each node must
    absorb and the RatePoint each node emits.  Joins require all operand
    *pixel* rates to agree; violations raise.  A 'split' emits the
    per-lane pixel rate q_in / R; a 'merge' restores q_lane * R.
    """
    demands: Dict[str, Fraction] = {}
    out: Dict[str, RatePoint] = {}
    for name in graph.topo_order():
        spec = graph.spec(name)
        preds = graph.preds(name)
        if not preds:
            q_in = Fraction(input_rate) / spec.d_in
        else:
            qs = {out[p].pixels_per_clock for p in preds}
            if len(qs) > 1:
                raise GraphError(
                    f"{name}: operand pixel rates disagree: "
                    + ", ".join(f"{p}={out[p].pixels_per_clock}" for p in preds)
                )
            q_in = qs.pop()
        if spec.kind == "split":
            fanout = len(graph.succs(name))
            if fanout < 2:
                raise GraphError(
                    f"{name}: split needs >=2 lane consumers, got {fanout}"
                )
            demands[name] = q_in * spec.d_in
            q_out = q_in / fanout
        elif spec.kind == "merge":
            demands[name] = q_in * spec.d_in * len(preds)
            q_out = q_in * len(preds)
        else:
            demands[name] = q_in * spec.d_in
            q_out = q_in * spec.spatial_ratio
        out[name] = RatePoint(features_per_clock=q_out * spec.d_out, d=spec.d_out)
    return demands, out


@dataclasses.dataclass(frozen=True)
class NodeTiming:
    """Affine steady-state timing of one node's output stream:
    pixel m leaves at ``offset + (m+1)/q_out`` cycles."""

    name: str
    pass_cycles: Fraction  # C — cycles one pass over a pixel takes
    fill_cycles: Fraction  # sliding-window row banking before 1st output
    offset: Fraction  # stream intercept (cycles)
    q_in: Fraction  # pixels/clock consumed
    q_out: Fraction  # pixels/clock emitted


def pass_cycles(impl: LayerImpl) -> Fraction:
    """Cycles per pixel pass."""
    if impl.mults == 0:
        return Fraction(max(1, impl.layer.d_in // max(1, impl.j)))
    return Fraction(impl.configs)


def fill_pixels(spec: LayerSpec) -> int:
    """Input pixels a sliding window banks before its first valid output
    ('same' padding: half a kernel of rows + half a row of columns)."""
    if spec.kind in ("conv", "dwconv", "pool") and max(spec.kernel) > 1:
        return (spec.kernel[0] - 1) // 2 * spec.in_hw[1] + (spec.kernel[1] - 1) // 2
    return 0


def decimation_keep(spec: LayerSpec) -> int:
    """1-in-keep pixel survival through this node (1 for non-decimating)."""
    ratio = 1 / spec.spatial_ratio
    if ratio <= 1:
        return 1
    if ratio.denominator != 1:
        raise GraphError(
            f"{spec.name}: non-integer decimation {ratio} unsupported in "
            f"graph timing (pad dims so in_px is a multiple of out_px)"
        )
    return int(ratio)


def compute_timing(
    graph: LayerGraph,
    impls: Dict[str, LayerImpl],
    input_rate: Fraction,
) -> Dict[str, NodeTiming]:
    """Solve the offset recurrence over topological order: offsets
    accumulate C + fill along the longest path."""
    timing: Dict[str, NodeTiming] = {}
    for name in graph.topo_order():
        spec = graph.spec(name)
        preds = graph.preds(name)
        if not preds:
            o_in = Fraction(0)
            q_in = Fraction(input_rate) / spec.d_in
        else:
            o_in = max(timing[p].offset for p in preds)
            q_in = timing[preds[0]].q_out
        c = pass_cycles(impls[name])
        fill = Fraction(fill_pixels(spec)) / q_in if fill_pixels(spec) else Fraction(0)
        if spec.kind == "split":
            q_out = q_in / len(graph.succs(name))
        elif spec.kind == "merge":
            q_out = q_in * len(graph.preds(name))
        else:
            q_out = q_in * spec.spatial_ratio
        timing[name] = NodeTiming(
            name=name,
            pass_cycles=c,
            fill_cycles=fill,
            offset=o_in + c + fill,
            q_in=q_in,
            q_out=q_out,
        )
    return timing


@dataclasses.dataclass(frozen=True)
class JoinBuffer:
    """Analytically sized skew FIFO on one in-edge of a join node."""

    join: str
    src: str  # producer whose stream this FIFO parks
    skew_cycles: Fraction  # slowest-branch offset minus this branch's
    q: Fraction  # pixel rate through the join
    d: int  # channels per pixel on this edge
    bound_pixels: int  # max pixels resident (the analytical bound)
    width_bits: int  # FIFO word = one stream beat
    depth_words: int

    @property
    def bits(self) -> int:
        return self.width_bits * self.depth_words


def _fifo(join, src, skew, q, d, bound) -> JoinBuffer:
    lanes = max(1, math.ceil(q * d))
    return JoinBuffer(
        join=join,
        src=src,
        skew_cycles=skew,
        q=q,
        d=d,
        bound_pixels=bound,
        width_bits=8 * lanes,
        depth_words=max(2, math.ceil(Fraction(bound * d, lanes))),
    )


def join_buffers(
    graph: LayerGraph,
    impls: Dict[str, LayerImpl],
    timing: Dict[str, NodeTiming],
) -> List[JoinBuffer]:
    """Size the skew FIFO on every join in-edge: floor(skew * q) + P
    pixels, plus a deal burst of ceil(px * (R-1) / R) on merge lanes."""
    buffers: List[JoinBuffer] = []
    for join in graph.joins():
        preds = graph.preds(join)
        spec = graph.spec(join)
        o_max = max(timing[p].offset for p in preds)
        q = timing[join].q_in
        burst = 0
        if spec.kind == "merge":
            px = spec.in_hw[0] * spec.in_hw[1]
            burst = math.ceil(Fraction(px * (len(preds) - 1), len(preds)))
        for p in preds:
            skew = o_max - timing[p].offset
            bound = math.floor(skew * q) + max(1, impls[join].p_raw) + burst
            buffers.append(_fifo(join, p, skew, q, graph.spec(p).d_out, bound))
    return buffers


def deal_buffers(
    graph: LayerGraph,
    impls: Dict[str, LayerImpl],
    timing: Dict[str, NodeTiming],
) -> List[JoinBuffer]:
    """Size the deal FIFO on every split -> lane edge: the lane fills to
    ceil(px * (R-1) / R) pixels during its turn."""
    buffers: List[JoinBuffer] = []
    for name in graph.topo_order():
        spec = graph.spec(name)
        if spec.kind != "split":
            continue
        lanes = graph.succs(name)
        px = spec.out_hw[0] * spec.out_hw[1]
        burst = math.ceil(Fraction(px * (len(lanes) - 1), len(lanes)))
        for lane in lanes:
            bound = burst + max(1, impls[lane].p_raw)
            buffers.append(
                _fifo(lane, name, Fraction(0), timing[lane].q_in, spec.d_out, bound)
            )
    return buffers


@dataclasses.dataclass(frozen=True)
class ImplPlan:
    """Per-node contract handed from the DSE to the kernel executor.

    Produced only by ``GraphPlan.kernel_plan()``; consumed only by the
    graph executor (``models/cnn.py``), which launches each node's
    kernel with ``tile`` and asserts the executed tiling matches it.
    ``demand`` is the decimation-adjusted rate this node must absorb.
    """

    name: str
    kind: str
    j: int  # input features/clock per phase (Eq. 9)
    h: int  # outputs time-multiplexed per unit
    p: int  # pixel phases after stride pruning
    demand: Fraction  # decimation-adjusted features/clock
    q_in: Fraction  # pixels/clock entering the node
    tile: Optional[TileChoice]  # None for non-arithmetic (wiring) kinds
    batch: Optional[int] = None  # serving batch the tile's bm was pinned to

    @property
    def has_kernel(self) -> bool:
        return self.tile is not None


@dataclasses.dataclass
class GraphPlan:
    """A complete hardware plan for a LayerGraph at one input rate.

    When planned with ``n_stages`` the plan also carries the multi-chip
    partition: ``stage_plan`` (the DAG cut) and ``stream_bufs`` (the FIFO
    on every cut-crossing edge).  Stream buffers re-time and never
    re-rate, so each node's demand is the post-cut rate its (j, h) was
    chosen against, and its tile does not change with the cut.
    """

    graph: LayerGraph
    input_rate: Fraction
    scheme: str
    impls: "OrderedDict[str, LayerImpl]"
    demands: Dict[str, Fraction]
    out_points: Dict[str, RatePoint]
    timing: Dict[str, NodeTiming]
    buffers: List[JoinBuffer]
    stage_plan: Optional[GraphStagePlan] = None
    stream_bufs: Optional[List[StreamBuffer]] = None
    # Wire format of cut-crossing activations (str, or per-producer
    # mapping): what every stream buffer's width was sized with.
    link_dtype: LinkDtype = "int8"
    # Multi-CLP replications applied before planning (core.replicate
    # records; empty for an unreplicated plan).
    replications: tuple = ()

    @property
    def total_mults(self) -> int:
        return sum(i.mults for i in self.impls.values())

    @property
    def infeasible_nodes(self) -> List[str]:
        """Nodes whose chosen capacity cannot absorb their demand."""
        return [n for n, i in self.impls.items() if not i.feasible]

    @property
    def continuous_flow(self) -> bool:
        return not self.infeasible_nodes

    def buffer_for(self, join: str, src: str) -> JoinBuffer:
        for b in self.buffers:
            if b.join == join and b.src == src:
                return b
        raise KeyError((join, src))

    # -- multi-chip stage introspection (requires n_stages planning) ------

    def _require_stages(self) -> GraphStagePlan:
        if self.stage_plan is None:
            raise GraphError(
                "plan has no stage partition — call plan_graph(..., "
                "n_stages=S)"
            )
        return self.stage_plan

    def stage_mults(self) -> List[int]:
        """DSE-selected multiplier count per stage (what the cut balances)."""
        sp = self._require_stages()
        return [
            sum(self.impls[n].mults for n in sp.stage_nodes(s))
            for s in range(sp.n_stages)
        ]

    def stage_infeasible_nodes(self) -> List[List[str]]:
        """Per stage, the nodes whose capacity cannot absorb the post-cut
        rate (empty everywhere for scheme 'ours')."""
        sp = self._require_stages()
        return [
            [n for n in sp.stage_nodes(s) if not self.impls[n].feasible]
            for s in range(sp.n_stages)
        ]

    def cut_rates(self) -> List[Fraction]:
        """Features/clock crossing each interior cut — the inter-chip
        link load (cut c separates stage c from stage c+1)."""
        sp = self._require_stages()
        rates = [Fraction(0)] * (sp.n_stages - 1)
        for sb in self.stream_bufs or []:
            for c in range(sb.src_stage, sb.dst_stage):
                rates[c] += sb.q * sb.d
        return rates

    @property
    def total_stream_bits(self) -> int:
        """Bits of inter-chip stream buffering the partition adds.  Raises
        on an unpartitioned plan: a silent 0 would read as 'the cut is
        free'."""
        self._require_stages()
        return sum(b.bits for b in self.stream_bufs or [])

    def stage_stream_bits(self) -> List[int]:
        """Cut-crossing buffer bits parked on each stage's chip (buffers
        live on the consuming stage) — what a ``bram_budget`` caps."""
        sp = self._require_stages()
        return list(stage_stream_bits(self.stream_bufs or [], sp.n_stages))

    def kernel_plan(
        self,
        *,
        batch: Optional[int] = None,
    ) -> "OrderedDict[str, ImplPlan]":
        """Lower this hardware plan to the executor's per-node contract.

        Arithmetic nodes carry the Hopper tile derived from their (j, h)
        by ``core.tiles.select_tile_for_impl`` (j -> bk floor, d_out/h ->
        bn floor, both grown only upward, so Eq. 9 survives).  ``batch``
        pins the pixel tile bm to a divisor of the batch-flattened
        runtime m.  Keys preserve topological order.
        """
        plans: "OrderedDict[str, ImplPlan]" = OrderedDict()
        for name, impl in self.impls.items():
            spec = self.graph.spec(name)
            tile = None
            if spec.kind not in NON_ARITH_KINDS:
                tile = select_tile_for_impl(impl, batch=batch)
            plans[name] = ImplPlan(
                name=name,
                kind=spec.kind,
                j=impl.j,
                h=impl.h,
                p=impl.p,
                demand=impl.demand,
                q_in=self.timing[name].q_in,
                tile=tile,
                batch=batch,
            )
        return plans


def _plan_edge_traffic(plan: GraphPlan) -> Dict[Tuple[str, str], EdgeTraffic]:
    """Exact per-edge traffic from a solved plan — the q_in / d /
    absorbed-FIFO base that ``stream_buffers`` prices, handed to the
    budgeted DP so feasibility and pricing agree bit for bit."""
    graph = plan.graph
    out: Dict[Tuple[str, str], EdgeTraffic] = {}
    for dst in graph.topo_order():
        q = plan.timing[dst].q_in
        for src in graph.preds(dst):
            try:
                base = plan.buffer_for(dst, src).bound_pixels
            except KeyError:
                base = 1
            out[(src, dst)] = EdgeTraffic(
                src=src,
                dst=dst,
                q=q,
                d=graph.spec(src).d_out,
                base_pixels=base,
            )
    return out


def plan_graph(
    graph: LayerGraph,
    input_rate: Fraction,
    *,
    scheme: str = "ours",
    prefer_large_h: bool = True,
    objective: str = "max_h",
    n_stages: Optional[int] = None,
    chain_cuts: bool = False,
    link_dtype: LinkDtype = "int8",
    bram_budget=None,
    replicate=None,
    n_devices: Optional[int] = None,
) -> GraphPlan:
    """Select an implementation for every node of a DAG.

    Demands propagate exactly as the fluid recurrence; joins add the
    operand-consistency constraint and the skew analysis.

    ``n_stages`` turns on multi-chip planning: the DAG is cut into that
    many contiguous-in-topo-order stages by the min-bottleneck / min-cut
    DP (``core.stage_partition.partition_graph``), balancing the
    DSE-selected per-node multiplier count, and every cut-crossing edge
    is sized as an inter-chip ``StreamBuffer`` with
    ``DEFAULT_LINK_CYCLES`` of slack per chip boundary crossed.
    ``chain_cuts=True`` restricts boundaries to single-stream positions.
    ``link_dtype`` ('int8' / 'bf16' / 'fp32', or a per-producer mapping)
    sets the wire format of cut-crossing activations: it scales the DP's
    cut weights and every stream buffer's width.  ``bram_budget`` (bits
    per chip; scalar or one per stage) admits only cuts whose parked
    stream bits fit each chip, and raises ``ValueError`` when none does.  ``n_devices`` records a
    round-robin device placement on the stage plan (metadata only).

    ``replicate`` turns on Multi-CLP bottleneck replication before
    planning: a ``(node, R)`` pair, a ``{node: R}`` mapping, or a bare
    ``R`` (the max-mults bottleneck).  The node is cloned R ways behind
    a round-robin frame splitter and an order-preserving merger
    (``core.replicate``); the applied records land in
    ``GraphPlan.replications``.
    """
    if n_devices is not None and n_stages is None:
        raise GraphError("n_devices= requires n_stages= (placement is per stage)")
    replications: tuple = ()
    if replicate is not None:
        from .replicate import apply_replications

        graph, replications = apply_replications(
            graph, replicate, input_rate=input_rate, scheme=scheme
        )
    demands, out_points = propagate_graph(graph, input_rate)
    impls: "OrderedDict[str, LayerImpl]" = OrderedDict()
    for name in graph.topo_order():
        impls[name] = select_impl(
            graph.spec(name),
            demands[name],
            scheme=scheme,
            prefer_large_h=prefer_large_h,
            objective=objective,
        )
    timing = compute_timing(graph, impls, input_rate)
    plan = GraphPlan(
        graph=graph,
        input_rate=Fraction(input_rate),
        scheme=scheme,
        impls=impls,
        demands=demands,
        out_points=out_points,
        timing=timing,
        buffers=join_buffers(graph, impls, timing)
        + deal_buffers(graph, impls, timing),
        link_dtype=link_dtype,
        replications=replications,
    )
    if n_stages is not None:
        plan.stage_plan = partition_graph(
            graph,
            plan_node_costs(plan),
            n_stages,
            chain_cuts=chain_cuts,
            link_dtype=link_dtype,
            bram_budget=bram_budget,
            edge_traffic=(
                _plan_edge_traffic(plan) if bram_budget is not None else None
            ),
        )
        if n_devices is not None:
            plan.stage_plan = dataclasses.replace(
                plan.stage_plan,
                placement=round_robin_placement(n_stages, n_devices),
            )
        plan.stream_bufs = stream_buffers(plan, plan.stage_plan, link_dtype=link_dtype)
        if plan.stage_plan.bram_budget is not None:
            parked = stage_stream_bits(plan.stream_bufs, n_stages)
            if tuple(parked) != plan.stage_plan.stage_buffer_bits:
                raise GraphError(
                    f"budgeted DP parked bits {plan.stage_plan.stage_buffer_bits}"
                    f" != priced stream buffers {tuple(parked)} — "
                    f"edge_buffer_geometry drifted from stream_buffers"
                )
    return plan
