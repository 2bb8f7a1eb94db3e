"""Rate-aware pipeline-stage partitioning — chains AND LayerGraph DAGs.

The port's own copy of the JAX package's ``core/stage_partition.py``.

The paper's continuous-flow constraint (every unit absorbs its input
rate, j/h >= r) applies one level up when a CNN is split across chips:
every *stage* must absorb the rate arriving at its cut, and the
bottleneck stage sets the flow rate while every other stage idles in
proportion — exactly the under-utilization the paper attacks, at
multi-chip granularity (cf. Shen et al., "Maximizing CNN Accelerator
Efficiency Through Resource Partitioning": partitioned multi-CLP
designs recover this idle capacity).

Chain tools (the original API, kept for the LM serving study):

* ``partition_min_bottleneck`` — contiguous-chain DP: assign layers to
  S stages minimizing max stage cost.
* ``partition_blocks`` — same, boundaries restricted to ``block``
  multiples (the Eq. (7)/(8) divisibility analogue for scanned stacks).
* ``allocate_chips`` — BestRate for chips: proportional allocation in
  mesh-row quanta, optionally under per-stage heterogeneous budgets.

DAG tools (the LayerGraph lift):

* ``partition_graph`` — contiguous-in-topo-order cuts over a DAG.  A
  cut is the *set of edges* spanning a topo position, not a layer
  index: residual/branch edges crossing a cut are legal (they become
  inter-chip stream buffers), which is precisely what the chain
  formulation cannot express.  ``chain_cuts=True`` restricts
  boundaries to positions crossed by exactly one edge — the best a
  chain DP can do on the same graph — and is the baseline
  ``benchmarks/table5_partition.py`` compares against.  The DP
  minimizes (bottleneck stage cost, total cut width) lexicographically:
  min-bottleneck first, then min-cut among optima.
* ``stream_buffers`` — size the FIFO on every cut-crossing edge.  A
  skew FIFO whose branch and join land in different stages becomes an
  inter-chip stream buffer: its depth is the ``core.graph``
  join-skew bound (the offset difference already equals the
  cross-stage latency difference of the trunk path) plus link slack
  for every chip boundary crossed.  Each buffer carries a
  ``link_dtype`` (fp32 / bf16 / int8) setting the bits per feature on
  the link — narrow crossings shrink both the buffer and the cut
  weight the DP minimizes.
* ``bram_budget`` on ``partition_graph`` — the Petrica et al. lift
  ("Memory-Efficient Dataflow Inference for Deep CNNs on FPGA"):
  on-chip memory, not arithmetic, bounds deep dataflow designs, so the
  cut-crossing buffer bits parked on each chip become a *constraint*,
  not a tie-break.  The DP is then min-bottleneck **subject to** every
  stage's incoming stream-buffer bits fitting its chip's budget,
  falling back to the next-best bottleneck when the min-cut optimum is
  infeasible (``_budgeted_search``).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from fractions import Fraction
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

# Cycles of slack per chip-boundary crossing: serialization + transport
# latency of one inter-chip hop (Aurora-class link at core clock).  The
# stream buffer must park this many cycles of pixels on top of the
# analytic skew bound so the downstream chip never starves.
DEFAULT_LINK_CYCLES = 64

# Bits per feature a cut-crossing link carries.  'int8' is the paper's
# 8-bit datapath (the historical hardcoded width); 'fp32' is what an
# unquantized crossing actually costs — the latent 4x under-pricing the
# link_dtype machinery closes.
LINK_DTYPE_BITS: Dict[str, int] = {"int8": 8, "bf16": 16, "fp32": 32}

# str = one dtype for every crossing; mapping = per-producer override
# (keyed by the *src* node name — one physical stream leaves each
# producer, so all its out-edges share a width).
LinkDtype = Union[str, Mapping[str, str]]


def resolve_link_dtype(link_dtype: LinkDtype, src: str) -> str:
    """The link dtype of the crossing stream leaving ``src``."""
    if isinstance(link_dtype, str):
        dtype = link_dtype
    else:
        dtype = link_dtype.get(src, "int8")
    if dtype not in LINK_DTYPE_BITS:
        raise ValueError(
            f"unknown link_dtype {dtype!r} for edge source {src!r} "
            f"(known: {sorted(LINK_DTYPE_BITS)})"
        )
    return dtype


@dataclasses.dataclass(frozen=True)
class StagePlan:
    boundaries: Tuple[int, ...]  # stage s = layers [b[s], b[s+1])
    stage_cost: Tuple[float, ...]  # cost per stage (FLOPs or seconds)
    bottleneck: float  # max stage cost
    balance: float  # mean/max utilization across stages


def _balance(stage_cost: Sequence[float]) -> float:
    bot = max(stage_cost)
    return (sum(stage_cost) / len(stage_cost)) / bot if bot else 1.0


def _dp_min_bottleneck(
    costs: Sequence[float],
    n_stages: int,
    positions: Sequence[int],
    cut_weight: Optional[Mapping[int, float]] = None,
) -> Tuple[int, ...]:
    """Contiguous min-bottleneck DP over a restricted boundary set.

    ``positions`` are the legal interior boundary indices (a boundary at
    ``i`` splits ``costs[:i]`` from ``costs[i:]``); 0 and ``len(costs)``
    are implicitly legal.  With ``cut_weight`` a second pass minimizes
    the total cut weight *subject to* the optimal bottleneck — min-cut
    among min-bottleneck optima, exactly (a one-pass lexicographic DP
    is not: a worse-bottleneck prefix can still tie on the final max).
    Returns the chosen boundaries, ends included.  O(P^2 * S) with
    P = len(positions) + 2.
    """
    n = len(costs)
    pts = sorted({0, n, *positions})
    if pts[0] != 0 or pts[-1] != n:
        raise ValueError(f"positions {positions} outside [0, {n}]")
    if n_stages <= 0 or n_stages > len(pts) - 1:
        raise ValueError(f"n_stages={n_stages} with {len(pts) - 1} available segments")
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def seg(a: int, b: int) -> float:
        return prefix[b] - prefix[a]

    inf = float("inf")
    m = len(pts)
    # pass 1: dp[s][i] = min bottleneck for pts[:i+1] split into s stages
    dp = [[inf] * m for _ in range(n_stages + 1)]
    back = [[0] * m for _ in range(n_stages + 1)]
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for i in range(s, m):
            for k in range(s - 1, i):
                if dp[s - 1][k] == inf:
                    continue
                cand = max(dp[s - 1][k], seg(pts[k], pts[i]))
                if cand < dp[s][i]:
                    dp[s][i] = cand
                    back[s][i] = k
    bot = dp[n_stages][m - 1]
    if bot == inf:
        raise ValueError(f"no {n_stages}-stage partition over positions {pts}")

    if cut_weight is not None:
        # pass 2: min total cut weight subject to every segment <= bot
        cap = bot * (1.0 + 1e-12)
        dp2 = [[inf] * m for _ in range(n_stages + 1)]
        dp2[0][0] = 0.0
        for s in range(1, n_stages + 1):
            for i in range(s, m):
                for k in range(s - 1, i):
                    if dp2[s - 1][k] == inf or seg(pts[k], pts[i]) > cap:
                        continue
                    cand = dp2[s - 1][k] + (
                        cut_weight.get(pts[k], 0.0) if k > 0 else 0.0
                    )
                    if cand < dp2[s][i]:
                        dp2[s][i] = cand
                        back[s][i] = k

    bounds = [n]
    i = m - 1
    for s in range(n_stages, 0, -1):
        i = back[s][i]
        bounds.append(pts[i])
    return tuple(reversed(bounds))


def partition_min_bottleneck(costs: Sequence[float], n_stages: int) -> StagePlan:
    """Contiguous partition of ``costs`` into ``n_stages`` minimizing the
    bottleneck stage.  O(n^2 * S) DP — layer counts are small (<= few
    hundred)."""
    n = len(costs)
    if n_stages <= 0 or n_stages > n:
        raise ValueError(f"n_stages={n_stages} for {n} layers")
    bounds = _dp_min_bottleneck(costs, n_stages, range(1, n))
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    stage_cost = tuple(
        prefix[bounds[s + 1]] - prefix[bounds[s]] for s in range(n_stages)
    )
    return StagePlan(
        boundaries=bounds,
        stage_cost=stage_cost,
        bottleneck=max(stage_cost),
        balance=_balance(stage_cost),
    )


def partition_blocks(costs: Sequence[float], n_stages: int, block: int) -> StagePlan:
    """Same, but boundaries restricted to multiples of ``block`` (scanned
    layer stacks can only split between scan blocks — the divisibility
    constraint, Eq. (7)/(8) analogue)."""
    n = len(costs)
    if n % block:
        raise ValueError(f"{n} layers not divisible by block {block}")
    merged = [sum(costs[i : i + block]) for i in range(0, n, block)]
    plan = partition_min_bottleneck(merged, n_stages)
    return StagePlan(
        boundaries=tuple(b * block for b in plan.boundaries),
        stage_cost=plan.stage_cost,
        bottleneck=plan.bottleneck,
        balance=plan.balance,
    )


def allocate_chips(
    stage_cost: Sequence[float],
    total_chips: int,
    *,
    granularity: int = 1,
    budgets: Optional[Sequence[int]] = None,
) -> List[int]:
    """Allocate chips to stages ~proportional to cost (largest-remainder),
    in ``granularity`` quanta (mesh-row constraint), every stage >= 1
    quantum.

    This is the continuous-flow sizing: stage service rate chips/cost
    must cover the shared arrival rate; allocating proportional to cost
    maximizes the minimum service rate for a fixed budget.

    ``budgets`` caps each stage's allocation (heterogeneous per-stage
    budgets: boards of different sizes, partially reserved meshes).
    With caps the allocation may not exhaust ``total_chips`` — the
    capped sum is returned rather than overfilling a stage.
    """
    q = total_chips // granularity
    n = len(stage_cost)
    if q < n:
        raise ValueError(f"{total_chips} chips / gran {granularity} < {n} stages")
    if budgets is None:
        caps = [q] * n
    else:
        if len(budgets) != n:
            raise ValueError(f"{len(budgets)} budgets for {n} stages")
        caps = [b // granularity for b in budgets]
        if any(c < 1 for c in caps):
            starved = [i for i, c in enumerate(caps) if c < 1]
            raise ValueError(f"stage budgets {starved} below one {granularity}-chip quantum")
    total = sum(stage_cost) or 1.0
    raw = [c / total * q for c in stage_cost]
    base = [min(cap, max(1, int(f))) for f, cap in zip(raw, caps)]
    while sum(base) > q:  # pull back from the most over-allocated
        shrinkable = [k for k in range(n) if base[k] > 1]
        if not shrinkable:
            break  # every stage at its 1-quantum floor (q >= n guarantees fit)
        i = max(shrinkable, key=lambda k: base[k] - raw[k])
        base[i] -= 1
    # hand remaining quanta to the most-starved uncapped stages
    # (largest cost per allocated chip)
    while sum(base) < q:
        open_stages = [i for i in range(n) if base[i] < caps[i]]
        if not open_stages:
            break
        i = max(open_stages, key=lambda k: stage_cost[k] / base[k])
        base[i] += 1
    return [b * granularity for b in base]


def service_rates(
    stage_cost: Sequence[float],
    chips: Sequence[int],
    flops_per_chip: float,
) -> List[float]:
    """Tokens/sec each stage can sustain (cost in FLOPs/token)."""
    return [flops_per_chip * c / max(sc, 1e-30) for sc, c in zip(stage_cost, chips)]


# ==========================================================================
# DAG partitioning (the LayerGraph lift)
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class EdgeTraffic:
    """Steady-state traffic on one graph edge — what the budgeted DP and
    ``stream_buffers`` both size a cut-crossing FIFO from.

    ``base_pixels`` is the analytic skew/deal bound the buffer absorbs
    when the edge carries a join or deal FIFO (1 for plain pipeline
    edges); ``q`` / ``d`` are the pixel rate and channel count.
    ``plan_graph`` builds these from the solved timing; callers without
    a plan get the rate-free approximation ``default_edge_traffic``.
    """

    src: str
    dst: str
    q: Fraction  # pixel rate through the edge
    d: int  # channels per pixel
    base_pixels: int = 1  # absorbed skew/deal FIFO bound


def default_edge_traffic(graph) -> Dict[Tuple[str, str], EdgeTraffic]:
    """Rate-free traffic (q = 1 pixel/clock, no absorbed skew) for every
    edge — the approximation used when ``partition_graph`` is handed a
    ``bram_budget`` but no plan-derived ``edge_traffic``."""
    out: Dict[Tuple[str, str], EdgeTraffic] = {}
    for v in graph.topo_order():
        for u in graph.preds(v):
            out[(u, v)] = EdgeTraffic(
                src=u, dst=v, q=Fraction(1), d=graph.spec(u).d_out
            )
    return out


def edge_buffer_geometry(
    traffic: EdgeTraffic,
    crossings: int,
    *,
    bits_per_feature: int,
) -> Tuple[int, int, int, int]:
    """(bound_pixels, lanes, width_bits, depth_words) of the stream
    buffer an edge needs when it crosses ``crossings`` chip boundaries.

    The single source of truth for cut-crossing FIFO sizing: both
    ``stream_buffers`` (pricing a chosen partition) and the budgeted DP
    (checking candidate partitions) call this, so a plan admitted under
    a ``bram_budget`` can never be re-priced over it afterwards.
    """
    bound = traffic.base_pixels + math.ceil(crossings * DEFAULT_LINK_CYCLES * traffic.q)
    lanes = max(1, math.ceil(traffic.q * traffic.d))
    width = bits_per_feature * lanes
    depth = max(2, math.ceil(Fraction(bound * traffic.d, lanes)))
    return bound, lanes, width, depth


@dataclasses.dataclass(frozen=True)
class GraphStagePlan:
    """A contiguous-in-topo-order partition of a ``LayerGraph``.

    Stage ``s`` owns ``order[boundaries[s]:boundaries[s+1]]``.  The cut
    between stages is not a layer index but the set of edges spanning
    the boundary position — ``cut_edges[b]`` lists the (src, dst) pairs
    crossing interior boundary ``b`` (so a residual shortcut whose
    branch and join land in different stages appears here, and is
    priced as an inter-chip stream buffer by ``stream_buffers``).

    When partitioned under a ``bram_budget``, ``bram_budget`` records
    the per-stage bit budgets the DP honoured and ``stage_buffer_bits``
    the cut-crossing buffer bits actually parked on each stage (always
    elementwise <= the budget; stage 0 has no incoming cut, so 0).

    ``placement`` (optional) records which device *ordinal* each stage
    runs on — device indices, not device objects, so the core stays
    free of any array library (``models.cnn.resolve_stage_devices``
    maps them onto the executor's pool).
    """

    order: Tuple[str, ...]
    boundaries: Tuple[int, ...]  # len n_stages + 1; 0 and len(order) ends
    stage_cost: Tuple[float, ...]
    bottleneck: float
    balance: float  # mean/max stage cost
    cut_edges: Tuple[Tuple[Tuple[str, str], ...], ...]  # per interior cut
    chain_legal: bool  # every cut crossed by exactly one edge
    bram_budget: Optional[Tuple[int, ...]] = None  # bits per stage, if budgeted
    stage_buffer_bits: Optional[Tuple[int, ...]] = None  # bits parked per stage
    placement: Optional[Tuple[int, ...]] = None  # device ordinal per stage

    @property
    def n_stages(self) -> int:
        return len(self.stage_cost)

    def stage_nodes(self, s: int) -> Tuple[str, ...]:
        return self.order[self.boundaries[s] : self.boundaries[s + 1]]

    def stage_index(self) -> Dict[str, int]:
        """node name -> owning stage."""
        idx: Dict[str, int] = {}
        for s in range(self.n_stages):
            for name in self.stage_nodes(s):
                idx[name] = s
        return idx

    def place(self, n_devices: int) -> "GraphStagePlan":
        """A copy with stage ``s`` assigned to device ordinal
        ``s % n_devices`` (the round-robin ``DevicePipeline`` layout)."""
        return dataclasses.replace(
            self, placement=round_robin_placement(self.n_stages, n_devices)
        )


def round_robin_placement(n_stages: int, n_devices: int) -> Tuple[int, ...]:
    """Stage ``s`` -> device ordinal ``s % n_devices``.

    The canonical multi-device layout: with at least as many devices as
    stages every stage gets its own device (true pipeline overlap);
    with fewer, stages fold round-robin and co-resident stages simply
    serialize on their shared device — the schedule stays correct, only
    the overlap shrinks.
    """
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return tuple(s % n_devices for s in range(n_stages))


def _crossing_map(graph, order: Sequence[str]) -> Dict[int, List[Tuple[str, str]]]:
    """For every interior topo position, the edges (u, v) spanning it
    (idx(u) < pos <= idx(v)) — one sweep over the edge set."""
    idx = {name: i for i, name in enumerate(order)}
    out: Dict[int, List[Tuple[str, str]]] = {pos: [] for pos in range(1, len(order))}
    for v in order:
        for u in graph.preds(v):
            for pos in range(idx[u] + 1, idx[v] + 1):
                out[pos].append((u, v))
    return out


def legal_cut_positions(graph, *, chain_only: bool = False) -> List[int]:
    """Interior topo positions where a cut may be placed.

    Every interior position is legal on the DAG formulation (crossing
    edges become stream buffers).  ``chain_only`` keeps just the
    positions a chain DP could express: exactly one edge crosses, i.e.
    the graph narrows to a single stream there — between ResNet blocks
    but never inside one (the shortcut would span the cut).
    """
    crossing = _crossing_map(graph, graph.topo_order())
    return [
        pos
        for pos, edges in crossing.items()
        if not (chain_only and len(edges) != 1)
    ]


def _stage_bits(
    graph,
    order: Sequence[str],
    bounds: Sequence[int],
    edge_traffic: Mapping[Tuple[str, str], EdgeTraffic],
    link_dtype: LinkDtype,
) -> Tuple[int, ...]:
    """Cut-crossing buffer bits parked on each stage of a candidate
    partition — same geometry as ``stream_buffers``, parked on the
    consuming (dst) stage, matching ``estimate_stages`` attribution."""
    interior = list(bounds[1:-1])
    n_stages = len(bounds) - 1
    idx = {name: i for i, name in enumerate(order)}

    def stage_of(i: int) -> int:
        return bisect.bisect_right(interior, i)

    bits = [0] * n_stages
    for v in order:
        sv = stage_of(idx[v])
        for u in graph.preds(v):
            crossings = sv - stage_of(idx[u])
            if crossings <= 0:
                continue
            bpf = LINK_DTYPE_BITS[resolve_link_dtype(link_dtype, u)]
            _, _, width, depth = edge_buffer_geometry(
                edge_traffic[(u, v)],
                crossings,
                bits_per_feature=bpf,
            )
            bits[sv] += width * depth
    return tuple(bits)


def _budgeted_search(
    cost_list: Sequence[float],
    n_stages: int,
    positions: Sequence[int],
    cut_weight: Mapping[int, float],
    feasible,
) -> Optional[Tuple[int, ...]]:
    """Exhaustive fallback when the unconstrained optimum busts the
    budget: lexicographic min (bottleneck, total cut weight) over all
    boundary combinations whose parked bits ``feasible`` accepts.

    DFS over increasing interior boundaries, pruning any prefix whose
    running max segment already exceeds the best feasible bottleneck
    (segments only grow rightward, so the loop breaks, not skips).
    Among exact (bottleneck, cut) ties the lexicographically smallest
    boundary tuple wins — the DFS visits tuples in that order and only
    replaces on strict improvement.  Returns None if nothing fits.
    """
    n = len(cost_list)
    prefix = [0.0]
    for c in cost_list:
        prefix.append(prefix[-1] + c)

    def seg(a: int, b: int) -> float:
        return prefix[b] - prefix[a]

    pts = sorted(positions)
    best: Optional[Tuple[float, float, Tuple[int, ...]]] = None
    chosen: List[int] = []

    def dfs(start: int, prev: int, maxseg: float, cutw: float) -> None:
        nonlocal best
        remaining = n_stages - 1 - len(chosen)
        if remaining == 0:
            bot = max(maxseg, seg(prev, n))
            if best is not None and (bot, cutw) >= best[:2]:
                return
            bounds = (0, *chosen, n)
            if feasible(bounds):
                best = (bot, cutw, bounds)
            return
        for j in range(start, len(pts) - remaining + 1):
            pos = pts[j]
            if pos <= prev:
                continue
            new_max = max(maxseg, seg(prev, pos))
            if best is not None and new_max > best[0]:
                break  # seg(prev, pos) grows with pos — no later j helps
            chosen.append(pos)
            dfs(j + 1, pos, new_max, cutw + cut_weight.get(pos, 0.0))
            chosen.pop()

    dfs(0, 0, 0.0, 0.0)
    return best[2] if best is not None else None


def partition_graph(
    graph,
    costs: Mapping[str, float],
    n_stages: int,
    *,
    chain_cuts: bool = False,
    link_dtype: LinkDtype = "int8",
    bram_budget: Optional[Union[int, Sequence[int]]] = None,
    edge_traffic: Optional[Mapping[Tuple[str, str], EdgeTraffic]] = None,
) -> GraphStagePlan:
    """Min-bottleneck partition of a ``LayerGraph`` into ``n_stages``.

    ``costs`` maps every node to its stage cost — in the rate-matched
    flow this is the DSE-selected multiplier count from a ``GraphPlan``
    (``plan_node_costs``), NOT raw FLOPs: the hardware the cut balances
    is the hardware the DSE actually instantiates.

    The DP minimizes (bottleneck, total cut width in bits)
    lexicographically over contiguous-in-topo-order stages.  Cut width
    is ``LINK_DTYPE_BITS[link_dtype] * d_out`` per crossing edge, so a
    narrow link is genuinely cheaper to cut than a wide one.  With
    ``chain_cuts=False`` (the DAG formulation) every interior position
    is a legal boundary; edges spanning it are recorded in
    ``cut_edges`` and later priced by ``stream_buffers``.  With
    ``chain_cuts=True`` boundaries are restricted to single-stream
    positions — the chain-DP baseline.

    ``bram_budget`` (bits; a scalar for homogeneous chips or one value
    per stage, mirroring ``allocate_chips`` budgets) turns the buffer
    bits from a tie-break into a constraint: every stage's incoming
    cut-crossing buffer bits (sized by ``edge_buffer_geometry`` on
    ``edge_traffic``, defaulting to the rate-free
    ``default_edge_traffic``) must fit its chip.  When the
    unconstrained optimum already fits it is returned unchanged;
    otherwise ``_budgeted_search`` finds the best feasible fallback, or
    raises ``ValueError`` when no partition fits.
    """
    order = graph.topo_order()
    missing = [name for name in order if name not in costs]
    if missing:
        raise ValueError(f"costs missing nodes {missing[:3]}...")
    cost_list = [float(costs[name]) for name in order]
    crossing = _crossing_map(graph, order)
    positions = [
        pos
        for pos, edges in crossing.items()
        if not (chain_cuts and len(edges) != 1)
    ]
    cut_weight = {
        pos: float(
            sum(
                LINK_DTYPE_BITS[resolve_link_dtype(link_dtype, u)]
                * graph.spec(u).d_out
                for u, _ in crossing[pos]
            )
        )
        for pos in positions
    }
    bounds = _dp_min_bottleneck(cost_list, n_stages, positions, cut_weight)

    budget: Optional[Tuple[int, ...]] = None
    parked: Optional[Tuple[int, ...]] = None
    if bram_budget is not None:
        if isinstance(bram_budget, int):
            budget = (bram_budget,) * n_stages
        else:
            budget = tuple(int(b) for b in bram_budget)
            if len(budget) != n_stages:
                raise ValueError(
                    f"{len(budget)} bram budgets for {n_stages} stages"
                )
        traffic = (
            edge_traffic if edge_traffic is not None else default_edge_traffic(graph)
        )

        def bits_of(b: Sequence[int]) -> Tuple[int, ...]:
            return _stage_bits(graph, order, b, traffic, link_dtype)

        parked = bits_of(bounds)
        if any(p > cap for p, cap in zip(parked, budget)):
            # unconstrained optimum busts a chip — fall back
            found = _budgeted_search(
                cost_list,
                n_stages,
                positions,
                cut_weight,
                lambda b: all(p <= cap for p, cap in zip(bits_of(b), budget)),
            )
            if found is None:
                raise ValueError(
                    f"no {n_stages}-stage partition fits bram_budget "
                    f"{budget} bits (min-bottleneck plan parks {parked})"
                )
            bounds = found
            parked = bits_of(bounds)

    prefix = [0.0]
    for c in cost_list:
        prefix.append(prefix[-1] + c)
    stage_cost = tuple(
        prefix[bounds[s + 1]] - prefix[bounds[s]] for s in range(n_stages)
    )
    cut_edges = tuple(tuple(crossing[b]) for b in bounds[1:-1])
    return GraphStagePlan(
        order=tuple(order),
        boundaries=bounds,
        stage_cost=stage_cost,
        bottleneck=max(stage_cost),
        balance=_balance(stage_cost),
        cut_edges=cut_edges,
        chain_legal=all(len(e) == 1 for e in cut_edges),
        bram_budget=budget,
        stage_buffer_bits=parked,
    )


def plan_node_costs(plan) -> Dict[str, float]:
    """Per-node stage cost from a ``GraphPlan`` (duck-typed, no import
    cycle): the DSE-selected multiplier count (DSP pressure), not raw
    FLOPs."""
    return {name: float(impl.mults) for name, impl in plan.impls.items()}


# --------------------------------------------------------------------------
# Cut-crossing stream buffers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamBuffer:
    """Inter-chip FIFO on one cut-crossing edge.

    For a join in-edge whose branch and join land in different stages,
    the monolithic skew FIFO *becomes* this buffer: ``bound_pixels``
    starts from the ``core.graph.join_buffers`` bound (the offset
    difference already equals the trunk path's cross-stage latency
    difference) and adds ``crossings * DEFAULT_LINK_CYCLES`` of link slack.
    Plain pipeline edges (src feeding the next stage's first node) need
    only the link slack plus one in-flight pixel.

    ``link_dtype`` is the wire format of the crossing activations —
    ``width_bits`` is ``LINK_DTYPE_BITS[link_dtype] * lanes``, so an
    int8 crossing is 4x narrower than fp32 at identical depth.
    """

    src: str
    dst: str
    src_stage: int
    dst_stage: int
    skew_cycles: Fraction  # analytic skew (0 for non-join edges)
    q: Fraction  # pixel rate through the edge
    d: int  # channels per pixel
    bound_pixels: int
    width_bits: int
    depth_words: int
    link_dtype: str = "int8"

    @property
    def bits(self) -> int:
        return self.width_bits * self.depth_words

    @property
    def crossings(self) -> int:
        return self.dst_stage - self.src_stage


def stream_buffers(
    plan,
    stage_plan: GraphStagePlan,
    *,
    link_dtype: LinkDtype = "int8",
) -> List[StreamBuffer]:
    """Size the stream buffer on every edge of ``plan.graph`` whose
    endpoints land in different stages of ``stage_plan``.

    ``plan`` is a ``core.graph.GraphPlan`` (duck-typed: this module must
    not import core.graph, which lazily imports it back for
    ``plan_graph(n_stages=...)``).
    """
    graph = plan.graph
    stage_of = stage_plan.stage_index()
    bufs: List[StreamBuffer] = []
    for dst in graph.topo_order():
        preds = graph.preds(dst)
        for src in preds:
            crossings = stage_of[dst] - stage_of[src]
            if crossings == 0:
                continue
            if crossings < 0:
                raise ValueError(
                    f"edge {src}->{dst} flows backwards across stages "
                    f"({stage_of[src]} -> {stage_of[dst]})"
                )
            q = plan.timing[dst].q_in
            d = graph.spec(src).d_out
            try:
                # A join skew FIFO or a split->lane deal FIFO on this edge
                # is absorbed into the inter-chip buffer: its analytic
                # bound is the base the link slack is added to.
                jb = plan.buffer_for(dst, src)
                base = jb.bound_pixels
                skew = jb.skew_cycles
            except KeyError:
                base = 1
                skew = Fraction(0)
            dtype = resolve_link_dtype(link_dtype, src)
            bound, _, width, depth = edge_buffer_geometry(
                EdgeTraffic(src=src, dst=dst, q=q, d=d, base_pixels=base),
                crossings,
                bits_per_feature=LINK_DTYPE_BITS[dtype],
            )
            bufs.append(
                StreamBuffer(
                    src=src,
                    dst=dst,
                    src_stage=stage_of[src],
                    dst_stage=stage_of[dst],
                    skew_cycles=skew,
                    q=q,
                    d=d,
                    bound_pixels=bound,
                    width_bits=width,
                    depth_words=depth,
                    link_dtype=dtype,
                )
            )
    return bufs


def stage_stream_bits(
    bufs: Sequence[StreamBuffer], n_stages: int
) -> Tuple[int, ...]:
    """Cut-crossing buffer bits parked on each stage (buffers live on
    the consuming chip, matching ``estimate_stages`` attribution)."""
    bits = [0] * n_stages
    for sb in bufs:
        bits[sb.dst_stage] += sb.bits
    return tuple(bits)
