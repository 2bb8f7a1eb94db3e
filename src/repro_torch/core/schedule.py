"""Discrete-event validation of the continuous-flow property.

The port's own copy of the JAX package's ``core/schedule.py``.

The paper's constraints (Eqs. 7-9) promise: *if the layer is provided with
enough data, the arithmetic units will always process valid data without
any empty times*.  This module simulates layer chains AND layer DAGs at
pixel/pass granularity and measures exactly that:

* a layer implementation runs one **pass** per pixel: all its units busy
  for C = h*d_in/j cycles, producing the pixel's d_out outputs;
* multi-pixel impls run P phases in parallel, pixel n served by phase
  n mod P;
* a pass can start only when (a) the pixel has fully arrived and (b) the
  phase finished its previous pass;
* at a DAG join, pixel n has "arrived" only when EVERY operand branch has
  delivered it — the fast branch's pixels wait in a skew FIFO whose
  occupancy is measured against the analytical bound from core.graph.

`simulate_chain` returns per-layer busy fractions and buffer bounds;
`simulate_graph` additionally returns per-join-edge occupancy maxima.
The property tests assert:
  - zero stalls after warm-up whenever capacity >= demand (continuous flow);
  - measured utilization == demand/capacity (the DSE's analytical value);
  - bounded buffers (no unbounded queueing);
  - join occupancy <= the skew bound (graph only).
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from collections import OrderedDict
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from .dse import LayerImpl


@dataclasses.dataclass
class LayerTrace:
    name: str
    busy_cycles: int
    span_cycles: int  # first pass start -> last pass end
    stall_cycles: int  # idle cycles while input WAS available
    max_queue: int  # max pixels waiting
    util: float  # busy / span per phase-average

    @property
    def stall_free(self) -> bool:
        return self.stall_cycles == 0


def _arrival_times(n_pixels: int, q: Fraction) -> List[Fraction]:
    """Pixel n has fully arrived at time (n+1)/q (fluid arrival at rate q)."""
    return [Fraction(n + 1, 1) / q for n in range(n_pixels)]


def _empty_trace(name: str) -> LayerTrace:
    return LayerTrace(
        name=name, busy_cycles=0, span_cycles=0, stall_cycles=0, max_queue=0, util=1.0
    )


def _simulate_layer(
    impl: LayerImpl, arrivals: Sequence[Fraction]
) -> Tuple[LayerTrace, List[Fraction], List[Fraction]]:
    """One layer's pass-level discrete-event run.

    Returns (trace, done_times, start_times).  ``done_times`` are raw pass
    completions (pre-decimation); callers decimate per the layer's spatial
    ratio.
    """
    lay = impl.layer
    if not arrivals:
        return _empty_trace(lay.name), [], []

    c = Fraction(impl.configs)  # cycles per pass
    if impl.mults == 0:
        c = Fraction(max(1, lay.d_in // max(1, impl.j)))  # pass-through cadence
    p = max(1, impl.p_raw)

    phase_free = [Fraction(0)] * p
    done: List[Fraction] = []
    busy = Fraction(0)
    stall = Fraction(0)
    max_q = 0
    started: List[Fraction] = []
    arr_seen: List[Fraction] = []  # sorted arrivals[:n+1]
    started_sorted: List[Fraction] = []

    for n, a in enumerate(arrivals):
        phi = n % p
        start = max(a, phase_free[phi])
        started.append(start)
        bisect.insort(started_sorted, start)
        bisect.insort(arr_seen, a)
        end = start + c
        phase_free[phi] = end
        done.append(end)
        busy += c
        # queue depth at time 'start': arrived (among pixels 0..n) minus
        # started (the current pixel counts as started)
        q_depth = bisect.bisect_right(arr_seen, start) - bisect.bisect_right(
            started_sorted, start
        )
        max_q = max(max_q, q_depth)

    # stall = idle time of phases while a pixel was waiting in queue
    for phi in range(p):
        starts = sorted(started[i] for i in range(len(started)) if i % p == phi)
        for k in range(1, len(starts)):
            gap = starts[k] - (starts[k - 1] + c)
            if gap > 0:
                idx = k * p + phi
                if idx < len(arrivals) and arrivals[idx] <= starts[k - 1] + c:
                    stall += gap

    span = (max(done) - min(started)) if done else Fraction(1)
    util = float(busy / (span * p)) if span > 0 else 1.0
    trace = LayerTrace(
        name=lay.name,
        busy_cycles=math.ceil(busy),
        span_cycles=math.ceil(span),
        stall_cycles=math.ceil(stall),
        max_queue=max_q,
        util=util,
    )
    return trace, done, started


def _decimate(done: List[Fraction], lay) -> List[Fraction]:
    """Spatial decimation: keep 1 of every (in_px/out_px) completions.
    Shares core.graph's keep computation so chain and DAG simulation agree
    (and non-integer ratios fail loudly instead of silently mis-timing)."""
    from .graph import decimation_keep  # deferred: graph imports dse too

    keep = decimation_keep(lay)
    if keep > 1:
        return [t for i, t in enumerate(done) if i % keep == keep - 1]
    return done


def simulate_chain(
    impls: Sequence[LayerImpl],
    n_pixels: int,
    input_pixel_rate: Fraction,
) -> List[LayerTrace]:
    """Push ``n_pixels`` through the chain; return per-layer traces."""
    arrivals: List[Fraction] = _arrival_times(n_pixels, input_pixel_rate)
    traces: List[LayerTrace] = []
    for impl in impls:
        trace, done, _ = _simulate_layer(impl, arrivals)
        traces.append(trace)
        arrivals = _decimate(done, impl.layer)
    return traces


# --------------------------------------------------------------------------
# DAG simulation
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JoinOccupancy:
    """Measured skew-FIFO occupancy on one join in-edge."""

    join: str
    src: str
    max_pixels: int  # measured peak pixels resident
    bound_pixels: int  # analytical bound from core.graph

    @property
    def within_bound(self) -> bool:
        return self.max_pixels <= self.bound_pixels


@dataclasses.dataclass
class GraphSimResult:
    traces: "OrderedDict[str, LayerTrace]"
    occupancy: List[JoinOccupancy]

    @property
    def stall_free(self) -> bool:
        return all(t.stall_free for t in self.traces.values())

    @property
    def stalled_nodes(self) -> List[str]:
        return [n for n, t in self.traces.items() if not t.stall_free]

    @property
    def within_bounds(self) -> bool:
        return all(o.within_bound for o in self.occupancy)


def simulate_graph(
    plan,  # core.graph.GraphPlan (duck-typed: no cycle)
    n_pixels: int,
    input_pixel_rate: Optional[Fraction] = None,
) -> GraphSimResult:
    """Discrete-event run of a planned DAG.

    Every node consumes the completion stream(s) of its producers; a join
    consumes pixel n at max over operands of that pixel's arrival, and the
    fast operands' early pixels are counted as skew-FIFO occupancy.  Node
    outputs are shifted by the plan's analytical window-fill latency so
    cross-branch skew includes line-buffer banking, exactly as
    ``core.graph.compute_timing`` models it.

    Multi-CLP replication wiring (core.replicate) simulates in the fluid
    steady state: a lane behind a 'split' consumes the dealt subsequence
    (every R-th pixel) of the splitter's output, and a 'merge' consumes
    lane pixel i as its output pixel i*R + k — the round-robin
    re-interleave.  Deal/merge-edge occupancies are measured against the
    analytic bounds, which are sized for whole-*frame* dealing and thus
    dominate the steady-state residency measured here.
    """
    graph = plan.graph
    sources = graph.input_nodes
    if len(sources) != 1:
        raise ValueError(f"simulate_graph wants a single source, got {sources}")
    if input_pixel_rate is None:
        input_pixel_rate = plan.input_rate / graph.spec(sources[0]).d_in

    outputs: Dict[str, List[Fraction]] = {}
    traces: "OrderedDict[str, LayerTrace]" = OrderedDict()
    occupancy: List[JoinOccupancy] = []

    for name in graph.topo_order():
        spec = graph.spec(name)
        preds = graph.preds(name)
        if not preds:
            arrivals: List[Fraction] = _arrival_times(n_pixels, input_pixel_rate)
            edge_arrivals: List[Tuple[str, List[Fraction]]] = []
        elif len(preds) == 1 and graph.spec(preds[0]).kind == "split":
            # A replication lane: consume the dealt subsequence (pixels
            # k, k+R, ... of the splitter's stream, k = this lane's deal
            # slot), and measure the deal-FIFO residency on the edge.
            lanes = graph.succs(preds[0])
            arrivals = outputs[preds[0]][lanes.index(name) :: len(lanes)]
            edge_arrivals = [(preds[0], arrivals)]
        elif len(preds) == 1:
            arrivals = outputs[preds[0]]
            edge_arrivals = []
        elif spec.kind == "merge":
            # Order-preserving re-interleave: output pixel m is lane
            # (m mod R)'s pixel m // R; truncate to complete rounds.
            r = len(preds)
            rounds = min(len(outputs[p]) for p in preds)
            arrivals = [outputs[preds[m % r]][m // r] for m in range(rounds * r)]
            edge_arrivals = []  # per-lane residency measured below
        else:
            streams = [(p, outputs[p]) for p in preds]
            n_avail = min(len(s) for _, s in streams)
            arrivals = [max(s[i] for _, s in streams) for i in range(n_avail)]
            edge_arrivals = [(p, s[:n_avail]) for p, s in streams]

        impl = plan.impls[name]
        trace, done, started = _simulate_layer(impl, arrivals)
        traces[name] = trace

        # skew-FIFO occupancy: pixels delivered by this operand but whose
        # pass has not started yet (counted at each pass start, inclusive
        # of the pixel being consumed)
        for src, arr in edge_arrivals:
            arr_sorted = sorted(arr)
            peak = 0
            for i, s in enumerate(started):
                resident = bisect.bisect_right(arr_sorted, s) - i
                peak = max(peak, resident)
            occupancy.append(
                JoinOccupancy(
                    join=name,
                    src=src,
                    max_pixels=peak,
                    bound_pixels=plan.buffer_for(name, src).bound_pixels,
                )
            )
        if spec.kind == "merge":
            # Lane k's pixel i is consumed at the start of output pixel
            # i*R + k, so residency on lane edge k counts deliveries up
            # to each such start minus the i already consumed.
            r = len(preds)
            for k, src in enumerate(preds):
                arr_sorted = sorted(outputs[src][: len(started) // r])
                peak = 0
                for i, s in enumerate(started[k::r]):
                    resident = bisect.bisect_right(arr_sorted, s) - i
                    peak = max(peak, resident)
                occupancy.append(
                    JoinOccupancy(
                        join=name,
                        src=src,
                        max_pixels=peak,
                        bound_pixels=plan.buffer_for(name, src).bound_pixels,
                    )
                )

        fill = plan.timing[name].fill_cycles
        out = _decimate(done, spec)
        outputs[name] = [t + fill for t in out] if fill else out

    return GraphSimResult(traces=traces, occupancy=occupancy)


def analytical_utilization(impl: LayerImpl) -> float:
    """The DSE's predicted utilization — what simulation should measure."""
    return float(impl.utilization)
