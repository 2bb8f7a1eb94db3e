"""Unified CNN inference machinery: execute a ``LayerGraph`` in PyTorch.

The port's counterpart of the first half of the JAX package's
``models/cnn.py``.  Every CNN family describes itself once, as the
``LayerSpec`` DAG the data-rate DSE plans (core.graph); this module runs
the *same* graph as a network (NHWC, folded BN):

  * ``init_graph_params``   — He-init weights + folded-BN bias per node,
    drawn from an explicit ``torch.Generator``;
  * ``params_from_reference`` — the JAX package's ``{node: {"w", "b"}}``
    parameters (as numpy arrays) carried across;
  * ``apply_graph``         — topological forward pass;
  * ``apply_staged``        — the multi-chip execution of a stage
    partition: each stage's subgraph run as its own eager function,
    cut-crossing activations (skew-buffered shortcuts included) threaded
    across the stage boundaries, optionally as int8 or bf16 wire payloads;
  * ``stage_functions``     — the per-stage callables underneath
    ``staged_forward``, exposed one by one for a pipelining driver;
    with ``placement=`` each stage runs on a device and a CUDA stream of
    its own (``resolve_stage_devices``, ``StagePipeline.prefetch``);
  * ``quantize_params`` / ``apply_int8`` — the paper's 8-bit datapath;
  * ``default_impls`` / ``kernel_impls`` — the plain PyTorch versions vs
    the hand-written CUDA KPU / FCU / DW kernels, swappable per layer
    kind, with node-keyed ``overrides``.

``apply_graph(check=True)`` re-derives each node's output shape and MAC
count from the live tensors and asserts they equal the spec's.

Plan-threading contract: ``GraphPlan.kernel_plan()`` maps each
arithmetic node to the tile derived from its own DSE choice;
``apply_graph(plan=...)`` builds one kernel impl per node, keyed by node
name and pinned to that tile, and asserts after each node that the tile
the kernel executed equals the plan.  Violations raise
``GraphExecutionError``.  Bias and activation stay outside the kernels.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.dse import NON_ARITH_KINDS
from repro_torch.core.graph import JOIN_KINDS, ImplPlan, LayerGraph
from repro_torch.core.rate import LayerSpec
from repro_torch.core.stage_partition import resolve_link_dtype
from repro_torch.kernels.dw_conv import dw_conv_impl, dwconv_plain
from repro_torch.kernels.fcu_matmul import dense_impl, pointwise_impl, pointwise_plain
from repro_torch.kernels._build import windows
from repro_torch.kernels.kpu_conv import conv_impl, kpu_conv_plain
from repro_torch.nn.quant import (
    dequantize_link,
    exact_divisor,
    fake_quant_link,
    quantize_link,
)
from repro_torch.obs.trace import host_span

Impl = Callable[..., torch.Tensor]
Params = Dict[str, Dict[str, torch.Tensor]]

# Weighted kinds — the complement of the DSE-owned partition
# (core.dse.NON_ARITH_KINDS).  Membership checks go through
# NON_ARITH_KINDS so a kind added on the DSE side reaches
# ``_weight_shape``, which raises for layouts it does not know.
ARITH_KINDS = ("conv", "dwconv", "pointwise", "dense")


def _is_arith(spec: LayerSpec) -> bool:
    return spec.kind not in NON_ARITH_KINDS


class GraphExecutionError(ValueError):
    """The executable network disagrees with its LayerGraph description."""


_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "none": lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
}


def default_impls() -> Dict[str, Impl]:
    """The kernels' plain PyTorch versions (no cuDNN: every path's
    numerics are independent of the TF32 convolution setting)."""
    return {
        "conv": kpu_conv_plain,
        "dwconv": dwconv_plain,
        "pointwise": pointwise_plain,
        "dense": pointwise_plain,
    }


def kernel_impls(
    *,
    rate=None,
    plan: Optional[Mapping[str, ImplPlan]] = None,
    executed: Optional[Dict[str, Dict[str, int]]] = None,
) -> Dict[str, Impl]:
    """Kernel-backed implementations (KPU / DW / FCU).

    Without ``plan`` this is the **uniform** path: four kind-level impls
    whose tiles come from ``select_tile`` under one global ``rate``.
    With ``plan`` (a ``GraphPlan.kernel_plan()`` table) it is the
    **rate-matched** path: one impl per arithmetic *node name*, pinned to
    that node's planned tile.  When ``executed`` is given, each node impl
    records the tile it actually ran into ``executed[name]``.
    """
    factories = {
        "conv": conv_impl,
        "dwconv": dw_conv_impl,
        "pointwise": pointwise_impl,
        "dense": dense_impl,
    }
    table: Dict[str, Impl] = {kind: make(rate=rate) for kind, make in factories.items()}
    if plan is None:
        return table
    for name, node_plan in plan.items():
        if not node_plan.has_kernel:
            continue  # pool / add / gap / concat: wiring, no kernel
        if name in factories:
            raise GraphExecutionError(
                f"node name {name!r} collides with an impl kind key"
            )
        record = None
        if executed is not None:
            record = _tile_recorder(executed, name)
        table[name] = factories[node_plan.kind](tile=node_plan.tile, record=record)
    return table


def _tile_recorder(executed: Dict[str, Dict[str, int]], name: str):
    def record(**tile):
        executed[name] = tile
    return record


# ==========================================================================
# Parameters
# ==========================================================================


def _weight_shape(spec: LayerSpec) -> tuple:
    if spec.kind == "conv":
        return (*spec.kernel, spec.d_in, spec.d_out)
    if spec.kind == "dwconv":
        # HWIO for grouped conv: I = 1 (per-group), O = C * multiplier
        return (*spec.kernel, 1, spec.d_in * spec.channel_multiplier)
    if spec.kind in ("pointwise", "dense"):
        return (spec.d_in, spec.d_out)
    raise GraphExecutionError(f"{spec.name}: no weight layout for kind {spec.kind!r}")


def _fan_in(spec: LayerSpec) -> int:
    if spec.kind == "conv":
        return spec.d_in * spec.k_taps
    if spec.kind == "dwconv":
        return spec.k_taps
    return spec.d_in


def init_graph_params(
    graph: LayerGraph,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> Params:
    """He-init weights + folded-BN bias for every arithmetic node, drawn
    from ``generator`` on its own device and placed on ``device``."""
    params: Params = {}
    for name in graph.topo_order():
        spec = graph.spec(name)
        if not _is_arith(spec):
            continue
        w = torch.randn(
            _weight_shape(spec), generator=generator, dtype=torch.float32,
            device=generator.device,
        ) * float(np.sqrt(2.0 / _fan_in(spec)))
        params[name] = {
            "w": w.to(device=device, dtype=dtype),
            "b": torch.zeros((spec.d_out,), dtype=dtype, device=device),
        }
    return params


def params_from_reference(
    np_params: Mapping[str, Mapping[str, np.ndarray]],
    device,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Carry a ``{node: {"w", "b"}}`` parameter dict of numpy arrays (the
    JAX package's layout: HWIO convs, ``[kh, kw, 1, C]`` depthwise,
    ``[d_in, d_out]`` dense) onto ``device`` as ``dtype`` tensors."""
    return {
        name: {
            k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
                device=device, dtype=dtype
            )
            for k, v in p.items()
        }
        for name, p in np_params.items()
    }


# ==========================================================================
# Forward pass
# ==========================================================================


def _merge_lanes(operands: List[torch.Tensor]) -> torch.Tensor:
    """Order-preserving re-interleave of R dealt lane streams: lane k's
    frame i becomes output frame i*R + k — the inverse of the
    consumer-side ``x[k::R]`` deal."""
    r = len(operands)
    n = sum(o.shape[0] for o in operands)
    out = operands[0].new_zeros((n, *operands[0].shape[1:]))
    for k, o in enumerate(operands):
        out[k::r] = o
    return out


def _max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """SAME max-pool as XLA's ``reduce_window(-inf, max, 'SAME')``: pads
    asymmetrically with -inf (ResNet's 3x3/s2 pool at 112 pads (0, 1)),
    then takes the max over the strided per-tap windows."""
    if kernel[0] != kernel[1] or stride[0] != stride[1]:
        raise GraphExecutionError(f"non-square pool {kernel}/{stride}")
    y = None
    for _, _, win in windows(x, kernel[0], kernel[1], stride[0], fill=-float("inf")):
        y = win if y is None else torch.maximum(y, win)
    return y


def _node_forward(
    spec: LayerSpec,
    operands: List[torch.Tensor],
    p: Optional[Dict[str, torch.Tensor]],
    impls: Dict[str, Impl],
) -> torch.Tensor:
    if len(operands) > 1 and spec.kind not in JOIN_KINDS and spec.kind != "merge":
        raise GraphExecutionError(
            f"{spec.name}: kind {spec.kind!r} got {len(operands)} operands"
        )
    x = operands[0]

    # per-node impls (rate-matched plans) take precedence over kind-level
    # defaults; kernel_impls(plan=...) registers them under the node name.
    def fn(kind):
        return impls.get(spec.name) or impls[kind]

    if spec.kind == "conv":
        y = fn("conv")(x, p["w"], spec.stride[0]) + p["b"]
    elif spec.kind == "dwconv":
        y = fn("dwconv")(x, p["w"], spec.stride[0]) + p["b"]
    elif spec.kind == "pointwise":
        y = fn("pointwise")(x, p["w"]) + p["b"]
    elif spec.kind == "dense":
        y = fn("dense")(x, p["w"]) + p["b"]
    elif spec.kind == "pool":
        y = _max_pool_same(x, spec.kernel, spec.stride)
    elif spec.kind == "gap":
        y = torch.mean(x, dim=(1, 2))
    elif spec.kind == "add":
        y = x
        for other in operands[1:]:
            y = y + other
    elif spec.kind == "concat":
        y = torch.cat(operands, dim=-1)
    elif spec.kind == "split":
        # Multi-CLP round-robin frame splitter: wiring only — each lane
        # consumer takes its dealt batch subsequence in ``_run_nodes``.
        y = x
    elif spec.kind == "merge":
        y = _merge_lanes(operands)
    else:
        raise GraphExecutionError(f"{spec.name}: unknown kind {spec.kind!r}")
    try:
        act = _ACTIVATIONS[spec.activation]
    except KeyError:
        raise GraphExecutionError(
            f"{spec.name}: unknown activation {spec.activation!r}"
        ) from None
    return act(y)


def _macs_from_arrays(
    spec: LayerSpec, p: Optional[Dict[str, torch.Tensor]], y: torch.Tensor
) -> int:
    """Re-derive the node's MAC count from live tensor shapes alone."""
    if not _is_arith(spec):
        return 0
    out_px = y.shape[1] * y.shape[2] if y.dim() == 4 else 1
    w = p["w"]
    if spec.kind == "conv":
        kh, kw, ci, co = w.shape
        return kh * kw * ci * co * out_px
    if spec.kind == "dwconv":
        kh, kw, _, co = w.shape
        return kh * kw * co * out_px
    ci, co = w.shape  # pointwise / dense
    return ci * co * out_px


def _check_node(
    spec: LayerSpec, p: Optional[Dict[str, torch.Tensor]], y: torch.Tensor
) -> None:
    n = y.shape[0]
    if spec.kind in ("gap", "dense"):
        expect = (n, spec.d_out)
    elif spec.kind in ("split", "merge") and y.dim() == 2:
        expect = (n, spec.d_out)  # replication wiring on the post-gap vector
    else:
        expect = (n, *spec.out_hw, spec.d_out)
    if tuple(y.shape) != expect:
        raise GraphExecutionError(
            f"{spec.name}: executable shape {tuple(y.shape)} != "
            f"LayerGraph shape {expect}"
        )
    macs = _macs_from_arrays(spec, p, y)
    if macs != spec.total_macs:
        raise GraphExecutionError(
            f"{spec.name}: executable MACs {macs} != "
            f"LayerSpec.total_macs {spec.total_macs}"
        )


def _check_planned_tile(
    spec: LayerSpec,
    node_plan: Optional[ImplPlan],
    got: Optional[Dict[str, int]],
) -> None:
    """Assert one node's *executed* tile equals its ``ImplPlan`` tile.

    The channel tiles (bk, bn) must match the plan exactly and divide the
    live dims.  The conv kinds tile flattened output pixels, so they
    execute the planned bm too; the FCU kinds re-fit bm to the runtime m
    (batch flattened in) unless the plan was pinned to a serving batch,
    in which case bm and m must match the plan.
    """
    if node_plan is None:
        raise GraphExecutionError(f"{spec.name}: node missing from the kernel plan")
    if not node_plan.has_kernel:
        return
    if got is None:
        raise GraphExecutionError(
            f"{spec.name}: planned kernel did not report an executed tile"
        )
    t = node_plan.tile
    if (got.get("bk"), got.get("bn")) != (t.bk, t.bn):
        raise GraphExecutionError(
            f"{spec.name}: executed tile (bk={got.get('bk')}, "
            f"bn={got.get('bn')}) != ImplPlan tile (bk={t.bk}, bn={t.bn})"
        )
    d_in, d_out = got.get("d_in"), got.get("d_out")
    if (d_in, d_out) != (spec.d_in, spec.d_out):
        raise GraphExecutionError(
            f"{spec.name}: kernel saw dims ({d_in}, {d_out}) != LayerSpec "
            f"({spec.d_in}, {spec.d_out})"
        )
    if d_in % t.bk or (spec.kind != "dwconv" and d_out % t.bn):
        raise GraphExecutionError(
            f"{spec.name}: planned tile (bk={t.bk}, bn={t.bn}) does not "
            f"divide live dims ({d_in}, {d_out})"
        )
    if spec.kind in ("conv", "dwconv") and got.get("bm") != t.bm:
        raise GraphExecutionError(
            f"{spec.name}: executed bm={got.get('bm')} != ImplPlan bm={t.bm}"
        )
    if node_plan.batch is not None and spec.kind in ("pointwise", "dense"):
        want_m = node_plan.batch * spec.out_hw[0] * spec.out_hw[1]
        if got.get("m") != want_m:
            raise GraphExecutionError(
                f"{spec.name}: plan pinned to batch {node_plan.batch} "
                f"(m={want_m}) but the kernel saw m={got.get('m')} — "
                f"micro-batch the inputs to the planned size"
            )
        if got.get("bm") != t.bm:
            raise GraphExecutionError(
                f"{spec.name}: executed bm={got.get('bm')} != batch-pinned "
                f"plan bm={t.bm}"
            )


def _check_single_stream(graph: LayerGraph) -> str:
    """Require one input and one output node; return the output's name."""
    inputs = graph.input_nodes
    outputs = graph.output_nodes
    if len(inputs) != 1 or len(outputs) != 1:
        raise GraphExecutionError(
            f"the executor needs a single-input/single-output graph, got "
            f"inputs={inputs}, outputs={outputs}"
        )
    return outputs[0]


def _build_table(
    *,
    impls: Optional[Dict[str, Impl]],
    plan: Optional[Mapping[str, ImplPlan]],
    overrides: Optional[Mapping[str, Impl]],
    graph: LayerGraph,
    executed: Dict[str, Dict[str, int]],
) -> Dict[str, Impl]:
    """Assemble the dispatch table: kind-level plain versions, then
    plan-derived per-node kernels, then kind-level ``impls``, then
    node-keyed user ``overrides`` (which always win, and are validated
    against the graph so a typoed node name fails loudly).  Host span
    ``executor.table``."""
    with host_span("executor.table"):
        table = default_impls()
        if plan is not None:
            table.update(kernel_impls(plan=plan, executed=executed))
        if impls:
            table.update(impls)
        if overrides:
            unknown = [n for n in overrides if n not in graph]
            if unknown:
                raise GraphExecutionError(f"overrides for unknown nodes: {unknown}")
            bad = [n for n in overrides if not _is_arith(graph.spec(n))]
            if bad:
                raise GraphExecutionError(
                    f"overrides for non-arithmetic (wiring) nodes: {bad}"
                )
            table.update(overrides)
    return table


# --------------------------------------------------------------------------
# Quantized cut crossings (the link_dtype wire format, executor side)
# --------------------------------------------------------------------------


def cut_edge_dtypes(
    graph: LayerGraph, partition, link_dtype="int8"
) -> Dict[tuple, str]:
    """{(src, dst): dtype} for every cut-crossing edge of ``partition``
    narrower than fp32 — the executor-side mirror of the ``link_dtype``
    the DSE priced ``StreamBuffer`` widths with.  fp32 edges are omitted:
    a full-width wire needs no transform, so the fp32 path is
    bit-identical to no link quantization at all."""
    if hasattr(partition, "stage_plan"):  # a GraphPlan from n_stages=
        partition = partition.stage_plan
    stage_of = partition.stage_index()
    out: Dict[tuple, str] = {}
    for v in graph.topo_order():
        for u in graph.preds(v):
            if stage_of[u] != stage_of[v]:
                dt = resolve_link_dtype(link_dtype, u)
                if dt != "fp32":
                    out[(u, v)] = dt
    return out


def _resolve_link_quant(link_quant, graph, partition) -> Dict[tuple, str]:
    """Normalize the executor's ``link_quant`` option to an edge map.

    ``None`` -> off; ``True`` -> the partition plan's own ``link_dtype``
    (a ``GraphPlan``; plain partitions default to int8); a dtype str or
    per-producer {src: dtype} -> resolved over the cut edges; an
    edge-keyed {(src, dst): dtype} dict passes through.
    """
    if link_quant is None:
        return {}
    if link_quant is True:
        link_quant = getattr(partition, "link_dtype", "int8")
    if isinstance(link_quant, dict) and any(isinstance(k, tuple) for k in link_quant):
        return {k: v for k, v in link_quant.items() if v != "fp32"}
    return cut_edge_dtypes(graph, partition, link_quant)


def _link_encode(x: torch.Tensor, dtype: str):
    """Producer side of a quantized crossing: the wire payload exported
    into the boundary dict (an int8 {"__q__", "__s__"} dict, or a bare
    bf16 cast)."""
    if dtype == "int8":
        return quantize_link(x)
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    return x


def _link_decode(v, dtype: str, out_dtype: torch.dtype):
    """Consumer side — and, on the monolithic path where the operand was
    never encoded, the quantize-dequantize round trip in place.  Both
    give the same values, which is what makes staged int8 bit-exact
    against the monolithic fake-quant.  Decodes to the forward's dtype
    ``out_dtype`` (the JAX package's decode always returns f32)."""
    if isinstance(v, dict):
        return dequantize_link(v, dtype=out_dtype)
    if dtype == "int8":
        return fake_quant_link(v, dtype=out_dtype)
    if dtype == "bf16":
        return v.to(torch.bfloat16).to(out_dtype)
    return v


def _run_nodes(
    graph: LayerGraph,
    names,
    values: Dict[str, torch.Tensor],
    params: Params,
    table: Dict[str, Impl],
    *,
    x_input: Optional[torch.Tensor] = None,
    plan: Optional[Mapping[str, ImplPlan]] = None,
    executed: Optional[Dict[str, Dict[str, int]]] = None,
    overridden=frozenset(),
    check: bool = True,
    link_quant: Optional[Mapping[tuple, str]] = None,
    dtype: torch.dtype = torch.float32,
) -> None:
    """Execute ``names`` in order, reading/writing ``values``: per-node
    forward, shape/MAC cross-check, and — on the rate-matched path — the
    executed-tile-==-plan assertion.  The shared inner loop of
    ``apply_graph`` (all nodes) and the staged executor (one stage's
    nodes).  Nodes named in ``overridden`` run a user-supplied impl and
    are exempt from the tile assertion unless the override recorded into
    ``executed`` itself.

    ``link_quant`` maps cut-crossing edges (src, dst) to a wire dtype: an
    operand read over such an edge is decoded to ``dtype`` (staged path:
    the boundary carries the payload) or fake-quantized in place
    (monolithic path: the same values).  The transform applies before
    split-lane slicing: the producer encodes its whole stream once, with
    one scale.  Host span ``executor.nodes``, around the whole loop."""
    executed = executed if executed is not None else {}
    with host_span("executor.nodes"):
        for name in names:
            spec = graph.spec(name)
            preds = graph.preds(name)
            if preds:
                missing = [p for p in preds if p not in values]
                if missing:
                    raise GraphExecutionError(
                        f"{name}: operands {missing} not materialized — "
                        f"producer scheduled in a later stage?"
                    )
                operands = []
                for pr in preds:
                    v = values[pr]
                    if link_quant:
                        dt = link_quant.get((pr, name))
                        if dt is not None:
                            v = _link_decode(v, dt, dtype)
                    if graph.spec(pr).kind == "split":
                        # Replication lane: consume the dealt subsequence of
                        # the split stream (this lane's slot in deal order).
                        lanes = graph.succs(pr)
                        v = v[lanes.index(name):: len(lanes)]
                    operands.append(v)
            else:
                if x_input is None:
                    raise GraphExecutionError(
                        f"{name}: source node executed outside the input stage"
                    )
                operands = [x_input]
            p = params.get(name)
            if _is_arith(spec) and p is None:
                raise GraphExecutionError(f"{name}: missing parameters")
            y = _node_forward(spec, operands, p, table)
            if check:
                _check_node(spec, p, y)
            if plan is not None and not (name in overridden and executed.get(name) is None):
                _check_planned_tile(spec, plan.get(name), executed.get(name))
            values[name] = y


def apply_graph(
    params: Params,
    x: torch.Tensor,
    graph: LayerGraph,
    *,
    impls: Optional[Dict[str, Impl]] = None,
    plan: Optional[Mapping[str, ImplPlan]] = None,
    overrides: Optional[Mapping[str, Impl]] = None,
    executed: Optional[Dict[str, Dict[str, int]]] = None,
    dtype: torch.dtype = torch.float32,
    check: bool = True,
    link_quant: Optional[Mapping[tuple, str]] = None,
) -> torch.Tensor:
    """Forward pass of a LayerGraph network.  ``x``: [N, H, W, d_in].

    ``impls`` overrides any of {'conv', 'dwconv', 'pointwise', 'dense'}.
    ``plan`` switches to rate-matched execution: one CUDA kernel impl per
    arithmetic node (``kernel_impls(plan=...)``), each launched with its
    node's own tile, and after each node the executed tile is asserted
    equal to the plan's.  With ``plan``, the per-node impls win on every
    arithmetic node, so kind-level ``impls`` are shadowed there.
    ``overrides`` maps node names to impls that win over everything.
    ``executed``, when given, receives each node's executed tile.
    Tensors stay on ``x``'s device: a CUDA input runs the kernels (or
    raises), a CPU input their plain versions.  ``link_quant`` (an
    edge-keyed {(src, dst): dtype} map, e.g. from ``cut_edge_dtypes``)
    fake-quantizes each mapped operand in place: the monolithic
    reference for staged execution with quantized cut crossings.
    """
    out_name = _check_single_stream(graph)
    if executed is None:
        executed = {}
    table = _build_table(
        impls=impls, plan=plan, overrides=overrides, graph=graph, executed=executed
    )
    values: Dict[str, torch.Tensor] = {}
    _run_nodes(
        graph,
        graph.topo_order(),
        values,
        params,
        table,
        x_input=x.to(dtype).contiguous(),
        plan=plan,
        executed=executed,
        overridden=frozenset(overrides or ()),
        check=check,
        link_quant=link_quant,
        dtype=dtype,
    )
    return values[out_name]


# ==========================================================================
# Staged (multi-chip) execution of a stage partition
# ==========================================================================


def resolve_stage_devices(placement, n_stages: int, partition=None, device=None):
    """Normalize a ``placement`` option to a per-stage device tuple.

    ``None`` / ``False`` mean every stage on the input's device, with no
    transfers and no streams of their own (``None`` is returned).  The
    pool is every CUDA device (``cuda:0`` .. ``cuda:{n-1}``) when the
    pipeline's home ``device`` is CUDA (``None`` is the card, as for
    every entry point of the port), and the home alone otherwise (the
    CPU).  The forms are the JAX package's:

    * ``True`` — the partition's recorded ``placement`` ordinals
      (``GraphStagePlan.placement``, e.g. from ``plan_graph(...,
      n_devices=)``) when present, else round robin over the pool;
    * an ``int`` n — round robin over the first ``min(n, len(pool))``
      devices of the pool;
    * a sequence of ordinals — indices into the pool, folded modulo its
      size (fewer devices than stages degrade to co-resident stages,
      never to an error);
    * a sequence of devices (``torch.device`` or str) — used round robin.

    A CUDA home where CUDA is absent raises: nothing falls back to the
    CPU.
    """
    if placement is None or placement is False:
        return None
    home = torch.device("cuda" if device is None else device)
    if home.type == "cuda":
        if not torch.cuda.is_available():
            raise GraphExecutionError(
                "placement on the card needs CUDA, which is not available; "
                "nothing falls back to the CPU (pass device='cpu' to place "
                "the stages there)"
            )
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        pool = [home]
    if placement is True:
        recorded = getattr(partition, "placement", None)
        placement = recorded if recorded is not None else len(pool)
    if isinstance(placement, int):
        if placement < 1:
            raise GraphExecutionError(
                f"placement needs >= 1 device, got {placement}"
            )
        pool = pool[: min(placement, len(pool))]
        return tuple(pool[s % len(pool)] for s in range(n_stages))
    seq = list(placement)
    if not seq:
        raise GraphExecutionError("placement sequence is empty")
    if all(isinstance(p, int) for p in seq):
        return tuple(pool[seq[s % len(seq)] % len(pool)] for s in range(n_stages))
    return tuple(_explicit_device(seq[s % len(seq)]) for s in range(n_stages))


def _explicit_device(d) -> torch.device:
    """``d`` as a device with its index written out (``cuda`` is the
    current card), so that co-resident stages compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


# Stage s of every placed pipeline on a card runs on that card's stage-s
# stream.  The caching allocator keeps freed memory per stream, so on a
# fresh stream every first allocation is a cudaMalloc; shared stage
# streams keep each new pipeline (an engine, its rungs, a fleet's
# tenants) on memory already cached.  Two pipelines' stage s never
# overlap each other on a card; different stages still do.
_STAGE_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}


def _stage_stream(device: torch.device, s: int):
    stream = _STAGE_STREAMS.get((device, s))
    if stream is None:
        stream = _STAGE_STREAMS[(device, s)] = torch.cuda.Stream(device=device)
    return stream


def _payload_tensors(v) -> list:
    """The tensors of a boundary value: an activation, or the two of an
    int8 ``{"__q__", "__s__"}`` wire payload."""
    return list(v.values()) if isinstance(v, dict) else [v]


def _payload_map(v, fn):
    return {k: fn(t) for k, t in v.items()} if isinstance(v, dict) else fn(v)


def _payload_dtype(v) -> str:
    """The wire format's name, as the JAX package labels its transfers
    (``"float32"``, ``"bfloat16"``, ``"int8"``)."""
    t = v["__q__"] if isinstance(v, dict) else v
    return str(t.dtype).removeprefix("torch.")


def _stage_io(graph: LayerGraph, partition, out_name: str) -> tuple:
    """Per-stage imports/exports of a ``GraphStagePlan``.

    ``imports[s]``: node names produced in an earlier stage that stage
    ``s`` consumes (the cut-crossing activations, skew-buffered
    shortcuts included).  ``exports[s]``: names stage ``s`` emits across
    its outgoing cut (plus the graph output on the final stage).
    """
    stage_of = partition.stage_index()
    imports = [set() for _ in range(partition.n_stages)]
    exports = [set() for _ in range(partition.n_stages)]
    for v in graph.topo_order():
        for u in graph.preds(v):
            if stage_of[u] != stage_of[v]:
                imports[stage_of[v]].add(u)
                exports[stage_of[u]].add(u)
    exports[stage_of[out_name]].add(out_name)
    return imports, exports


def stage_functions(
    graph: LayerGraph,
    *,
    partition,
    impls: Optional[Dict[str, Impl]] = None,
    plan: Optional[Mapping[str, ImplPlan]] = None,
    overrides: Optional[Mapping[str, Impl]] = None,
    executed: Optional[Dict[str, Dict[str, int]]] = None,
    dtype: torch.dtype = torch.float32,
    check: bool = True,
    link_quant=None,
    placement=None,
    device=None,
) -> "StagePipeline":
    """Build the per-stage callables of a stage partition.

    Each stage fn has signature ``fn(stage_params, boundary_in, x)``:
    ``boundary_in`` maps the stage's imported (cut-crossing) node names
    to tensors and ``x`` is the network input for stage 0 (None
    elsewhere); it returns the dict of tensors the stage exports across
    its outgoing cut (plus the graph output on the final stage).  The
    stages run eagerly, node by node, through the same kernels and
    checks as ``apply_graph``.

    ``link_quant`` turns on quantized cut crossings: the producing stage
    encodes each crossing activation to its wire dtype (``_link_encode``)
    and every consuming stage decodes it to ``dtype``, so what moves
    between stages is what the plan's ``StreamBuffer`` widths were priced
    for.  Accepts ``True`` (the plan's ``link_dtype``), a dtype str, a
    per-producer {src: dtype}, or an edge-keyed {(src, dst): dtype} map.
    The graph output is never encoded.

    ``placement`` places stage s on a device of its own (see
    ``resolve_stage_devices`` for the forms; ``device`` is the home the
    pool is taken from, the card unless the caller names the CPU): the
    ``StagePipeline`` then runs each stage on a CUDA stream of its own on
    its device, moves each stage's params there once and each imported
    boundary tensor there per call (``prefetch``), so a driver that
    queues stages without waiting (``distributed.device_pipeline``, the
    stream engine's ``execute="devices"``) overlaps micro-batches on the
    card.  With ``link_quant`` the transfers carry the int8 wire
    payloads.

    Nothing is memoized: a build is Python bookkeeping over the graph
    (the stages are eager, with nothing compiled to keep), so every
    ``apply_staged`` call builds its pipeline afresh, as every
    ``apply_graph`` call builds its dispatch table.
    """
    out_name = _check_single_stream(graph)
    if hasattr(partition, "stage_plan"):  # a GraphPlan from n_stages=
        if partition.stage_plan is None:
            raise GraphExecutionError(
                "GraphPlan has no stage partition — plan with n_stages=S"
            )
        qmap = _resolve_link_quant(link_quant, graph, partition)
        partition = partition.stage_plan
    else:
        qmap = _resolve_link_quant(link_quant, graph, partition)
    devices = resolve_stage_devices(
        placement, partition.n_stages, partition, device=device
    )
    wire: Dict[str, str] = {}  # producer -> wire dtype (one stream each)
    for (u, _v), dt in qmap.items():
        if wire.setdefault(u, dt) != dt:
            raise GraphExecutionError(
                f"conflicting link dtypes for producer {u!r}: one physical "
                f"stream leaves it, so all its cut edges must share a width"
            )
    if list(partition.order) != graph.topo_order():
        raise GraphExecutionError(
            "partition does not cover this graph (node order differs)"
        )
    if executed is None:
        executed = {}
    table = _build_table(
        impls=impls, plan=plan, overrides=overrides, graph=graph, executed=executed
    )
    overridden = frozenset(overrides or ())
    imports, exports = _stage_io(graph, partition, out_name)

    def make_stage(nodes, out):
        def run_stage(sp, bnd, xin):
            values = dict(bnd)
            _run_nodes(
                graph,
                nodes,
                values,
                sp,
                table,
                x_input=xin,
                plan=plan,
                executed=executed,
                overridden=overridden,
                check=check,
                link_quant=qmap,
                dtype=dtype,
            )
            return {
                e: _link_encode(values[e], wire[e]) if e in wire else values[e]
                for e in out
            }
        return run_stage

    return StagePipeline(
        partition=partition,
        stage_fns=[
            make_stage(partition.stage_nodes(s), tuple(sorted(exports[s])))
            for s in range(partition.n_stages)
        ],
        imports=imports,
        exports=exports,
        out_name=out_name,
        link_quant_edges=qmap,
        dtype=dtype,
        devices=devices,
    )


class StagePipeline:
    """The built stages of a partition plus their boundary wiring.

    ``run_stage(s, params, boundary, x)`` executes one stage against a
    per-batch ``boundary`` dict (imported tensors in, exported tensors
    merged back in); ``staged_forward``'s callable is the loop over s.

    With ``devices`` (a per-stage device tuple from
    ``resolve_stage_devices``) the pipeline is *placed*.  Stage params
    move to their stage's device once and are cached by identity; every
    ``run_stage`` first moves the stage's imports there (``prefetch``).
    On CUDA each stage has a ``torch.cuda.Stream`` of its own on its
    device (the counterpart of a JAX device queue; stage s of every
    pipeline on a card shares that card's stage-s stream, so a new
    pipeline finds the allocator's memory warm) and runs under it: before it
    launches, a stage waits on the event each producer stage recorded
    for this batch (stage 0 on the caller's stream, for ``x``), and every
    tensor one stream made and another reads is ``record_stream``-ed for
    the reader, so the caching allocator never hands a boundary tensor's
    memory to another batch while a later stage may still read it.  A
    driver may therefore drop a boundary entry after its last consumer
    (``keep_after``), as the JAX package donates it.  Nothing waits on
    the host: the caller's stream reads the outputs after ``join()``.
    """

    def __init__(
        self,
        *,
        partition,
        stage_fns,
        imports,
        exports,
        out_name,
        link_quant_edges=None,
        dtype: torch.dtype = torch.float32,
        devices=None,
    ):
        self.partition = partition
        self.stage_fns = stage_fns
        self.imports = imports
        self.exports = exports
        self.out_name = out_name
        # {(src, dst): wire dtype} of the quantized crossings ({} = off);
        # boundary values for encoded producers are wire payloads, not
        # activations — decode with ``decode_boundary`` before comparing.
        self.link_quant_edges = dict(link_quant_edges or {})
        self.dtype = dtype
        self._stage_of = partition.stage_index()
        # imports only stage s consumes: dropping them after stage s is
        # the JAX package's donation (reported to the transfer hook)
        self._donate = []
        for s in range(len(imports)):
            later = set().union(*imports[s + 1 :]) if imports[s + 1 :] else set()
            self._donate.append({u for u in imports[s] if u not in later})
        self._observer = None
        self.devices = None
        self.streams = None
        if devices:
            self.place(devices)

    @property
    def n_stages(self) -> int:
        return self.partition.n_stages

    def place(self, devices) -> None:
        """Put stage s on ``devices[s]``; on CUDA each stage gets a stream
        of its own on its device."""
        devices = tuple(devices)
        if len({d.type for d in devices}) != 1:
            raise GraphExecutionError(
                f"stages placed on devices of different types: {devices}"
            )
        self.devices = devices
        self.streams = None
        if devices[0].type == "cuda":
            self.streams = tuple(_stage_stream(d, s) for s, d in enumerate(devices))
        self._placed_params: Dict[int, tuple] = {}
        # id(boundary) -> (boundary, {stage: event recorded after it}):
        # the events a batch's later stages wait on, dropped after its
        # last stage (the entry holds the dict, so its id stays unique)
        self._ready: Dict[int, tuple] = {}

    def stage_params(self, s: int, params: Params) -> Params:
        nodes = self.partition.stage_nodes(s)
        return {n: params[n] for n in nodes if n in params}

    def observe(self, hook) -> None:
        """Register ``hook(stage=, name=, nbytes=, dtype=, donated=)``,
        called on every placed cut transfer ``prefetch`` issues, even
        between co-resident stages, as in the JAX package (the serving
        engine folds it into ``transfer_bytes{edge,dtype}``).  ``nbytes``
        is the payload's: an int8 crossing counts its int8 tensor and its
        scale.  Pass ``None`` to detach.  An unplaced pipeline moves
        nothing across a cut and never calls the hook."""
        self._observer = hook

    def keep_after(self) -> List[set]:
        """``keep_after()[s]``: the boundary keys still live once stage
        ``s`` has run — what later stages import, plus the graph output
        after the final stage.  A pipelining driver prunes the rest."""
        keep: set = set()
        out: List[set] = [set() for _ in range(self.n_stages)]
        for s in range(self.n_stages - 1, -1, -1):
            if s == self.n_stages - 1:
                keep = {self.out_name}
            else:
                keep = keep | set(self.imports[s + 1])
            out[s] = set(keep)
        return out

    def _stream(self, s: int):
        return None if self.streams is None else self.streams[s]

    def _on(self, s: int):
        stream = self._stream(s)
        return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)

    def _move(self, t: torch.Tensor, s: int) -> torch.Tensor:
        """``t`` on stage ``s``'s device, for stage ``s``'s stream to read
        (called under that stream)."""
        dev, stream = self.devices[s], self._stream(s)
        if stream is None:
            return t.to(dev)
        if t.device == dev:
            t.record_stream(stream)
            return t
        moved = t.to(dev, non_blocking=True)
        if t.is_cuda:
            # a copy between cards runs on the source card's current
            # stream, fenced both ways with this one
            t.record_stream(torch.cuda.current_stream(t.device))
        return moved

    def _placed_stage_params(self, s: int, params: Params) -> Params:
        ent = self._placed_params.get(s)
        if ent is not None and ent[0] is params:
            return ent[1]
        dev, stream = self.devices[s], self._stream(s)
        sp = {n: {k: t.to(dev) for k, t in p.items()}
              for n, p in self.stage_params(s, params).items()}
        if stream is not None:
            # the params (or their copies) were written on the caller's
            # stream; the stage's stream reads them from now on
            stream.wait_stream(torch.cuda.current_stream(dev))
            for p in sp.values():
                for t in p.values():
                    t.record_stream(stream)
        self._placed_params[s] = (params, sp)
        return sp

    def prefetch(self, s: int, boundary: Dict[str, object]) -> None:
        """Move stage ``s``'s imports onto its device now.

        On CUDA the copy is queued on stage ``s``'s stream after the
        events its producers recorded for this batch, so a driver that
        issues it right after the producer (``DevicePipeline``) overlaps
        it with other stages' work; between co-resident stages nothing
        moves.  The moved value replaces the boundary entry; each
        transfer is reported to the ``observe`` hook.  No-op when
        unplaced.
        """
        if self.devices is None:
            return
        stream = self._stream(s)
        if stream is not None:
            self._await_producers(s, boundary, stream)
        with self._on(s):
            for u in sorted(self.imports[s]):
                if u not in boundary:
                    continue
                v = boundary[u]
                if self._observer is not None:
                    self._observer(
                        stage=s,
                        name=u,
                        nbytes=sum(t.numel() * t.element_size()
                                   for t in _payload_tensors(v)),
                        dtype=_payload_dtype(v),
                        donated=(u in self._donate[s]),
                    )
                boundary[u] = _payload_map(v, lambda t: self._move(t, s))

    def _await_producers(self, s: int, boundary, stream) -> None:
        """Stage ``s``'s stream waits for this batch's producer stages;
        imports the pipeline did not produce were made on the caller's
        stream, which it waits for instead."""
        ent = self._ready.get(id(boundary))
        events = ent[1] if ent is not None and ent[0] is boundary else {}
        for p in sorted({self._stage_of[u] for u in self.imports[s] if u in boundary}):
            if p in events:
                stream.wait_event(events[p])
            else:
                stream.wait_stream(torch.cuda.current_stream(self.devices[s]))

    def run_stage(
        self,
        s: int,
        params: Params,
        boundary: Dict[str, object],
        x: Optional[torch.Tensor] = None,
    ) -> Dict[str, object]:
        if self.devices is None:
            sp = self.stage_params(s, params)
        else:
            self.prefetch(s, boundary)
            sp = self._placed_stage_params(s, params)
            if s == 0 and x is not None:
                stream = self._stream(0)
                if stream is not None and x.is_cuda:
                    stream.wait_stream(torch.cuda.current_stream(x.device))
                with self._on(0):
                    x = self._move(x, 0)
        bnd_in = {u: boundary[u] for u in self.imports[s]}
        stream = self._stream(s)
        with self._on(s):
            out = self.stage_fns[s](sp, bnd_in, x if s == 0 else None)
        if stream is not None:
            ent = self._ready.get(id(boundary))
            if s == 0 or ent is None or ent[0] is not boundary:
                ent = self._ready[id(boundary)] = (boundary, {})
            ent[1][s] = stream.record_event()
            if s == self.n_stages - 1:
                del self._ready[id(boundary)]
        boundary.update(out)
        return boundary

    def keep_for_caller(self, value):
        """Record every tensor of ``value`` (an activation or a wire
        payload) for the caller's current stream on its device, so its
        memory outlives the caller's queued reads of it; returns
        ``value``.  Wait for the stages with ``join`` before reading."""
        if self.streams is not None:
            for t in _payload_tensors(value):
                t.record_stream(torch.cuda.current_stream(t.device))
        return value

    def join(self) -> None:
        """The caller's current stream, on each stage's device, waits for
        the work every stage has queued so far; the host does not wait.
        A no-op unless the stages run on streams of their own."""
        for stream in self.streams or ():
            torch.cuda.current_stream(stream.device).wait_stream(stream)

    def decode_boundary(self, boundary: Dict[str, object]) -> Dict[str, torch.Tensor]:
        """The boundary dict with every wire payload decoded back into an
        activation of the pipeline's dtype — what to compare against the
        monolithic reference when link quantization is on."""
        wire = {u: dt for (u, _v), dt in self.link_quant_edges.items()}
        return {
            name: _link_decode(v, wire[name], self.dtype) if name in wire else v
            for name, v in boundary.items()
        }


def staged_forward(
    graph: LayerGraph,
    *,
    partition,
    impls: Optional[Dict[str, Impl]] = None,
    plan: Optional[Mapping[str, ImplPlan]] = None,
    overrides: Optional[Mapping[str, Impl]] = None,
    executed: Optional[Dict[str, Dict[str, int]]] = None,
    dtype: torch.dtype = torch.float32,
    check: bool = True,
    link_quant=None,
    placement=None,
    device=None,
) -> Callable[[Params, torch.Tensor], Dict[str, torch.Tensor]]:
    """Build the staged pipeline once; returns ``fn(params, x)``, which
    threads the boundary activations through the stages and returns every
    cut-crossing tensor plus the graph output, keyed by node name, wire
    payloads decoded (the activations as the crossings delivered them),
    readable on the caller's stream.  ``placement`` / ``device`` as in
    ``stage_functions``."""
    pipeline = stage_functions(
        graph,
        partition=partition,
        impls=impls,
        plan=plan,
        overrides=overrides,
        executed=executed,
        dtype=dtype,
        check=check,
        link_quant=link_quant,
        placement=placement,
        device=device,
    )

    def forward(params: Params, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(dtype).contiguous()
        boundary: Dict[str, torch.Tensor] = {}
        for s in range(pipeline.n_stages):
            pipeline.run_stage(s, params, boundary, x if s == 0 else None)
        pipeline.join()
        for v in boundary.values():
            pipeline.keep_for_caller(v)
        return pipeline.decode_boundary(boundary)

    return forward


def apply_staged(
    params: Params,
    x: torch.Tensor,
    graph: LayerGraph,
    *,
    partition,
    impls: Optional[Dict[str, Impl]] = None,
    plan: Optional[Mapping[str, ImplPlan]] = None,
    overrides: Optional[Mapping[str, Impl]] = None,
    executed: Optional[Dict[str, Dict[str, int]]] = None,
    dtype: torch.dtype = torch.float32,
    check: bool = True,
    check_monolithic: bool = False,
    link_quant=None,
    placement=None,
) -> torch.Tensor:
    """Multi-chip forward pass: execute ``graph`` stage by stage.

    ``partition`` is a ``core.stage_partition.GraphStagePlan`` (or a
    ``core.graph.GraphPlan`` planned with ``n_stages=``).  Each stage's
    subgraph runs as its own function; activations crossing a cut —
    skew-buffered shortcuts included — are threaded across the stage
    boundaries as the inter-chip stream buffers would carry them.
    ``impls`` / ``plan`` / ``overrides`` / ``check`` behave as in
    ``apply_graph``.  ``placement`` places stage s on a device of its
    own, from the pool of ``x``'s device (see ``stage_functions``).

    ``check_monolithic=True`` also runs the monolithic ``apply_graph``
    on the same inputs (with the identical fake-quant on the mapped
    edges when ``link_quant`` is on) and asserts every cut-crossing
    tensor and the output are bit-identical (``torch.equal``): both
    sides run the same kernels on the same batch, in the same order.
    """
    out_name = _check_single_stream(graph)
    user_executed = executed is not None
    if executed is None:
        executed = {}
    forward = staged_forward(
        graph,
        partition=partition,
        impls=impls,
        plan=plan,
        overrides=overrides,
        executed=executed if user_executed else None,
        dtype=dtype,
        check=check,
        link_quant=link_quant,
        placement=placement,
        device=x.device,
    )
    boundary = forward(params, x)

    if check_monolithic:
        table = _build_table(
            impls=impls, plan=plan, overrides=overrides, graph=graph, executed=executed
        )
        qmap = _resolve_link_quant(link_quant, graph, partition)
        mono: Dict[str, torch.Tensor] = {}
        _run_nodes(
            graph,
            graph.topo_order(),
            mono,
            params,
            table,
            x_input=x.to(dtype).contiguous(),
            plan=plan,
            executed=executed,
            overridden=frozenset(overrides or ()),
            check=False,
            link_quant=qmap,
            dtype=dtype,
        )
        wire = {u: dt for (u, _v), dt in qmap.items()}
        for name, val in boundary.items():
            ref = mono[name]
            if name in wire:
                # the staged boundary holds the delivered (decoded)
                # activation: send the reference through the same wire
                ref = _link_decode(ref, wire[name], dtype)
            if not torch.equal(val.to(ref.device), ref):
                raise GraphExecutionError(
                    f"staged output for {name!r} diverges from the "
                    f"monolithic apply_graph"
                )
    return boundary[out_name]


# ==========================================================================
# The int8 weight datapath (the paper runs 8-bit arithmetic)
# ==========================================================================


def quantize_params(params: Params, bits: int = 8):
    """Per-tensor symmetric int8 weights; returns (q_params, scales), each
    scale a 0-d tensor of the weights' dtype, as in the JAX package."""
    qmax = 2 ** (bits - 1) - 1
    q, scales = {}, {}
    for name, p in params.items():
        s = torch.clamp(p["w"].abs().max(), min=1e-8) / exact_divisor(qmax, p["w"])
        q[name] = {"w": torch.round(p["w"] / s).to(torch.int8), "b": p["b"]}
        scales[name] = s
    return q, scales


def dequantize_params(q_params, scales, dtype: torch.dtype = torch.float32) -> Params:
    """int8 weights back to ``dtype``: the product in f32, then one cast.
    (The JAX package's product at ``dtype=bfloat16`` promotes to f32 and
    stays there; the port hands the forward its own dtype.)"""
    return {
        name: {"w": (p["w"].float() * scales[name].float()).to(dtype), "b": p["b"]}
        for name, p in q_params.items()
    }


def apply_int8(
    q_params,
    scales,
    x: torch.Tensor,
    graph: LayerGraph,
    *,
    impls: Optional[Dict[str, Impl]] = None,
    plan: Optional[Mapping[str, ImplPlan]] = None,
    overrides: Optional[Mapping[str, Impl]] = None,
    partition=None,
    dtype: torch.dtype = torch.float32,
    check: bool = True,
) -> torch.Tensor:
    """Inference with int8 weights dequantized on the fly (the FPGA's int8
    weight datapath; activations stay float).  ``plan`` / ``overrides``
    as in ``apply_graph``; ``partition`` routes through the staged
    executor (``apply_staged``) instead of the monolithic pass."""
    deq = dequantize_params(q_params, scales, dtype)
    if partition is not None:
        return apply_staged(
            deq,
            x,
            graph,
            partition=partition,
            impls=impls,
            plan=plan,
            overrides=overrides,
            dtype=dtype,
            check=check,
        )
    return apply_graph(
        deq, x, graph, impls=impls, plan=plan, overrides=overrides, dtype=dtype,
        check=check,
    )
