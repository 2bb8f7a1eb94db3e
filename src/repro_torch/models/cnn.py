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

from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.dse import NON_ARITH_KINDS
from repro_torch.core.graph import JOIN_KINDS, ImplPlan, LayerGraph
from repro_torch.core.rate import LayerSpec
from repro_torch.kernels.dw_conv import dw_conv_impl, dwconv_plain
from repro_torch.kernels.fcu_matmul import dense_impl, pointwise_impl, pointwise_plain
from repro_torch.kernels._build import windows
from repro_torch.kernels.kpu_conv import conv_impl, kpu_conv_plain

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
    against the graph so a typoed node name fails loudly)."""
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
) -> None:
    """Execute ``names`` in order, reading/writing ``values``: per-node
    forward, shape/MAC cross-check, and — on the rate-matched path — the
    executed-tile-==-plan assertion.  Nodes named in ``overridden`` run a
    user-supplied impl and are exempt from the tile assertion unless the
    override recorded into ``executed`` itself."""
    executed = executed if executed is not None else {}
    for name in names:
        spec = graph.spec(name)
        preds = graph.preds(name)
        if preds:
            missing = [p for p in preds if p not in values]
            if missing:
                raise GraphExecutionError(
                    f"{name}: operands {missing} not materialized"
                )
            operands = []
            for pr in preds:
                v = values[pr]
                if graph.spec(pr).kind == "split":
                    # Replication lane: consume the dealt subsequence of
                    # the split stream (this lane's slot in deal order).
                    lanes = graph.succs(pr)
                    v = v[lanes.index(name):: len(lanes)]
                operands.append(v)
        else:
            if x_input is None:
                raise GraphExecutionError(f"{name}: source node has no input")
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
    raises), a CPU input their plain versions.
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
    )
    return values[out_name]
