"""ResNet-18/34: LayerGraph DAGs for the DSE **and** the executable net.

The port's counterpart of the JAX package's ``models/resnet.py``.  Every
basic block is a diamond — a two-conv trunk against an identity (or
strided 1x1 projection) shortcut, re-converging in an elementwise add.
``resnet18_graph()`` / ``resnet34_graph()`` build the ``LayerGraph`` the
DSE plans; ``init_params`` / ``apply`` run that same graph through the
shared executor in ``models/cnn.py`` (NHWC, folded BN).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.graph import LayerGraph
from repro_torch.models import cnn
from repro_torch.models.topology import (
    add_spec,
    conv_spec,
    dense_spec,
    gap_spec,
    pool_spec,
)

_RESNET_STAGES = {
    18: [(64, 2), (128, 2), (256, 2), (512, 2)],
    34: [(64, 3), (128, 4), (256, 6), (512, 3)],
}


def _conv(
    name: str, d_in: int, d_out: int, hw: Tuple[int, int], k: int, s: int, act: str
) -> Tuple:
    return conv_spec(name, "conv", d_in, d_out, hw, k, s, act=act)


def _basic_block(
    g: LayerGraph,
    prev: str,
    name: str,
    d_in: int,
    d_out: int,
    hw: Tuple[int, int],
    stride: int,
) -> Tuple[str, Tuple[int, int]]:
    """conv3x3(s)+relu -> conv3x3(1) summed with the shortcut (identity,
    or a strided 1x1 projection when shape changes), relu after the add."""
    block_in = prev
    spec, mid_hw = _conv(f"{name}_conv1", d_in, d_out, hw, 3, stride, "relu")
    prev = g.add(spec, [prev])
    spec, out_hw = _conv(f"{name}_conv2", d_out, d_out, mid_hw, 3, 1, "none")
    prev = g.add(spec, [prev])
    if stride != 1 or d_in != d_out:
        ds, ds_hw = _conv(f"{name}_down", d_in, d_out, hw, 1, stride, "none")
        assert ds_hw == out_hw
        shortcut = g.add(ds, [block_in])
    else:
        shortcut = block_in
    prev = g.add(add_spec(f"{name}_add", d_out, out_hw, act="relu"), [prev, shortcut])
    return prev, out_hw


def _resnet_graph(
    stages: List[Tuple[int, int]], input_hw: Tuple[int, int], num_classes: int
) -> LayerGraph:
    g = LayerGraph()
    spec, hw = _conv("conv1", 3, 64, input_hw, 7, 2, "relu")
    prev = g.add(spec)
    spec, hw = pool_spec("maxpool", 64, hw, 3, 2)
    prev = g.add(spec, [prev])
    d = 64
    for si, (ch, blocks) in enumerate(stages, start=1):
        for bi in range(blocks):
            stride = 2 if (si > 1 and bi == 0) else 1
            prev, hw = _basic_block(g, prev, f"l{si}b{bi + 1}", d, ch, hw, stride)
            d = ch
    prev = g.add(gap_spec("gap", d, hw), [prev])
    g.add(dense_spec("fc", d, num_classes), [prev])
    return g


def resnet18_graph(
    input_hw: Tuple[int, int] = (224, 224), num_classes: int = 1000
) -> LayerGraph:
    return _resnet_graph(_RESNET_STAGES[18], input_hw, num_classes)


def resnet34_graph(
    input_hw: Tuple[int, int] = (224, 224), num_classes: int = 1000
) -> LayerGraph:
    return _resnet_graph(_RESNET_STAGES[34], input_hw, num_classes)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 18  # 18 | 34
    input_hw: Tuple[int, int] = (224, 224)
    num_classes: int = 1000
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.depth not in _RESNET_STAGES:
            raise ValueError(f"unsupported ResNet depth {self.depth}")

    def graph(self) -> LayerGraph:
        return _resnet_graph(
            _RESNET_STAGES[self.depth], self.input_hw, self.num_classes
        )


def init_params(
    cfg: ResNetConfig, generator: torch.Generator, device
) -> cnn.Params:
    return cnn.init_graph_params(cfg.graph(), generator, cfg.dtype, device)


def apply(
    params: cnn.Params,
    x: torch.Tensor,
    cfg: ResNetConfig,
    *,
    conv_impls: Optional[Dict[str, cnn.Impl]] = None,
    plan=None,
    overrides=None,
    executed=None,
    check: bool = True,
    graph: Optional[LayerGraph] = None,
) -> torch.Tensor:
    """Forward pass.  ``x``: [N, H, W, 3].  Returns logits [N, classes].

    ``conv_impls`` overrides {'conv', 'dwconv', 'pointwise', 'dense'};
    ``plan`` (a ``GraphPlan.kernel_plan()`` table) runs the rate-matched
    path — each node's CUDA kernel tiled per its own DSE choice;
    ``overrides`` supplies node-name-keyed impls that win over both.
    ``graph`` defaults to ``cfg.graph()``.
    """
    return cnn.apply_graph(
        params,
        x,
        cfg.graph() if graph is None else graph,
        impls=conv_impls,
        plan=plan,
        overrides=overrides,
        executed=executed,
        dtype=cfg.dtype,
        check=check,
    )


def apply_staged(
    params: cnn.Params,
    x: torch.Tensor,
    cfg: ResNetConfig,
    *,
    partition,
    conv_impls: Optional[Dict[str, cnn.Impl]] = None,
    plan=None,
    overrides=None,
    executed=None,
    check: bool = True,
    check_monolithic: bool = False,
    link_quant=None,
    placement=None,
    graph: Optional[LayerGraph] = None,
) -> torch.Tensor:
    """Multi-chip forward pass over a stage partition (a
    ``GraphStagePlan`` or a ``GraphPlan`` planned with ``n_stages=``):
    each stage run as its own function, cut-crossing activations
    threaded across the boundaries.  ``graph`` defaults to
    ``cfg.graph()``.  See ``cnn.apply_staged``."""
    return cnn.apply_staged(
        params,
        x,
        cfg.graph() if graph is None else graph,
        partition=partition,
        impls=conv_impls,
        plan=plan,
        overrides=overrides,
        executed=executed,
        dtype=cfg.dtype,
        check=check,
        check_monolithic=check_monolithic,
        link_quant=link_quant,
        placement=placement,
    )


# the paper's 8-bit datapath, shared with every CNN family
quantize_params = cnn.quantize_params


def apply_int8(
    q_params,
    scales,
    x: torch.Tensor,
    cfg: ResNetConfig,
    *,
    plan=None,
    overrides=None,
    partition=None,
    graph: Optional[LayerGraph] = None,
) -> torch.Tensor:
    """Inference with int8 weights dequantized on the fly to
    ``cfg.dtype`` (the FPGA's int8 weight datapath; activations stay
    float); ``partition`` runs it staged.  See ``cnn.apply_int8``."""
    return cnn.apply_int8(
        q_params,
        scales,
        x,
        cfg.graph() if graph is None else graph,
        plan=plan,
        overrides=overrides,
        partition=partition,
        dtype=cfg.dtype,
    )
