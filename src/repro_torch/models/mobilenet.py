"""MobileNetV1/V2 — the paper's evaluation models.

The port's counterpart of the JAX package's ``models/mobilenet.py``.
``mobilenet_v1_chain()`` / ``mobilenet_v2_chain()`` give the LayerSpec
chains and ``mobilenet_v2_graph()`` the true DAG with residual joins,
all from one block description (``_v2_body``); ``init_params`` /
``apply`` run the graph through the shared executor in models/cnn.py
(NHWC, BatchNorm folded into conv scale/bias).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.graph import LayerGraph
from repro_torch.core.rate import LayerSpec
from repro_torch.models import cnn
from repro_torch.models.topology import (
    add_spec,
    conv_spec as _conv,
    dense_spec,
    gap_spec,
)


def mobilenet_v1_chain(
    input_hw: Tuple[int, int] = (224, 224),
    alpha: float = 1.0,
    num_classes: int = 1000,
) -> List[LayerSpec]:
    def c(ch):
        return max(8, int(ch * alpha))

    layers: List[LayerSpec] = []
    hw = input_hw
    spec, hw = _conv("conv1", "conv", 3, c(32), hw, 3, 2, act="relu6")
    layers.append(spec)
    # (dw stride, pw out channels)
    cfg = [
        (1, 64),
        (2, 128),
        (1, 128),
        (2, 256),
        (1, 256),
        (2, 512),
        (1, 512),
        (1, 512),
        (1, 512),
        (1, 512),
        (1, 512),
        (2, 1024),
        (1, 1024),
    ]
    d = c(32)
    for i, (s, out) in enumerate(cfg):
        spec, hw = _conv(f"dw{i + 1}", "dwconv", d, d, hw, 3, s, act="relu6")
        layers.append(spec)
        spec, hw = _conv(f"pw{i + 1}", "pointwise", d, c(out), hw, 1, 1, act="relu6")
        layers.append(spec)
        d = c(out)
    layers.append(gap_spec("gap", d, hw))
    layers.append(dense_spec("fc", d, num_classes))
    return layers


_V2_CFG = [
    # (expansion t, out channels c, repeats n, first stride s)
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _v2_channels(alpha: float):
    def c(ch):
        ch = int(ch * alpha)
        return max(8, (ch + 4) // 8 * 8)

    return c


class _ChainSink:
    """Collects the linear LayerSpec sequence; residual edges are dropped."""

    def __init__(self) -> None:
        self.layers: List[LayerSpec] = []

    def start_block(self) -> None:
        pass

    def layer(self, spec: LayerSpec) -> None:
        self.layers.append(spec)

    def join(self, name: str, d: int, hw: Tuple[int, int]) -> None:
        pass


class _GraphSink:
    """Builds the true DAG: an explicit 'add' join per residual block."""

    def __init__(self) -> None:
        self.g = LayerGraph()
        self.prev: Optional[str] = None
        self.block_in: Optional[str] = None

    def start_block(self) -> None:
        self.block_in = self.prev

    def layer(self, spec: LayerSpec) -> None:
        self.prev = self.g.add(spec, [self.prev] if self.prev is not None else [])

    def join(self, name: str, d: int, hw: Tuple[int, int]) -> None:
        self.prev = self.g.add(add_spec(name, d, hw), [self.prev, self.block_in])


def _v2_body(sink, input_hw, alpha):
    """Walk the V2 block description once, emitting into ``sink``.
    Returns (final channels, final hw)."""
    c = _v2_channels(alpha)
    hw = input_hw
    spec, hw = _conv("conv1", "conv", 3, c(32), hw, 3, 2, act="relu6")
    sink.layer(spec)
    d = c(32)
    blk = 0
    for t, ch, n, s in _V2_CFG:
        for i in range(n):
            blk += 1
            stride = s if i == 0 else 1
            exp = d * t
            sink.start_block()
            if t != 1:
                spec, hw = _conv(
                    f"b{blk}_expand", "pointwise", d, exp, hw, 1, 1, act="relu6"
                )
                sink.layer(spec)
            spec, hw = _conv(
                f"b{blk}_dw", "dwconv", exp, exp, hw, 3, stride, act="relu6"
            )
            sink.layer(spec)
            # linear bottleneck: no activation on the projection
            spec, hw = _conv(
                f"b{blk}_project", "pointwise", exp, c(ch), hw, 1, 1, act="none"
            )
            sink.layer(spec)
            if stride == 1 and d == c(ch):
                sink.join(f"b{blk}_add", c(ch), hw)
            d = c(ch)
    last = c(1280) if alpha > 1.0 else 1280
    spec, hw = _conv("conv_last", "pointwise", d, last, hw, 1, 1, act="relu6")
    sink.layer(spec)
    return last, hw


def mobilenet_v2_chain(
    input_hw: Tuple[int, int] = (224, 224),
    alpha: float = 1.0,
    num_classes: int = 1000,
) -> List[LayerSpec]:
    sink = _ChainSink()
    d, hw = _v2_body(sink, input_hw, alpha)
    sink.layers.append(gap_spec("gap", d, hw))
    sink.layers.append(dense_spec("fc", d, num_classes))
    return sink.layers


def mobilenet_v2_graph(
    input_hw: Tuple[int, int] = (224, 224),
    alpha: float = 1.0,
    num_classes: int = 1000,
) -> LayerGraph:
    """MobileNetV2 as a true DAG: stride-1 inverted-residual blocks with
    matching channels get an explicit 'add' join between the project
    output and the block input."""
    sink = _GraphSink()
    d, hw = _v2_body(sink, input_hw, alpha)
    prev = sink.g.add(gap_spec("gap", d, hw), [sink.prev])
    sink.g.add(dense_spec("fc", d, num_classes), [prev])
    return sink.g


@dataclasses.dataclass(frozen=True)
class MobileNetConfig:
    version: int = 2
    input_hw: Tuple[int, int] = (224, 224)
    alpha: float = 1.0
    num_classes: int = 1000
    dtype: torch.dtype = torch.float32

    def chain(self) -> List[LayerSpec]:
        fn = mobilenet_v1_chain if self.version == 1 else mobilenet_v2_chain
        return fn(self.input_hw, self.alpha, self.num_classes)

    def graph(self) -> LayerGraph:
        """DAG view: v2 gets real residual joins; v1 is a linear graph."""
        if self.version == 2:
            return mobilenet_v2_graph(self.input_hw, self.alpha, self.num_classes)
        return LayerGraph.from_chain(self.chain())


def init_params(
    cfg: MobileNetConfig, generator: torch.Generator, device
) -> cnn.Params:
    """He-init weights + folded-BN bias for every layer in the graph."""
    return cnn.init_graph_params(cfg.graph(), generator, cfg.dtype, device)


def apply(
    params: cnn.Params,
    x: torch.Tensor,
    cfg: MobileNetConfig,
    *,
    conv_impls: Optional[Dict[str, cnn.Impl]] = None,
    plan=None,
    overrides=None,
    executed=None,
    check: bool = True,
    graph: Optional[LayerGraph] = None,
) -> torch.Tensor:
    """Forward pass.  ``x``: [N, H, W, 3].  Returns logits [N, classes].
    Options as in ``resnet.apply``."""
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
