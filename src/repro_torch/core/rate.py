"""Data-rate algebra for continuous-flow accelerators (paper §II).

The port's own copy of the JAX package's ``core/rate.py``.  Rates are exact ``fractions.Fraction``
values in **features per clock** (the paper's r).  A rate ``r`` entering
a layer with ``d_in`` channels corresponds to a *pixel* rate
``q = r / d_in`` (pixels per clock).

Rate propagation through a layer in steady state:

    q_out = q_in * (H_out * W_out) / (H_in * W_in)      (spatial decimation)
    r_out = q_out * d_out                               (channel expansion)
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Sequence, Tuple

LayerKind = str
# 'conv' | 'dwconv' | 'pointwise' | 'dense' | 'pool' | 'add' | 'gap' | 'concat'
#   | 'split' | 'merge'
# 'add' and 'concat' are JOIN kinds: in a LayerGraph they may have several
# producers.  For 'add', d_in is the per-operand channel count; for
# 'concat' it is the sum over operands.  'split' / 'merge' are Multi-CLP
# replication wiring: a 'split' round-robin-deals its frame stream across
# its >= 2 consumers, a 'merge' re-interleaves them in order.


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static description of one layer of the network graph (chain or DAG)."""

    name: str
    kind: LayerKind
    d_in: int
    d_out: int
    in_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    kernel: Tuple[int, int] = (1, 1)
    stride: Tuple[int, int] = (1, 1)
    channel_multiplier: int = 1       # depthwise only
    padding: str = "same"
    # post-layer nonlinearity ('none' | 'relu' | 'relu6'), applied by the
    # executor (models/cnn.py) so topology and inference share one spec.
    activation: str = "none"

    @property
    def k_taps(self) -> int:
        return self.kernel[0] * self.kernel[1]

    @property
    def spatial_ratio(self) -> Fraction:
        """out_pixels / in_pixels — the pixel-rate decimation factor."""
        return Fraction(
            self.out_hw[0] * self.out_hw[1], self.in_hw[0] * self.in_hw[1]
        )

    @property
    def macs_per_pixel(self) -> int:
        """Multiply ops per *output* pixel (the workload, not the hardware)."""
        if self.kind == "conv":
            return self.d_in * self.d_out * self.k_taps
        if self.kind == "dwconv":
            return self.d_in * self.channel_multiplier * self.k_taps
        if self.kind in ("pointwise", "dense"):
            return self.d_in * self.d_out
        return 0  # pool / add / gap have no multiplies

    @property
    def total_macs(self) -> int:
        return self.macs_per_pixel * self.out_hw[0] * self.out_hw[1]

    @property
    def weight_count(self) -> int:
        if self.kind == "conv":
            return self.d_in * self.d_out * self.k_taps + self.d_out
        if self.kind == "dwconv":
            return self.d_in * self.channel_multiplier * self.k_taps + self.d_out
        if self.kind in ("pointwise", "dense"):
            return self.d_in * self.d_out + self.d_out
        return 0


@dataclasses.dataclass(frozen=True)
class RatePoint:
    """The data rate at one edge of the graph."""

    features_per_clock: Fraction   # the paper's r
    d: int                         # channels at this edge

    @property
    def pixels_per_clock(self) -> Fraction:
        return self.features_per_clock / self.d


def propagate_chain(
    input_rate: Fraction, layers: Sequence[LayerSpec]
) -> List[RatePoint]:
    """Rates at every edge: [input, after layer0, after layer1, ...]."""
    if not layers:
        return []
    pts = [RatePoint(features_per_clock=input_rate, d=layers[0].d_in)]
    for layer in layers:
        pts.append(propagate(pts[-1], layer))
    return pts


def propagate(rate_in: RatePoint, layer: LayerSpec) -> RatePoint:
    """Steady-state output rate of ``layer`` given its input rate."""
    if layer.d_in != rate_in.d:
        raise ValueError(
            f"{layer.name}: d_in={layer.d_in} but incoming rate has d={rate_in.d}"
        )
    q_out = rate_in.pixels_per_clock * layer.spatial_ratio
    return RatePoint(features_per_clock=q_out * layer.d_out, d=layer.d_out)


def divisors(n: int) -> List[int]:
    """All positive divisors of n, ascending."""
    if n <= 0:
        raise ValueError(f"divisors({n})")
    small, large = [], []
    i = 1
    while i * i <= n:
        if n % i == 0:
            small.append(i)
            if i != n // i:
                large.append(n // i)
        i += 1
    return small + large[::-1]


def frame_cycles(hw: Tuple[int, int], pixels_per_clock: Fraction) -> Fraction:
    """Clock cycles to stream one frame through the accelerator input.

    Matches the paper's Table II throughput model: one blank column per
    image row for sliding-window flushing, i.e. (W+1)*H pixel slots.
    (224x224 @ 403.71 MHz, 2 px/clk -> 16,020 FPS exactly as published.)
    """
    h, w = hw
    return Fraction((w + 1) * h) / pixels_per_clock


def fps(hw: Tuple[int, int], pixels_per_clock: Fraction, f_hz: float) -> float:
    """Frames per second at clock ``f_hz``."""
    return f_hz / float(frame_cycles(hw, pixels_per_clock))
