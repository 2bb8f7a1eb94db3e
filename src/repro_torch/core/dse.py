"""Design-space exploration for data-rate-matched layer implementations.

The port's own copy of the JAX package's ``core/dse.py`` (the paper's
Eqs. 1-11 as the graph planner uses them):

* ``hj_set``        — Eq. (9): all viable (j, h) with j | d_in, h | d_out,
                      j/h >= r  (continuous-flow feasibility).
* ``best_rate``     — Eq. (10): the viable rate closest to r from above.
* ``select_ours``   — Eq. (11) + the paper's tie-break: among BestRate
                      settings prefer the largest h.
* ``select_ref11``  — the [11] baseline: Eqs. (1)-(3) direct derivation.
* multi-pixel handling (paper §II-E): P pixel phases with stride pruning.

Everything is exact fraction arithmetic — no floats in feasibility logic.
Each unit consumes j input features per clock and time-multiplexes h
outputs over C = h*d_in/j weight configurations (Eq. 4); a layer's
capacity is P * j/h features per clock (Eq. 6).
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import List, Tuple

from .rate import LayerSpec, divisors

# Layers with no multipliers: comparators (pool), elementwise adders (add),
# wiring only (concat, split, merge), running means (gap).  The DSE tracks
# their phases and pass cadence but explores no (j, h) space.
NON_ARITH_KINDS = ("pool", "add", "gap", "concat", "split", "merge")


@dataclasses.dataclass(frozen=True)
class LayerImpl:
    """A chosen hardware implementation of one layer (see module docstring)."""

    layer: LayerSpec
    j: int  # input features per clock per phase
    h: int  # outputs time-multiplexed per unit
    p: int  # pixel phases after stride pruning
    p_raw: int  # pixel phases before pruning
    configs: int  # C — weight configurations per unit (Eq. 4)
    units: int  # total units instantiated (all phases)
    mults: int  # total multipliers
    scheme: str  # 'ours' | 'ref11'
    demand: Fraction  # the input rate r this layer must sustain
    capacity: Fraction  # features/clock the implementation can absorb
    pad_waste: Fraction = Fraction(0)  # [11]: fraction of padded/invalid lanes

    @property
    def rate_out(self) -> Fraction:
        """Output rate actually produced given the *demand* (steady state)."""
        lay = self.layer
        return self.demand / lay.d_in * lay.spatial_ratio * lay.d_out

    @property
    def feasible(self) -> bool:
        """Can the implementation absorb its demand?  ``select_ours``
        always yields feasible settings; [11]'s Eq. 3 can fail this."""
        return self.capacity >= self.demand

    @property
    def utilization(self) -> Fraction:
        """Busy fraction of the arithmetic: demand/capacity, minus padding."""
        if self.capacity == 0:
            return Fraction(1)
        u = min(Fraction(1), self.demand / self.capacity)
        return u * (1 - self.pad_waste)


def hj_set(d_in: int, h_domain: int, r: Fraction) -> List[Tuple[int, int]]:
    """Eq. (9): viable (j, h) with j | d_in, h | h_domain, j/h >= r."""
    return [
        (j, h)
        for j in divisors(d_in)
        for h in divisors(h_domain)
        if Fraction(j, h) >= r
    ]


def best_rate(hj: List[Tuple[int, int]]) -> Fraction:
    """Eq. (10): minimal achievable rate >= r among viable settings."""
    if not hj:
        raise ValueError("empty HJ set — rate not satisfiable")
    return min(Fraction(j, h) for j, h in hj)


def pixel_phases(r: Fraction, d_in: int) -> int:
    """Paper §II-E: phases needed when more than one pixel arrives per clock."""
    q = r / d_in
    return max(1, math.ceil(q))


def surviving_phases(p: int, stride: int) -> int:
    """Stride pruning (paper §II-E): P / gcd(P, s) phases survive."""
    if p <= 1:
        return p
    return p // math.gcd(p, stride)


def _h_domain(layer: LayerSpec) -> int:
    # §II-B: for depthwise, the channel multiplier replaces d_out.
    return layer.channel_multiplier if layer.kind == "dwconv" else layer.d_out


def _units_per_phase(layer: LayerSpec, h: int) -> int:
    if layer.kind == "dwconv":
        return max(1, layer.channel_multiplier // h)
    return layer.d_out // h


def _mults_per_unit(layer: LayerSpec, j: int) -> int:
    if layer.kind in ("conv", "dwconv"):
        return j * layer.k_taps
    if layer.kind in ("pointwise", "dense"):
        return j
    return 0


def select_ours(
    layer: LayerSpec,
    r: Fraction,
    *,
    prefer_large_h: bool = True,
    objective: str = "max_h",
) -> LayerImpl:
    """The paper's selection (Eqs. 7-11) generalized to all layer kinds.

    Multi-pixel: when r exceeds one pixel/clock, split into
    P = ceil(pixel_rate) phases each seeing r/P, then prune phases whose
    windows are all skipped by the stride (conv/dwconv/pool only).

    Only ``objective='max_h'`` (the paper's §II-D heuristic) is ported;
    the resource-model objectives raise ``NotImplementedError``.
    """
    if objective != "max_h":
        raise NotImplementedError(
            f"objective={objective!r} needs the FPGA resource model, which "
            f"the port does not carry yet (ROADMAP: DSE objectives)"
        )
    d_in = layer.d_in
    p_raw = pixel_phases(r, d_in)
    r_phase = r / p_raw

    if layer.kind in NON_ARITH_KINDS:
        stride = max(layer.stride)
        p = surviving_phases(p_raw, stride) if layer.kind == "pool" else p_raw
        return LayerImpl(
            layer=layer,
            j=min(d_in, max(1, r_phase.__ceil__())),
            h=1,
            p=p,
            p_raw=p_raw,
            configs=1,
            units=p,
            mults=0,
            scheme="ours",
            demand=r,
            capacity=Fraction(d_in * p_raw),
        )

    hd = _h_domain(layer)
    hj = hj_set(d_in, hd, r_phase)
    if not hj:
        raise ValueError(
            f"{layer.name}: no viable (j,h) for per-phase rate {r_phase} "
            f"(d_in={d_in}, h_domain={hd})"
        )
    br = best_rate(hj)
    candidates = [(j, h) for (j, h) in hj if Fraction(j, h) == br]
    stride = max(layer.stride) if layer.kind in ("conv", "dwconv") else 1
    p = surviving_phases(p_raw, stride)
    if prefer_large_h:
        j, h = max(candidates, key=lambda jh: (jh[1], jh[0]))
    else:
        j, h = min(candidates, key=lambda jh: (jh[1], -jh[0]))
    units = _units_per_phase(layer, h) * p
    return LayerImpl(
        layer=layer,
        j=j,
        h=h,
        p=p,
        p_raw=p_raw,
        configs=max(1, (h * d_in) // j),
        units=units,
        mults=units * _mults_per_unit(layer, j),
        scheme="ours",
        demand=r,
        capacity=Fraction(j, h) * p_raw,
    )


def select_ref11(layer: LayerSpec, r: Fraction) -> LayerImpl:
    """The prior work's direct derivation (Eqs. 1-3).

    Convolutional / depthwise: C = min(ceil(d_in / r), d_in * d_out),
    units = ceil(d_in * d_cm / C) KPUs of K^2 mults each.  Fully
    connected / pointwise: j fixed to the numerator of r, h the largest
    divisor of d_out not above its denominator.  [11] gets plain phase
    replication (no pruning) above one pixel per clock.
    """
    d_in, d_out = layer.d_in, layer.d_out
    p_raw = pixel_phases(r, d_in)
    r_phase = r / p_raw
    p = p_raw  # no stride-pruning insight in [11]

    if layer.kind in NON_ARITH_KINDS:
        return LayerImpl(
            layer=layer,
            j=min(d_in, max(1, r_phase.__ceil__())),
            h=1,
            p=p,
            p_raw=p_raw,
            configs=1,
            units=p,
            mults=0,
            scheme="ref11",
            demand=r,
            capacity=Fraction(d_in * p_raw),
        )

    if layer.kind in ("conv", "dwconv"):
        c = min(math.ceil(d_in / r_phase), d_in * d_out)
        cm = layer.channel_multiplier if layer.kind == "dwconv" else d_out
        pairs = d_in * cm
        units_per_phase = math.ceil(pairs / c)
        units = units_per_phase * p
        covered = units_per_phase * c
        pad = Fraction(covered - pairs, covered) if covered > pairs else Fraction(0)
        # Effective (j,h) bookkeeping for reporting only.
        j = min(d_in, units_per_phase)
        h = max(1, cm // max(1, units_per_phase // max(1, min(d_in, units_per_phase))))
        return LayerImpl(
            layer=layer,
            j=j,
            h=min(h, cm),
            p=p,
            p_raw=p_raw,
            configs=c,
            units=units,
            mults=units * layer.k_taps,
            scheme="ref11",
            demand=r,
            capacity=Fraction(d_in, c) * p,
            pad_waste=pad,
        )

    j_max, h_max = r_phase.numerator, r_phase.denominator
    j = max(1, min(j_max, d_in))
    h_cands = [h for h in divisors(d_out) if h <= h_max]
    h = max(h_cands) if h_cands else 1
    pad = Fraction(0)
    if d_in % j:
        padded = math.ceil(d_in / j) * j
        pad = Fraction(padded - d_in, padded)
    units = (d_out // h) * p
    return LayerImpl(
        layer=layer,
        j=j,
        h=h,
        p=p,
        p_raw=p_raw,
        configs=max(1, math.ceil(h * d_in / j)),
        units=units,
        mults=units * j,
        scheme="ref11",
        demand=r,
        capacity=Fraction(j, h) * p,
        pad_waste=pad,
    )


def select_impl(
    layer: LayerSpec,
    r: Fraction,
    *,
    scheme: str = "ours",
    prefer_large_h: bool = True,
    objective: str = "max_h",
) -> LayerImpl:
    """Scheme dispatch shared by the DAG planner."""
    if scheme == "ours":
        return select_ours(layer, r, prefer_large_h=prefer_large_h, objective=objective)
    if scheme == "ref11":
        return select_ref11(layer, r)
    raise ValueError(f"unknown scheme {scheme!r}")
