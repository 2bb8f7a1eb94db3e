"""Multi-pixel phase analysis (paper §II-E, Figs. 4-6).

The port's own copy of the JAX package's ``core/multipixel.py``.

When P pixels arrive per clock (raster order), pixel n is transmitted on
input wire  m = n mod P  at time  t = n // P.  A sliding window of width K
starting at column n is computed by the KPU *phase*  phi = n mod P; the
phase's tap for offset k reads wire (n+k) mod P delayed so that all taps
align with the arrival of the window's last pixel (Fig. 5/6):

    delay(k) = (n + K - 1)//P - (n + k)//P        (cycles)
    wire(k)  = (n + k) mod P

Both quantities depend on n only through n mod P, so one (delay, wire)
table per phase suffices — this is exactly the paper's "another KPU with a
different delay and connectivity pattern".

Stride pruning: valid window starts satisfy n ≡ 0 (mod s); phase phi gets
such a window iff gcd(P, s) | phi, so P/gcd(P,s) phases survive; for the
survivors, only every (lcm(P,s)/P)-th assigned window is valid — the
validity pattern is periodic and derivable from a position counter, as the
paper notes.

The same analysis drives the KPU kernel: ``kpu_conv`` computes only the
windows of surviving phases (strided output pixels), the GPU form of
"deleting the pruned KPUs".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class TapRoute:
    tap: int      # kernel offset k in [0, K)
    wire: int     # input wire index in [0, P)
    delay: int    # cycles of delay


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    phase: int                    # phi in [0, P)
    taps: Tuple[TapRoute, ...]    # one route per kernel tap (1-D view)
    valid_period: int             # among assigned windows, 1 of valid_period is valid
    valid_offset: int             # index (in assigned-window order) of first valid
    alive: bool                   # False => pruned (stride skips all its windows)


def phase_tap_routes(p: int, k: int, phase: int) -> Tuple[TapRoute, ...]:
    """(wire, delay) for each tap of the KPU serving ``phase`` (Fig. 5/6)."""
    n = phase  # any representative window start with n ≡ phase (mod P)
    last = (n + k - 1) // p
    return tuple(
        TapRoute(tap=t, wire=(n + t) % p, delay=last - (n + t) // p)
        for t in range(k)
    )


def plan_phases(p: int, k: int, stride: int) -> List[PhasePlan]:
    """Full §II-E analysis for a 1-D window of width k, P pixels/clock."""
    g = math.gcd(p, stride)
    lcm = p * stride // g
    plans = []
    for phi in range(p):
        alive = phi % g == 0
        if alive:
            # assigned windows: n = phi, phi+P, phi+2P, ...; valid: n ≡ 0 (mod s)
            # n = phi + i*P ≡ 0 (mod s)  has solutions i with period lcm/P.
            period = lcm // p
            offset = 0
            for i in range(period):
                if (phi + i * p) % stride == 0:
                    offset = i
                    break
        else:
            period, offset = 0, 0
        plans.append(
            PhasePlan(
                phase=phi,
                taps=phase_tap_routes(p, k, phi),
                valid_period=period,
                valid_offset=offset,
                alive=alive,
            )
        )
    return plans


def window_assignment(p: int, k: int, stride: int, n_positions: int
                      ) -> Dict[int, int]:
    """Map every *valid* window start (stride multiples) to its phase.

    Used by property tests: every valid window is covered exactly once,
    and only by phases that `plan_phases` marks alive.
    """
    out: Dict[int, int] = {}
    for n in range(0, n_positions, stride):
        out[n] = n % p
    return out


def pad_select(n: int, k: int, width: int, pad_left: int) -> Tuple[bool, ...]:
    """Which taps of window starting at (unpadded) position n-pad_left read
    out-of-bounds pixels and must be zeroed (the KPU's pad_i signals)."""
    return tuple(not (0 <= n - pad_left + t < width) for t in range(k))
