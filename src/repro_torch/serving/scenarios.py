"""Traffic scenarios: deterministic arrival processes on the rational clock
(the port's own copy of the JAX package's ``serving/scenarios.py``; the
same seeds give the same tick lists).

``CNNStreamEngine.run(arrival_rate=...)`` models one traffic shape — a
constant rate.  Production traffic does not respect BestRate: it bursts,
drifts through the day, and (adversarially) hovers just above the
sustainable rate where every queueing model is weakest.  This module
generates those shapes as *seeded, deterministic* arrival processes on
the exact rational clock the engine already runs on: an
``ArrivalProcess`` maps a frame count ``n`` to ``n`` nondecreasing
submit times in **ticks** (exact ``fractions.Fraction``s — one tick is
one frame interval at the plan's input rate), so every benchmark row
driven by a scenario is bit-reproducible and pinnable in CI.

Four families:

* ``constant(rate)`` — arrival ``i`` at ``i / rate`` ticks; exactly the
  legacy ``run(arrival_rate=rate)`` timing (the equivalence is tested).
* ``bursty(on_rate, burst, gap)`` — on/off traffic: bursts of frames at
  ``on_rate`` separated by idle gaps.  ``burst_jitter`` / ``gap_jitter``
  vary the burst lengths and gaps via a seeded 64-bit LCG — still exact
  integers/rationals, still deterministic per seed.
* ``diurnal(phases)`` — piecewise-constant rates cycling through
  ``(rate, duration_ticks)`` phases.  Arrival ``k`` lands where the
  integrated rate reaches ``k`` (exact inhomogeneous-process inversion,
  no sampling), so a zero-rate night phase is simply skipped over.
* ``adversarial(best_rate)`` — arrivals timed just above BestRate
  (default 17/16 of it): the admission gate is perpetually one frame
  behind, the worst case for any policy that waits for slack.

Randomness never touches ``random``/``numpy``: the only entropy is the
LCG seed carried in the frozen dataclass, so equal processes compare
equal and reproduce exactly across platforms.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Tuple


class ScenarioError(ValueError):
    """Misconfigured arrival process."""


_LCG_MULT = 6364136223846793005
_LCG_INC = 1442695040888963407
_MASK64 = (1 << 64) - 1


def _lcg(seed: int):
    """64-bit LCG (Knuth MMIX constants); yields 31-bit uniforms."""
    x = (seed ^ 0x9E3779B97F4A7C15) & _MASK64
    while True:
        x = (_LCG_MULT * x + _LCG_INC) & _MASK64
        yield x >> 33


def _jittered(base: int, jitter: int, u: int) -> int:
    """``base`` +/- up to ``jitter`` (uniform over 2*jitter+1 values)."""
    if jitter <= 0:
        return base
    return base + (u % (2 * jitter + 1)) - jitter


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base: a named, deterministic map ``n -> n submit times (ticks)``."""

    name: str = dataclasses.field(default="arrivals", init=False)

    def times(self, n: int) -> List[Fraction]:
        raise NotImplementedError

    def mean_rate(self, n: int) -> Fraction:
        """Offered rate over the first ``n`` arrivals (frames/tick):
        ``(n - 1) / span`` — for a constant process this is its rate."""
        if n < 1:
            raise ScenarioError(f"need n >= 1 arrivals, got {n}")
        ts = self.times(n)
        span = ts[-1] - ts[0]
        return Fraction(n - 1) / span if span > 0 else Fraction(n)


@dataclasses.dataclass(frozen=True)
class Constant(ArrivalProcess):
    """One frame every ``1 / rate`` ticks, first at t = 0 — identical
    timing to the legacy ``run(arrival_rate=rate)`` path."""

    rate: Fraction = Fraction(1)
    name: str = "constant"

    def __post_init__(self):
        if self.rate <= 0:
            raise ScenarioError(f"rate must be > 0, got {self.rate}")

    def times(self, n: int) -> List[Fraction]:
        inter = Fraction(1) / Fraction(self.rate)
        return [i * inter for i in range(n)]


@dataclasses.dataclass(frozen=True)
class Bursty(ArrivalProcess):
    """On/off traffic: bursts of ``burst`` frames at ``on_rate``
    (frames/tick) separated by ``gap`` idle ticks, with seeded integer
    jitter on both knobs (each burst/gap drawn independently)."""

    on_rate: Fraction = Fraction(2)
    burst: int = 8
    gap: int = 8
    burst_jitter: int = 0
    gap_jitter: int = 0
    seed: int = 0
    name: str = "bursty"

    def __post_init__(self):
        if self.on_rate <= 0:
            raise ScenarioError(f"on_rate must be > 0, got {self.on_rate}")
        if self.burst < 1:
            raise ScenarioError(f"burst must be >= 1, got {self.burst}")
        if self.gap < 0 or self.gap_jitter > self.gap:
            raise ScenarioError(
                f"gap must be >= gap_jitter >= 0, got gap={self.gap} "
                f"jitter={self.gap_jitter}"
            )
        if self.burst_jitter >= self.burst:
            raise ScenarioError(
                f"burst_jitter must leave bursts >= 1 frame, got "
                f"burst={self.burst} jitter={self.burst_jitter}"
            )

    def times(self, n: int) -> List[Fraction]:
        rng = _lcg(self.seed)
        inter = Fraction(1) / Fraction(self.on_rate)
        out: List[Fraction] = []
        t = Fraction(0)
        while len(out) < n:
            b = _jittered(self.burst, self.burst_jitter, next(rng))
            g = _jittered(self.gap, self.gap_jitter, next(rng))
            for k in range(b):
                if len(out) == n:
                    break
                out.append(t + k * inter)
            t += b * inter + g
        return out


@dataclasses.dataclass(frozen=True)
class Diurnal(ArrivalProcess):
    """Piecewise-constant rates cycling through ``(rate, ticks)`` phases.

    Arrival ``k`` is placed exactly where the integrated rate reaches
    ``k`` (the inverse of the cumulative rate function), so the process
    is the exact fluid limit of the phase schedule — no sampling noise,
    zero-rate phases are legal and simply idle."""

    phases: Tuple[Tuple[Fraction, Fraction], ...] = (
        (Fraction(1, 2), Fraction(8)),
        (Fraction(2), Fraction(4)),
    )
    name: str = "diurnal"

    def __post_init__(self):
        if not self.phases:
            raise ScenarioError("need at least one (rate, ticks) phase")
        for rate, dur in self.phases:
            if rate < 0 or dur <= 0:
                raise ScenarioError(
                    f"phase rates must be >= 0 with ticks > 0, got "
                    f"({rate}, {dur})"
                )
        if all(rate == 0 for rate, _ in self.phases):
            raise ScenarioError("all-zero rates never produce an arrival")

    def times(self, n: int) -> List[Fraction]:
        out: List[Fraction] = []
        pi = 0
        rate, dur = self.phases[0]
        t = Fraction(0)  # clock, in ticks
        end = Fraction(dur)  # current phase end
        remaining = Fraction(0)  # rate-integral until the next arrival
        while len(out) < n:
            cap = (end - t) * rate
            if rate > 0 and cap >= remaining:
                t += remaining / rate
                out.append(t)
                remaining = Fraction(1)
            else:
                remaining -= cap
                t = end
                pi = (pi + 1) % len(self.phases)
                rate, dur = self.phases[pi]
                end = t + Fraction(dur)
        return out


def constant(rate) -> Constant:
    """Constant arrivals at ``rate`` frames/tick."""
    return Constant(rate=Fraction(rate))


def bursty(
    on_rate,
    *,
    burst: int = 8,
    gap: int = 8,
    burst_jitter: int = 0,
    gap_jitter: int = 0,
    seed: int = 0,
) -> Bursty:
    """On/off bursts of ``burst`` frames at ``on_rate``, ``gap`` ticks
    apart, with seeded integer jitter on both."""
    return Bursty(
        on_rate=Fraction(on_rate),
        burst=burst,
        gap=gap,
        burst_jitter=burst_jitter,
        gap_jitter=gap_jitter,
        seed=seed,
    )


def diurnal(phases) -> Diurnal:
    """Piecewise-rate arrivals cycling through ``(rate, ticks)`` phases."""
    return Diurnal(
        phases=tuple((Fraction(r), Fraction(d)) for r, d in phases)
    )


def adversarial(best_rate, *, margin=Fraction(17, 16)) -> Constant:
    """Arrivals timed just above BestRate: constant at
    ``best_rate * margin`` (default 17/16) — the admission gate never
    quite catches up, the worst case for slack-waiting policies."""
    br = Fraction(best_rate)
    m = Fraction(margin)
    if br <= 0:
        raise ScenarioError(f"best_rate must be > 0, got {br}")
    if m <= 1:
        raise ScenarioError(f"margin must be > 1 (just *above*), got {m}")
    return Constant(rate=br * m, name="adversarial")
