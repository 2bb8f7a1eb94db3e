"""Fault tolerance on one process: the straggler watchdog and the
heartbeat; the port's copy of the single-process part of the JAX
package's ``distributed/fault_tolerance.py``.  The train loop
(``launch/train.py``) consumes both.

* ``StragglerWatchdog`` — EWMA of step wall-time; steps slower than
  ``threshold x`` EWMA are flagged.  ``patience`` consecutive flags
  trigger mitigation.
* ``Heartbeat`` — per-step liveness file; a restarted job detects a stale
  heartbeat + incomplete step and resumes from the last checkpoint.

``viable_mesh_shape`` and ``ElasticMesh`` (re-meshing the survivors and
re-sharding a checkpoint onto them) come with the port's mesh.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import List, Optional


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 1.8  # x EWMA counts as straggling
    patience: int = 3  # consecutive slow steps before action
    alpha: float = 0.1  # EWMA factor
    _ewma: Optional[float] = None
    _slow_streak: int = 0
    flagged_steps: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Feed a step time; returns True when mitigation should fire."""
        if self._ewma is None:
            self._ewma = seconds
            return False
        slow = seconds > self.threshold * self._ewma
        if slow:
            self._slow_streak += 1
            self.flagged_steps.append(step)
        else:
            self._slow_streak = 0
            # only fold healthy steps into the baseline
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * seconds
        return self._slow_streak >= self.patience

    def reset(self) -> None:
        self._slow_streak = 0


@dataclasses.dataclass
class Heartbeat:
    path: str
    stale_after: float = 300.0

    def beat(self, step: int) -> None:
        Path(self.path).write_text(json.dumps({"step": step, "t": time.time()}))

    def last(self) -> Optional[dict]:
        p = Path(self.path)
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def is_stale(self) -> bool:
        h = self.last()
        return h is not None and (time.time() - h["t"]) > self.stale_after
