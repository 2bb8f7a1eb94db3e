"""Fault tolerance: straggler watchdog, elastic re-mesh, heartbeat; the
port's copy of the JAX package's ``distributed/fault_tolerance.py``.  The
train loop (``launch/train.py``) consumes the watchdog and the heartbeat.

* ``StragglerWatchdog`` — EWMA of step wall-time; steps slower than
  ``threshold x`` EWMA are flagged.  ``patience`` consecutive flags
  trigger mitigation.
* ``ElasticMesh`` — given the surviving ranks, rebuilds the largest
  (data, model) ``DeviceMesh`` that keeps the model axis (the TP degree
  must survive; data parallelism absorbs the loss) and re-shards a
  gathered tree onto it — checkpoints are topology-agnostic
  (``checkpoint/checkpointer.py``).  Every rank of the world builds the
  mesh (its process groups are made collectively); the lost ranks are
  not in it.
* ``Heartbeat`` — per-step liveness file; a restarted job detects a stale
  heartbeat + incomplete step and resumes from the last checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import List, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.sharding import shard_tree


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


def viable_mesh_shape(n_devices: int, model_degree: int) -> Optional[tuple]:
    """Largest (data, model) grid on the survivors, keeping TP intact."""
    if n_devices < model_degree:
        return None
    data = n_devices // model_degree
    return (data, model_degree)


@dataclasses.dataclass
class ElasticMesh:
    """Rebuild a mesh after failures and re-shard state onto it."""

    model_degree: int

    def remesh(self, ranks: Sequence[int], *, device_type: Optional[str] = None
               ) -> DeviceMesh:
        """A ``("data", "model")`` mesh over the first ranks of ``ranks``
        (global ranks of the survivors) that fill ``viable_mesh_shape``;
        ``device_type`` defaults to ``"cuda"``."""
        shape = viable_mesh_shape(len(ranks), self.model_degree)
        if shape is None:
            raise RuntimeError(
                f"{len(ranks)} survivors cannot host model degree "
                f"{self.model_degree}"
            )
        grid = torch.tensor(list(ranks)[:shape[0] * shape[1]]).reshape(shape)
        return DeviceMesh(device_type or "cuda", grid, mesh_dim_names=("data", "model"))

    def reshard(self, tree, new_shardings):
        """Move (gathered) host arrays onto the new mesh's shardings."""
        return shard_tree(tree, new_shardings)


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
