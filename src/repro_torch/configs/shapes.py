"""The four assigned input-shape suites (LM-family, per task spec); the
port's copy of the JAX package's ``configs/shapes.py``.

  train_4k     seq_len=4,096   global_batch=256   (training)
  prefill_32k  seq_len=32,768  global_batch=32    (inference prefill)
  decode_32k   seq_len=32,768  global_batch=128   (decode: 1 new token
                                                   against a 32k KV cache)
  long_500k    seq_len=524,288 global_batch=1     (long-context decode —
                                                   sub-quadratic archs only)

decode_* / long_* trace the decode step, not the train step
(``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: Dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSuite("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSuite("long_500k", 524288, 1, "decode"),
}


def cell_enabled(cfg: ModelConfig, shape: ShapeSuite) -> bool:
    """long_500k needs sub-quadratic attention (DESIGN.md §Shape-cell
    skips); every other cell runs for every arch (all 10 are
    decoder-capable)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def skip_reason(cfg: ModelConfig, shape: ShapeSuite) -> str:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full quadratic attention at 512k context — skipped per "
                "task spec; see DESIGN.md §Shape-cell skips")
    return ""
