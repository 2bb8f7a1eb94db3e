"""Data pipeline: deterministic, shardable, resumable token streams; the
port's copy of the JAX package's ``data/pipeline.py`` (numpy only).

Production posture without external deps:
  * ``SyntheticLM`` — seeded zipfian token stream (CPU-cheap, arbitrary
    vocab) used by examples, smoke tests and the dry-run;
  * ``PackedFileDataset`` — memory-mapped uint16/uint32 token files packed
    into fixed-length rows (the standard pre-tokenized LM format);
  * both expose ``state_dict() / load_state_dict()`` so the checkpointer
    restores the exact stream position on restart (fault tolerance), and
    take (shard_id, num_shards) so every data-parallel host reads a
    disjoint slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int                      # per-host batch
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    _step: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        key = f"{self.seed}:{self.shard_id}:{self.num_shards}:{step}"
        h = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little")
        return np.random.default_rng(h)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = self._rng(self._step)
        self._step += 1
        # zipf-ish distribution clipped to vocab (heavier head = learnable)
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        toks = (z % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state_dict(self) -> dict:
        return {"step": self._step, "seed": self.seed,
                "shard_id": self.shard_id, "num_shards": self.num_shards}

    def load_state_dict(self, st: dict) -> None:
        _check_stream(self, st)
        self._step = st["step"]


@dataclasses.dataclass
class PackedFileDataset:
    """Pre-tokenized flat binary file -> packed LM rows.

    File layout: a flat array of token ids (uint16 if vocab < 65536 else
    uint32).  Rows are drawn at stride seq_len+1 with a deterministic
    shuffle of row order per epoch; shards partition rows round-robin.
    """
    path: str
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    _step: int = 0

    def __post_init__(self):
        dtype = np.uint16 if self.vocab < 2 ** 16 else np.uint32
        self._data = np.memmap(self.path, dtype=dtype, mode="r")
        self._row = self.seq_len + 1
        self._rows = len(self._data) // self._row
        if self._rows < self.batch:
            raise ValueError(f"{self.path}: only {self._rows} rows")

    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch * 1_000_003)
        return rng.permutation(self._rows)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rows_per_step = self.batch * self.num_shards
        steps_per_epoch = max(1, self._rows // rows_per_step)
        epoch, within = divmod(self._step, steps_per_epoch)
        order = self._order(epoch)
        base = within * rows_per_step + self.shard_id * self.batch
        idx = order[base:base + self.batch]
        rows = np.stack([
            self._data[i * self._row:(i + 1) * self._row] for i in idx
        ]).astype(np.int32)
        self._step += 1
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def state_dict(self) -> dict:
        return {"step": self._step, "seed": self.seed,
                "shard_id": self.shard_id, "num_shards": self.num_shards}

    def load_state_dict(self, st: dict) -> None:
        _check_stream(self, st)
        self._step = st["step"]


def _check_stream(stream, st: dict) -> None:
    """A saved position belongs to a stream of the same seed and sharding."""
    if st["seed"] != stream.seed or st["num_shards"] != stream.num_shards:
        raise ValueError(f"stream state {st} is not of a stream with seed "
                         f"{stream.seed} over {stream.num_shards} shards")


def write_packed_file(path: str, tokens: np.ndarray, vocab: int) -> None:
    dtype = np.uint16 if vocab < 2 ** 16 else np.uint32
    np.asarray(tokens, dtype).tofile(path)
