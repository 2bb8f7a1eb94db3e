"""Paged KV cache — block-table memory management for serving; the port's
copy of the JAX package's ``serving/kv_cache.py``.

vLLM-style paging adapted to the continuous-flow calculus: the block
pool is the capacity (Eq. 9 analogue — admission only when blocks are
free), sequences own chains of fixed-size blocks, and fragmentation is
bounded by one partial block per sequence.  The allocator is pure
bookkeeping on the host; ``gather_kv`` materializes a sequence's KV for
attention by indexing the pool with its block table — the indirection a
paged-attention kernel would consume directly.  The pool lives on an
explicit device (the card unless the caller asks for the CPU); token
writes go into it in place, where the JAX package returns new arrays.

As in the JAX package, the token engine (``serving/engine.py``) does not
use it: the engine's caches are the models' own stacked or per-layer
tensors.

``capacity_for(rate, latency)`` sizes the pool so that the expected
in-flight KV demand (token rate × residency) is covered — the paper's
service-rate sizing applied to memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.registry import resolve_device


@dataclasses.dataclass
class PagedKVConfig:
    n_blocks: int
    block_size: int  # tokens per block
    n_layers: int
    n_kv: int
    head_dim: int
    dtype: str = "bfloat16"


class PagedKVCache:
    """Block pool + per-sequence block tables.

    Physical storage: [n_blocks, n_layers, block_size, n_kv, head_dim]
    for K and V (block-major so a block is contiguous), on ``device``.
    """

    def __init__(self, cfg: PagedKVConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        shape = (cfg.n_blocks, cfg.n_layers, cfg.block_size, cfg.n_kv, cfg.head_dim)
        dtype = getattr(torch, cfg.dtype)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(cfg.n_blocks))
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}

    # ------------------------------------------------------------------
    # allocator
    # ------------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_needed(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.cfg.block_size)

    def can_admit(self, n_tokens: int) -> bool:
        """Eq. (9) analogue: admission requires capacity."""
        return self.blocks_needed(n_tokens) <= self.free_blocks

    def allocate(self, seq_id: int, n_tokens: int) -> List[int]:
        need = self.blocks_needed(n_tokens)
        if need > self.free_blocks:
            raise MemoryError(
                f"seq {seq_id}: need {need} blocks, {self.free_blocks} free"
            )
        blocks = [self._free.pop() for _ in range(need)]
        self._tables[seq_id] = blocks
        self._lengths[seq_id] = n_tokens
        return blocks

    def extend(self, seq_id: int, n_new: int = 1) -> Optional[int]:
        """Grow a sequence; returns a newly-allocated block id or None."""
        length = self._lengths[seq_id] + n_new
        need = self.blocks_needed(length)
        have = len(self._tables[seq_id])
        new_block = None
        if need > have:
            if not self._free:
                raise MemoryError(f"seq {seq_id}: pool exhausted")
            new_block = self._free.pop()
            self._tables[seq_id].append(new_block)
        self._lengths[seq_id] = length
        return new_block

    def free(self, seq_id: int) -> None:
        self._free.extend(self._tables.pop(seq_id))
        self._lengths.pop(seq_id)

    def table(self, seq_id: int) -> List[int]:
        return list(self._tables[seq_id])

    def length(self, seq_id: int) -> int:
        return self._lengths[seq_id]

    def fragmentation(self) -> float:
        """Wasted slots / allocated slots (bounded by 1 partial blk/seq)."""
        alloc = sum(len(t) for t in self._tables.values()) * self.cfg.block_size
        used = sum(self._lengths.values())
        return 0.0 if alloc == 0 else (alloc - used) / alloc

    # ------------------------------------------------------------------
    # data plane
    # ------------------------------------------------------------------
    def write_token(self, seq_id: int, layer_kv: Tuple[torch.Tensor, torch.Tensor],
                    pos: int) -> None:
        """Write one token's K/V ([n_layers, n_kv, head_dim]) at ``pos``, in
        place, cast to the pool's dtype."""
        blk = self._tables[seq_id][pos // self.cfg.block_size]
        off = pos % self.cfg.block_size
        k_tok, v_tok = layer_kv
        self.k[blk, :, off] = torch.as_tensor(k_tok).to(self.device, self.k.dtype)
        self.v[blk, :, off] = torch.as_tensor(v_tok).to(self.device, self.v.dtype)

    def gather_kv(self, seq_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Materialize [n_layers, length, n_kv, head_dim] for attention —
        the gather a paged-attention kernel performs via block tables."""
        tbl = torch.as_tensor(self._tables[seq_id], dtype=torch.long, device=self.device)
        length = self._lengths[seq_id]
        shape = (self.cfg.n_layers, -1, self.cfg.n_kv, self.cfg.head_dim)
        k = self.k[tbl].movedim(1, 0).reshape(shape)   # [n_blk, L, bs, ..] -> [L, n_blk*bs, ..]
        v = self.v[tbl].movedim(1, 0).reshape(shape)
        return k[:, :length], v[:, :length]


def capacity_for(
    token_rate: float,
    residency_s: float,
    block_size: int,
    safety: float = 1.25,
) -> int:
    """Pool sizing from the rate calculus: expected in-flight tokens =
    arrival rate x residency; capacity >= demand x safety (Eq. 9)."""
    tokens = token_rate * residency_s * safety
    return max(1, math.ceil(tokens / block_size))
