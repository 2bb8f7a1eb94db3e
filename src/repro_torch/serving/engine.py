"""Batched serving engine: continuous batching over a slotted KV cache or
SSM state; the port's copy of the JAX package's ``serving/engine.py``.

Same admission (a request enters only when a slot is free: Eq. 9's
capacity check), same greedy sampling, per-slot positions and retirement
rule, and one batched decode for the whole pool (idle slots are masked by
their own cache length).  Each admitted request is prefilled alone into a
one-row state, which is then written into its slot of the pool.  There is
no ``jit``: PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import get_api


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None


def _write_slot(pool, one, slot: int, bdim: int = 1) -> None:
    """Write a one-row serve state into row ``slot`` of the pool, tensor by
    tensor through any nesting of lists, tuples and dicts (the JAX engine's
    tree map), cast to the pool's dtype: stacked caches and states carry
    the batch at dim 1, a per-layer list of caches (windowed models) at
    dim 0; leaves of fewer than 2 dims carry no batch and stay as they
    are."""
    if isinstance(pool, dict):
        for key in pool:
            _write_slot(pool[key], one[key], slot, bdim)
    elif isinstance(pool, (list, tuple)):
        for p, o in zip(pool, one):
            _write_slot(p, o, slot, 0 if isinstance(pool, list) else bdim)
    elif pool.dim() >= 2:
        pool.select(bdim, slot).copy_(one.select(bdim, 0))


class Engine:
    """``Engine(cfg, params, slots=, max_len=, eos=, device=)``: ``params``
    live on ``device`` (the card unless the caller asks for the CPU).  With
    a KV cache (families lm and hybrid), a prompt that does not fit
    ``max_len`` raises ``ValueError`` at its prefill (the JAX engine's
    cache write would clamp instead)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        slots: int = 4,
        max_len: int = 256,
        eos: Optional[int] = None,
        device=None,
    ):
        family = getattr(cfg, "family", None)
        if family not in ("lm", "ssm", "hybrid"):
            # CNN configs carry no .family at all: they are LayerGraph
            # descriptions, not ModelConfigs
            is_cnn = (family or "").startswith(("mobilenet", "resnet")) or (
                family is None and hasattr(cfg, "graph")
            )
            if is_cnn:
                raise ValueError(
                    f"Engine serves token streams; CNN config "
                    f"{type(cfg).__name__} streams frames through "
                    "serving.cnn_stream.CNNStreamEngine (front door: "
                    "registry.CNNApi.serve)"
                )
            raise ValueError(
                f"Engine supports text-in/text-out families; {family} "
                "(encdec/vlm) needs a modality-aware front end"
            )
        self.cfg = cfg
        self.params = params
        self.api = get_api(cfg, device)
        self.slots = slots
        self.max_len = max_len
        self.eos = eos
        self.active: Dict[int, Request] = {}  # slot -> request
        self.queue: List[Request] = []
        self.pos = np.zeros(slots, np.int32)
        self.state = self.api.make_serve_state(cfg, slots, max_len)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.slots) if i not in self.active]

    def _admit(self) -> None:
        """Admission = capacity check (Eq. 9 analogue)."""
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            toks = np.asarray(req.prompt, np.int32)[None]
            state1 = self.api.make_serve_state(self.cfg, 1, self.max_len)
            logits, state1 = self.api.prefill(self.params, {"tokens": toks},
                                              state1, self.cfg)
            tok = int(torch.argmax(logits[0, -1]))
            req.out.append(tok)
            req.t_first = time.perf_counter()
            _write_slot(self.state, state1, slot)
            self.pos[slot] = len(req.prompt)
            self.active[slot] = req

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine tick: admit, batched decode, retire.  Returns the
        number of tokens produced."""
        self._admit()
        if not self.active:
            return 0
        toks = np.zeros((self.slots, 1), np.int32)
        for slot, req in self.active.items():
            toks[slot, 0] = req.out[-1] if req.out else 0
        # per-slot positions: attention writes each row at its own offset
        # and masks each row's own kv_len, so slots decode in one batch
        logits, self.state = self.api.decode(
            self.params, self.state, {"tokens": toks}, self.pos.copy(), self.cfg
        )
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        made = 0
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.out.append(tok)
            made += 1
            self.pos[slot] += 1
            if (
                (self.eos is not None and tok == self.eos)
                or len(req.out) >= req.max_new
                or self.pos[slot] >= self.max_len - 1
            ):
                req.done = True
                req.t_done = time.perf_counter()
                del self.active[slot]
        return made

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and not self.active:
                return
            self.step()
        raise RuntimeError("engine did not drain")
