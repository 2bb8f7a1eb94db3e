"""Token embeddings and rotary position embeddings; the port's copy of the
JAX package's ``nn/embeddings.py``."""
from __future__ import annotations

import math
from typing import Optional

import torch

# Rows of the table one fallback product turns into f32 at a time.
_VOCAB_CHUNK = 8192


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(0.02).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Softmax projection ``[..., d] @ [vocab, d]ᵀ`` with f32 logits.

    The operands stay in their storage dtype and the product accumulates
    and returns f32, as ``preferred_element_type`` does in the JAX
    package: no f32 copy of the whole table per call.  On the card that
    is ``torch.mm(..., out_dtype=torch.float32)``, which a PyTorch without
    it refuses; on the CPU the table is turned into f32 ``_VOCAB_CHUNK``
    rows at a time (``unembed_chunked``).
    """
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    if x2.dtype == table.dtype == torch.float32:
        y = x2 @ table.t()
    elif x2.is_cuda:
        y = torch.mm(x2, table.t(), out_dtype=torch.float32)
    else:
        y = unembed_chunked(table, x2)
    return y.reshape(*lead, table.shape[0])


def unembed_chunked(table: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``x2 [m, d] @ table.T`` in f32 on the CPU, converting the table by
    chunks."""
    xf = x2.float()
    y = torch.empty((x2.shape[0], table.shape[0]), dtype=torch.float32,
                    device=x2.device)
    for v0 in range(0, table.shape[0], _VOCAB_CHUNK):
        y[:, v0:v0 + _VOCAB_CHUNK] = xf @ table[v0:v0 + _VOCAB_CHUNK].float().t()
    return y


def rope(
    x: torch.Tensor,              # [..., S, H, Dh] or [..., S, Dh]
    positions: torch.Tensor,      # [..., S] int
    *,
    theta: float = 10000.0,
    rotary_dim: Optional[int] = None,
) -> torch.Tensor:
    """Rotary embeddings, split-half convention (llama-style)."""
    dh = x.shape[-1]
    rd = rotary_dim or dh
    half = rd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device)
                      / half)
    ang = positions.float()[..., None] * freqs                # [..., S, half]
    if x.dim() == ang.dim() + 1:                              # heads axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:rd]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rd < dh:
        rot = torch.cat([rot, x[..., rd:]], dim=-1)
    return rot.to(x.dtype)
