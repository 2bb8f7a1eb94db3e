"""Blockwise causal attention — the LM path's prefill kernel.

Replaces the Pallas TPU kernel ``kernels/attention/flash_attention.py::
flash_attention_p`` (body ``_flash_kernel``; adapters
``kernels/attention/ops.py``) with the CUDA kernel
``csrc/flash_attention.cu``: one block per (head, query tile) walks the
key/value tiles through shared memory with the online-softmax state
(m, l, acc) in f32 registers.  At prefill lengths it is bound by
operations (989 TFLOP/s on bf16 tensor cores); this first design runs on
the CUDA cores in f32, and wgmma on TMA-staged tiles is left for a later
change.  The kernel also takes grouped KV heads (``group`` query heads
per KV head) and lengths that no block divides.

``flash_attention_plain`` is the same function in plain PyTorch (KV
repeated per group, f32 scores and softmax); the wrapper runs it only for
a tensor on the CPU.  For a CUDA tensor it launches the kernel or raises.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.hw import H100_SXM
from repro_torch.core.tiles import TileChoice
from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations
BLOCKS = (16, 32, 64)           # block_q / block_k: a 16 x 16 thread grid, <= 4 x 4 each
_NEG = -1e30
_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """``softmax(q kᵀ/√d, causal mask) v`` for q ``[B, H, Sq, d]`` and k, v
    ``[B, H/group, Sk, d]`` (query head h reads KV head h // group), with
    f32 scores and the output in q's dtype."""
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1).float()
    v = v.repeat_interleave(group, dim=1).float()
    s = torch.matmul(q.float(), k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None]
        ki = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, _NEG)
    return torch.matmul(torch.softmax(s, dim=-1), v).to(q.dtype)


def flash_blocks(bh: int, sq: int) -> Tuple[int, int]:
    """The card's (block_q, block_k) for ``bh`` heads of ``sq`` queries:
    the widest key tile, and the widest query tile that still launches a
    block for every SM (tall tiles reuse each staged key tile more).  Any
    pair from ``BLOCKS`` stages at most half of the shared memory a block
    may use, even at d = 128."""
    for block_q in reversed(BLOCKS):
        if bh * -(-sq // block_q) >= H100_SXM.sms:
            break
    return block_q, BLOCKS[-1]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int, block_k: int) -> torch.Tensor:
    """Attention of q ``[B, H, Sq, d]`` over k, v ``[B, Hkv, Sk, d]``
    (``H % Hkv == 0``) with (block_q, block_k) tiles, f32 or bf16."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or h % hkv or sq < 1 or sk < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k/v "
                         f"{tuple(k.shape)}: need one batch and head dim, "
                         "KV heads dividing the query heads, non-empty lengths")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if block_q not in BLOCKS or block_k not in BLOCKS:
        raise ValueError(f"flash_attention: blocks (block_q={block_q}, "
                         f"block_k={block_k}) must be in {BLOCKS}")
    _build.check_operands("flash_attention", q, k, v,
                          dtypes=(torch.float32, torch.bfloat16))
    if not _build.on_card(q):
        return flash_attention_plain(q, k, v, causal=causal)
    lib = _build.library()
    o = torch.empty_like(q)
    err = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, h // hkv,
        sq, sk, d, block_q, block_k, int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def attention_impl(
    *,
    causal: bool = True,
    tile: Optional[TileChoice] = None,
    record: Optional[Callable[..., None]] = None,
):
    """Adapter with the CNN kernels' tile/record protocol (the JAX
    package's ``kernels/attention/ops.py::attention_impl``): ``tile``
    maps bm -> block_q and bk -> block_k, else ``flash_blocks`` picks them
    from the shapes; ``record(block_q=, block_k=, seq=)`` reports the
    executed blocking.  ``impl(q, k, v)`` takes ``[B, H, S, d]`` and
    ``[B, Hkv, S, d]``."""

    def impl(q, k, v):
        if tile is not None:
            block_q, block_k = tile.bm, tile.bk
        else:
            block_q, block_k = flash_blocks(q.shape[0] * q.shape[1], q.shape[2])
        y = flash_attention(q, k, v, causal=causal, block_q=block_q,
                            block_k=block_k)
        if record is not None:
            record(block_q=block_q, block_k=block_k, seq=q.shape[2])
        return y

    return impl
