"""Blockwise causal attention — the LM path's prefill kernel.

Replaces the Pallas TPU kernel ``kernels/attention/flash_attention.py::
flash_attention_p`` (body ``_flash_kernel``; adapters
``kernels/attention/ops.py``) with two CUDA kernels, one block per (head,
query tile) walking the key/value tiles with the online-softmax state
(m, l, acc) in f32 registers.  bf16, the served dtype, runs
``csrc/flash_attention_sm90.cu``: both products on wgmma over tiles that
TMA stages, P in two bf16 terms so that it keeps the reference's f32
precision.  f32 runs ``csrc/flash_attention.cu`` on the CUDA cores
(wgmma has no f32 operand).  At prefill lengths the function is bound by
operations (989 TFLOP/s on bf16 tensor cores).  Both kernels also take
grouped KV heads (``group`` query heads per KV head), lengths that no
block divides, and Sq != Sk without the causal mask (cross-attention, a
decode step's one query against T keys).  Head dims 16 to 256; at 256 a
pair of blocks must fit a block's shared memory (``smem_bytes``), which
leaves the bf16 kernel block_k 64 only.

``flash_attention_plain`` is the same function in plain PyTorch (KV
repeated per group, f32 scores and softmax); the wrapper runs it only for
a tensor on the CPU.  For a CUDA tensor it launches the kernel or raises.
``flash_attention.launches`` counts kernel launches.

A fake CUDA tensor (``FakeTensorMode``: the dry run's trace,
``launch.dryrun``) has no memory to launch on: the wrapper hands it to
the custom op ``torch.ops.repro_torch.flash_attention``, whose fake
implementation gives the output's shape and whose FLOP formula
(``torch.utils.flop_counter``) gives the kernel's own work, 4·B·H·Sq·Sk·d,
halved when causal.  A real tensor launches directly, as before: the op's
dispatch costs host time a call.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.hw import H100_SXM
from repro_torch.core.tiles import TileChoice
from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernels' instantiations
# block_q / block_k each kernel takes: f32, a 16 x 16 thread grid of <= 4 x 4
# tiles; bf16, one or two warpgroups of 64 query rows and wgmma's 64- or
# 128-key tiles.
BLOCKS = {torch.float32: (16, 32, 64), torch.bfloat16: (64, 128)}
DESIGN = {torch.float32: "cuda-core", torch.bfloat16: "wgmma"}
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


def smem_bytes(dtype: torch.dtype, d: int, block_q: int, block_k: int) -> int:
    """The dynamic shared memory a launch asks for (each ``.cu`` file's
    ``launch``): bf16, 1 KiB of alignment, the q tile and two k + v stages;
    f32, the skewed q, k, v and p tiles."""
    if dtype == torch.bfloat16:
        return 1024 + block_q * d * 2 + 2 * 2 * block_k * d * 2
    return 4 * ((block_q + block_k) * (d + 1) + block_k * d + block_q * (block_k + 1))


def fits(dtype: torch.dtype, d: int, block_q: int, block_k: int) -> bool:
    return smem_bytes(dtype, d, block_q, block_k) <= H100_SXM.smem_per_block


def flash_blocks(bh: int, sq: int, dtype: torch.dtype, d: int) -> Tuple[int, int]:
    """The card's (block_q, block_k) for ``bh`` heads of ``sq`` queries of
    head dim ``d`` in ``dtype``: the widest key tile that fits, and the
    widest query tile that fits beside it and still launches a block for
    every SM (tall tiles reuse each staged key tile more).  Every pair of
    ``BLOCKS[dtype]`` fits up to d = 128; at d = 256 bf16 takes block_k 64."""
    blocks = BLOCKS[dtype]
    block_k = max(b for b in blocks if fits(dtype, d, blocks[0], b))
    for block_q in reversed(blocks):
        if fits(dtype, d, block_q, block_k) and bh * -(-sq // block_q) >= H100_SXM.sms:
            break
    return block_q, block_k


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
    _build.check_operands("flash_attention", q, k, v,
                          dtypes=(torch.float32, torch.bfloat16))
    blocks = BLOCKS[q.dtype]
    if block_q not in blocks or block_k not in blocks:
        raise ValueError(f"flash_attention: blocks (block_q={block_q}, "
                         f"block_k={block_k}) must be in {blocks} for {q.dtype}")
    if not fits(q.dtype, d, block_q, block_k):
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_k}) at head "
                         f"dim {d} need {smem_bytes(q.dtype, d, block_q, block_k)} "
                         f"bytes of shared memory, over {H100_SXM.smem_per_block}")
    if not _build.on_card(q):
        return flash_attention_plain(q, k, v, causal=causal)
    if isinstance(q, FakeTensor):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, block_q, block_k)
    return _launch(q, k, v, causal, block_q, block_k)


flash_attention.launches = 0


def _launch(q, k, v, causal: bool, block_q: int, block_k: int) -> torch.Tensor:
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    err = getattr(_build.library(), _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, h // hkv,
        sq, sk, d, block_q, block_k, int(causal), 1.0 / math.sqrt(d),
        _build.raw_stream(q.device),
    )
    _build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    return o


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              block_q: int, block_k: int) -> torch.Tensor:
    """The kernel as an op, for traced calls (module note)."""
    return _launch(q, k, v, causal, block_q, block_k)


@_flash_op.register_fake
def _(q, k, v, causal, block_q, block_k):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None, **kwargs) -> int:
    b, h, sq, d = q_shape
    flops = 4 * b * h * sq * k_shape[2] * d
    return flops // 2 if causal else flops


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
    executed blocking.  ``impl(q, k, v, causal=causal)`` takes ``[B, H,
    Sq, d]`` and ``[B, Hkv, Sk, d]``; the call's ``causal`` overrides the
    adapter's."""

    def impl(q, k, v, causal=causal):
        if tile is not None:
            block_q, block_k = tile.bm, tile.bk
        else:
            block_q, block_k = flash_blocks(q.shape[0] * q.shape[1], q.shape[2],
                                            q.dtype, q.shape[3])
        y = flash_attention(q, k, v, causal=causal, block_q=block_q,
                            block_k=block_k)
        if record is not None:
            record(block_q=block_q, block_k=block_k, seq=q.shape[2])
        return y

    return impl
