"""Token embeddings and rotary position embeddings; the port's copy of the
JAX package's ``nn/embeddings.py``."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import replicate_dim

# Rows of the table one fallback product turns into f32 at a time.
_VOCAB_CHUNK = 8192


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(0.02).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(table, DTensor):
        return _embed_sharded(table, tokens)
    return table[tokens]


def _embed_sharded(table: DTensor, tokens) -> DTensor:
    """The vocab-parallel lookup (Megatron's): each rank reads the token
    ids that fall in its rows of a row-sharded table, zeros for the rest,
    and the output is a partial sum over the mesh dims that split the
    rows.  DTensor's own gather over a row-sharded table leaves a masked
    partial that its redistribute cannot reduce, and the backward's
    ``index_put`` builds an unnormalized ``Shard(-1)``; here the lookup
    and its backward are local."""
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim)
    pt = [p if p.is_shard(0) else Replicate() for p in table.placements]
    pk = [Replicate() if t.is_shard(0) or not k.is_shard() else k
          for t, k in zip(pt, tokens.placements)]
    rows, shard = table.shape[0], 0
    for i, p in enumerate(pt):
        if p.is_shard(0):
            rows //= mesh.shape[i]
            shard = shard * mesh.shape[i] + mesh.get_local_rank(i)
    grad = [Shard(0) if t.is_shard(0) else Partial() if k.is_shard() else Replicate()
            for t, k in zip(pt, pk)]
    tl = table.redistribute(mesh, pt).to_local(grad_placements=grad)
    ids = tokens.redistribute(mesh, pk).to_local() - shard * rows
    inside = (ids >= 0) & (ids < rows)
    out = tl[ids.clamp(0, rows - 1)] * inside[..., None].to(tl.dtype)
    return DTensor.from_local(out, mesh, [Partial() if t.is_shard(0) else k
                                          for t, k in zip(pt, pk)])


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Softmax projection ``[..., d] @ [vocab, d]ᵀ`` with f32 logits.

    The operands stay in their storage dtype and the product accumulates
    and returns f32, as ``preferred_element_type`` does in the JAX
    package: no f32 copy of the whole table per call.  On the card that
    is ``_WideLogits``: ``torch.mm(..., out_dtype=torch.float32)``, which
    a PyTorch without it refuses, given a backward; on the CPU the table
    is turned into f32 ``_VOCAB_CHUNK`` rows at a time
    (``unembed_chunked``).  On DTensors: a vocab-sharded table gives each
    rank its vocab slice of its rows, the sequence gathered whole first
    (``_wide_logits_sharded``); a table whose vocab no mesh dim splits
    (mamba2-780m's 50280 on a 'model' axis of 16) is gathered whole, and
    each rank multiplies its own rows, the sequence left sharded
    (``_logits_local_rows``): gathering the sequence there would give every
    'model' rank the same rows, and the head's FLOPs 16 times over.
    """
    if isinstance(x, DTensor) and x.dim() == 3:
        if not any(p.is_shard(0) for p in table.placements):
            return _logits_local_rows(table, x)
        x = replicate_dim(x, 1)                  # gather a sharded sequence first
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    if isinstance(x2, DTensor) and not x2.dtype == table.dtype == torch.float32:
        y = _wide_logits_sharded(x2, table)
    else:
        y = _logits(x2, table)
    return y.reshape(*lead, table.shape[0])


def _logits(x2: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """f32 ``x2 [m, d] @ table.T`` (``unembed``'s routes; DTensors only in
    f32)."""
    if x2.dtype == table.dtype == torch.float32:
        return x2 @ table.t()
    if x2.is_cuda:
        return _WideLogits.apply(x2, table)
    return unembed_chunked(table, x2)


def _logits_local_rows(table: DTensor, x: DTensor) -> DTensor:
    """``unembed`` of DTensor rows x [B, S, d] (batch and sequence sharded
    as they lie) by a table gathered whole: each rank's own rows, logits
    on x's row placements; the table's grad is a partial sum over the mesh
    dims that split the rows (``sharding.rows_matmul``'s scheme, with f32
    logits)."""
    mesh = x.device_mesh
    last = x.dim() - 1
    px = [Replicate() if p.is_partial() or p.is_shard(last) else p for p in x.placements]
    xl = x.redistribute(mesh, px).to_local()
    tl = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate() for p in px])
    y = _logits(xl.reshape(-1, xl.shape[-1]), tl)
    return DTensor.from_local(y.reshape(*xl.shape[:-1], -1), mesh, px)


class _WideLogits(torch.autograd.Function):
    """``x2 @ table.T`` with f32 logits on the card; ``torch.mm(...,
    out_dtype=)`` has no derivative, so this gives it one.  A call that
    autograd does not record (serving) keeps no graph and no operands.
    The backward keeps the f32 cotangent's precision on the tensor cores:
    it is split into two terms of the operands' dtype (hi + lo, 16 bits of
    mantissa), each product accumulating in f32, and the sum is rounded
    once to the operand's dtype, as the JAX package's transpose of an f32
    ``preferred_element_type`` product rounds an f32 result."""

    @staticmethod
    def forward(ctx, x2, table):
        ctx.save_for_backward(x2, table)
        return torch.mm(x2, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, table = ctx.saved_tensors
        hi = g.to(table.dtype)
        lo = (g - hi.float()).to(table.dtype)

        gx = gt = None
        if ctx.needs_input_grad[0]:
            gx = (torch.mm(hi, table, out_dtype=torch.float32)
                  + torch.mm(lo, table, out_dtype=torch.float32)).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            gt = (torch.mm(hi.t(), x2, out_dtype=torch.float32)
                  + torch.mm(lo.t(), x2, out_dtype=torch.float32)).to(table.dtype)
        return gx, gt


def _wide_logits_sharded(x2: DTensor, table: DTensor) -> DTensor:
    """``_WideLogits`` of DTensors: DTensor has no sharding rule for
    ``torch.mm(..., out_dtype=)``, so the product runs on each rank's
    shards.  Each mesh dim keeps x2's row sharding or else the table's
    vocab sharding (the rest is replicated first); the logits come out
    sharded on the same dims, and each operand's grad is a partial sum
    over the mesh dims that split the other's rows."""
    mesh = x2.device_mesh
    px, pt = [], []
    for a, b in zip(x2.placements, table.placements):
        a = a if a.is_shard(0) else Replicate()
        px.append(a)
        pt.append(b if b.is_shard(0) and not a.is_shard(0) else Replicate())
    out = [Shard(0) if a.is_shard(0) else Shard(1) if b.is_shard(0) else Replicate()
           for a, b in zip(px, pt)]
    gx = [a if a.is_shard(0) else Partial() if b.is_shard(0) else Replicate()
          for a, b in zip(px, pt)]
    gt = [b if b.is_shard(0) else Partial() if a.is_shard(0) else Replicate()
          for a, b in zip(px, pt)]
    xl = x2.redistribute(mesh, px).to_local(grad_placements=gx)
    tl = table.redistribute(mesh, pt).to_local(grad_placements=gt)
    y = _WideLogits.apply(xl, tl) if xl.is_cuda else unembed_chunked(tl, xl)
    return DTensor.from_local(y, mesh, out)


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
