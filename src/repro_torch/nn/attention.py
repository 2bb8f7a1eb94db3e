"""Attention layer: GQA, RoPE, sliding windows, the bf16/f32 KV cache, the
int8 KV cache and the ring-buffer cache of windowed layers; the port's
copy of the JAX package's ``nn/attention.py``.

Three routes compute the same function, chosen by the call's structure:

* **the kernel** (``kernels/flash_attention.py``), for every call inside
  ``flash_attention_p``'s contract:
  - causal self-attention with no window whose queries sit at positions
    0..S-1 against keys 0..S-1 — ``forward`` (no cache) and ``prefill``
    (a cache written from position 0).  With a cache the JAX package
    attends over all ``Smax`` cached keys and masks those at ``>= kv_len
    = S``: a masked score adds ``exp(-1e30 - m) = 0``, so that is exactly
    attention over the first S keys, which is what the kernel gets.  The
    route is taken only when the queries sit at 0..S-1 in every row:
    ``q_positions=None`` says so (the models' prefills pass it); given
    positions are checked on the host, one synchronisation per call, and
    any others go to the masked paths, as in the JAX package;
  - non-causal attention in which every key is valid: no cache (so no
    length mask) and no window — an encoder's self-attention, and
    cross-attention to a memory at prefill and at decode (Sq = 1 against
    T keys).  Positions play no part in its mask.
* **the masked paths** for everything else, by the JAX package's rule
  (``AttnSpec.impl="auto"``): ``_attend_dense`` while ``Sq·Sk <=
  dense_max²``, ``_attend_blockwise`` (an online softmax over q and k
  blocks, never holding more than one block's scores) above.  Decode
  against a cache (one query at a per-row position against a per-row
  ``kv_len``) lies outside ``flash_attention_p``'s contract, whose causal
  mask puts query row 0 at position 0; so do windowed layers, which the
  JAX package computes in plain jnp, as ``flash_attention_p`` has no
  window.
* **under autograd** — a call in which grad is enabled and q, k or v
  requires grad (a train step: ``loss_fn`` and its backward) — always
  the masked paths by the ``auto`` rule: the routes the JAX package
  trains through, whose plain jnp it differentiates.  The kernel has no
  backward (``kernels/_build.check_operands`` refuses a call that
  autograd would record), so the choice is made from the call's
  structure, like the two above; serving calls, whose params do not
  require grad, keep the kernel route.

A windowed layer whose cache is a ring of ``w`` slots (``ring=True``)
holds position t at slot ``t mod w``.  Prefill keeps the last ``min(w,
S)`` tokens there and attends over the current k/v under the window mask.
Decode writes each row at ``pos_b mod w`` and masks slot i of row b by the
position it holds, ``pos_b - ((pos_b - i) mod w)``, empty slots (negative)
masked by causality.  The JAX package writes and masks every row at one
position (the batch's largest, ``models/lm.py::_serve_pass_per_layer``),
which is the same where all rows share it.

The int8 cache ``(ck, cv, sk, sv)`` holds k and v as int8 with one f32
scale a (token, kv head), ``max|k| / 127`` floored at 1e-8, and attends
over its dequantized contents (``ck * sk`` in the model's dtype), as the
JAX package does: a prefill's kernel route gets the dequantized first S
keys.  It is written at one position for every row or at each row's own
(the engine's slots), where the JAX package's int8 branch takes one.

The caches are updated in place (the JAX package returns new ones) and
returned.  A write past a full cache's end raises, where the JAX package's
``dynamic_update_slice`` would clamp the start.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (local_range, placed_like, replicate_dim,
                                              row_placements)
from repro_torch.kernels.flash_attention import attention_impl
from repro_torch.nn.embeddings import rope
from repro_torch.nn.quant import exact_divisor
from repro_torch.tree import records_grad

_NEG = -1e30
_EMPTY = 2 ** 30   # an empty ring slot's position: causality masks it


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, *, qkv_bias: bool = False,
                   dtype=torch.float32, device=None) -> dict:
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(n_heads * head_dim)

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)

    p = {
        "wq": normal((d_model, n_heads * head_dim), s_in),
        "wk": normal((d_model, n_kv * head_dim), s_in),
        "wv": normal((d_model, n_kv * head_dim), s_in),
        "wo": normal((n_heads * head_dim, d_model), s_out),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype, device=device)
    return p


def _mask(q_pos, k_pos, *, causal: bool, window, kv_len):
    """[.., Sq, Sk] boolean validity mask from position vectors."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window:
        m &= (qp - kp) < window
    if kv_len is not None:
        m &= kp < torch.as_tensor(kv_len, device=q_pos.device)[..., None, None]
    return m


def _scores(q, k, q_pos, k_pos, *, causal, window, kv_len, scale):
    """q: [B, Hkv, G, Sq, D]; k: [B, Hkv, Sk, D] -> masked f32 scores
    [B, Hkv, G, Sq, Sk], masked entries at -1e30.

    The product is an f32 product of f32 copies of the operands: a bf16
    product is exact in f32, so this is the JAX package's
    ``preferred_element_type=f32``.  The copy is of one layer's cache for
    the live slots, small beside that layer's weights, which a decode step
    reads as well."""
    b, hkv, g, sq, d = q.shape
    s = torch.matmul(q.reshape(b, hkv, g * sq, d).float(),
                     k.float().transpose(-1, -2)).reshape(b, hkv, g, sq, -1)
    s = s * scale
    m = _mask(q_pos, k_pos, causal=causal, window=window, kv_len=kv_len)
    # broadcast mask [B?, Sq, Sk] -> [B, 1, 1, Sq, Sk]
    while m.dim() < s.dim():
        m = m[:, None] if m.dim() > 2 else m[None]
    return torch.where(m, s, _NEG)


def _pv(p, v):
    """p [B, Hkv, G, Sq, Sk] (f32, rounded to v's dtype first, as the JAX
    package casts it) @ v [B, Hkv, Sk, D] -> f32 [B, Hkv, G, Sq, D]."""
    b, hkv, g, sq, sk = p.shape
    out = torch.matmul(p.to(v.dtype).reshape(b, hkv, g * sq, sk).float(), v.float())
    return out.reshape(b, hkv, g, sq, -1)


def _attend_dense(q, k, v, q_pos, k_pos, *, causal, window, kv_len, scale):
    """q: [B, Hkv, G, Sq, D]; k/v: [B, Hkv, Sk, D] -> f32 [B, Hkv, G, Sq, D]."""
    s = _scores(q, k, q_pos, k_pos, causal=causal, window=window, kv_len=kv_len,
                scale=scale)
    return _pv(torch.softmax(s, dim=-1), v)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """f32 [B, Hkv, G, Sq, D] -> [B, Sq, H * D]."""
    b, _, _, sq, _ = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, -1)


def _attend_local(attend, qh, kh, vh, per_row):
    """``attend(q [B, H, Sq, D], k, v [B, Hkv, Sk, D], per_row) -> [B, Sq, H
    * D]`` on DTensors: each rank attends its own rows (batch over the
    mesh's data axes, where those divide it) and its own q heads over
    'model' where they split (``_heads_stay_split``), against the KV heads
    they map to (q head h reads KV head ``h // (H / Hkv)``): its KV shard
    where the KV heads split over 'model' too, else its contiguous slice
    of the whole KV heads, whose grad is then a partial sum over 'model'.
    Attention is independent across rows and heads, so no collective runs
    inside; DTensor's own propagation of the score products over merged
    (strided) batch-head shards cost seconds a shape, and its view of the
    merged heads refuses a grad sharded unevenly over them.  The flash
    kernel takes a rank's shards as plain tensors.  ``per_row`` maps names
    to plain tensors of one entry a row (``[B, ...]``: the query positions,
    and at decode the per-row key lengths and ring slot positions); each
    is sliced to the rank's rows."""
    mesh = qh.device_mesh
    names = list(mesh.mesh_dim_names)
    pl, row, rows = row_placements(mesh, qh.shape[0])
    q_pl, kv_pl, kv_grad, out_pl = list(pl), list(pl), list(pl), list(pl)
    h, hkv = qh.shape[1], kh.shape[1]
    kv_slice = None
    if "model" in names:
        m = names.index("model")
        n = mesh.shape[m]
        if _heads_stay_split(h, h // hkv, n):
            q_pl[m], out_pl[m] = Shard(1), Shard(2)
            if hkv % n == 0:
                kv_pl[m] = kv_grad[m] = Shard(1)
            else:
                local, group = h // n, h // hkv
                first = mesh.get_local_rank(m) * local // group
                kv_slice = slice(first, first + max(1, local // group))
                kv_grad[m] = Partial()
    ql = qh.redistribute(mesh, q_pl).to_local()
    kl, vl = (t.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad) for t in (kh, vh))
    if kv_slice is not None:
        kl, vl = kl[:, kv_slice].contiguous(), vl[:, kv_slice].contiguous()
    local = {name: t.chunk(rows)[row] for name, t in per_row.items()}
    return DTensor.from_local(attend(ql, kl, vl, local), mesh, out_pl)


def _block_size(block: int, n: int) -> int:
    """The JAX package's block rule: ``min(block, n)``, halved until it
    divides n."""
    block = min(block, n)
    while n % block:
        block //= 2
    return max(block, 1)


def _attend_blockwise(q, k, v, q_pos, k_pos, *, causal, window, kv_len, scale,
                      q_block: int, k_block: int, ordered: bool = False):
    """Online softmax over q blocks and, inside each, k blocks: the same
    function as ``_attend_dense`` without the [Sq, Sk] scores.

    Blocks are sized as the JAX package's ``_attend_blockwise`` sizes
    them.  A key block that the causal, window or length mask covers
    wholly for every row of a q block is skipped (one host read of the
    blocks' position bounds a call).  Skipping is exact: such a block adds
    ``exp(-1e30 - m) = 0`` to a running sum that a valid key has set, and
    a block processed before any valid key is wiped by ``alpha = 0`` once
    one arrives; a q block whose key blocks would all be skipped processes
    them all, so a row with no valid key still gets the reference's mean
    of v.  ``ordered``: the caller knows the positions are 0..Sq-1 in every
    row and 0..Sk-1, so the bounds need no read (nor a fake tensor's data,
    in the dry run's trace) when ``kv_len`` is None or an int."""
    b, hkv, g, sq, d = q.shape
    sk = k.shape[2]
    qb, kb = _block_size(q_block, sq), _block_size(k_block, sk)
    nq, nk = sq // qb, sk // kb
    if ordered and not torch.is_tensor(kv_len):
        q_lo, k_lo = list(range(0, sq, qb)), list(range(0, sk, kb))
        q_hi, k_hi = [lo + qb - 1 for lo in q_lo], [lo + kb - 1 for lo in k_lo]
        n_valid = math.inf if kv_len is None else kv_len
    else:
        qp = q_pos.reshape(-1, nq, qb)
        kp = k_pos.reshape(-1, nk, kb)
        bounds = [qp.amin((0, 2)), qp.amax((0, 2)), kp.amin((0, 2)), kp.amax((0, 2))]
        if kv_len is not None:
            bounds.append(torch.as_tensor(kv_len, device=q.device).reshape(-1).amax()[None])
        bounds = torch.cat(bounds).tolist()
        q_lo, q_hi, k_lo, k_hi = (bounds[:nq], bounds[nq:2 * nq], bounds[2 * nq:2 * nq + nk],
                                  bounds[2 * nq + nk:2 * nq + 2 * nk])
        n_valid = bounds[-1] if kv_len is not None else math.inf

    def covered(i, j):
        return ((causal and k_lo[j] > q_hi[i]) or (bool(window) and q_lo[i] - k_hi[j] >= window)
                or k_lo[j] >= n_valid)

    out = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    for i in range(nq):
        rows = slice(i * qb, (i + 1) * qb)
        keep = [j for j in range(nk) if not covered(i, j)] or list(range(nk))
        m_run = torch.full((b, hkv, g, qb, 1), _NEG, device=q.device)
        l_run = torch.zeros((b, hkv, g, qb, 1), device=q.device)
        acc = torch.zeros((b, hkv, g, qb, d), device=q.device)
        for j in keep:
            cols = slice(j * kb, (j + 1) * kb)
            s = _scores(q[..., rows, :], k[:, :, cols], q_pos[..., rows], k_pos[..., cols],
                        causal=causal, window=window, kv_len=kv_len, scale=scale)
            m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m_run - m_new)
            l_run = alpha * l_run + p.sum(-1, keepdim=True)
            acc = acc * alpha + _pv(p, v[:, :, cols])
            m_run = m_new
        out[..., rows, :] = acc / torch.clamp(l_run, min=1e-30)
    return out


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    causal: bool = True
    qkv_bias: bool = False
    use_rope: bool = True
    q_block: int = 512
    k_block: int = 1024
    impl: str = "auto"          # auto | dense | blockwise (the masked paths)
    dense_max: int = 2048       # auto: dense while Sq·Sk <= dense_max², else blockwise


def _quantize_kv(t):
    """k or v [B, S, nkv, D] -> (int8 values, f32 scales [B, S, nkv]): the
    JAX package's per-(token, kv head) arithmetic, with true quotients on
    the CPU and on the card (``exact_divisor``)."""
    tf = t.float()
    s = torch.clamp(tf.abs().amax(-1) / exact_divisor(127.0, tf), min=1e-8)
    return torch.clamp(torch.round(tf / s[..., None]), -127, 127).to(torch.int8), s


def _put(c, t, start: int) -> None:
    """``c[:, start:start + Sq] = t`` in place (t [B, Sq, ...]).  A DTensor
    cache is written shard by shard: each rank writes, into its local
    shard, the positions it holds of its rows, from ``t`` placed like the
    cache but whole along the positions (DTensor's own indexed write
    into a dim sharded over positions lands in a copy: the cache would
    stay empty)."""
    if not isinstance(c, DTensor):
        c[:, start:start + t.shape[1]] = t.to(c.dtype)
        return
    want = [p if p.is_shard() and p.dim != 1 else Replicate() for p in c.placements]
    tl = t.redistribute(c.device_mesh, want).to_local()
    lo, n = local_range(c, 1)
    a, b = max(start, lo), min(start + tl.shape[1], lo + n)
    if a < b:
        c.to_local()[:, a - lo:b - lo] = tl[:, a - start:b - start].to(c.dtype)


def _put_rows(c, t, start: torch.Tensor) -> None:
    """``c[b, start[b]:start[b] + Sq] = t[b]`` for every row b, in place (t
    [B, Sq, ...], ``start`` [B] on the cache's device).  A DTensor cache is
    written shard by shard, as ``_put`` writes it: each rank writes its
    local rows at the positions its shard holds, one query step at a time
    (one entry a row, so no two writes of a step meet); a position outside
    the shard writes back what is there."""
    if not isinstance(c, DTensor):
        rows = start[:, None] + torch.arange(t.shape[1], device=start.device)
        c[torch.arange(c.shape[0], device=start.device)[:, None], rows] = t.to(c.dtype)
        return
    want = [p if p.is_shard() and p.dim != 1 else Replicate() for p in c.placements]
    tl = t.redistribute(c.device_mesh, want).to_local()
    (r0, nr), (p0, n) = local_range(c, 0), local_range(c, 1)
    if nr == 0 or n == 0:
        return
    cl = c.to_local()
    bidx = torch.arange(nr, device=cl.device)
    for j in range(tl.shape[1]):
        at = start[r0:r0 + nr] + (j - p0)
        inside = ((at >= 0) & (at < n)).reshape((nr,) + (1,) * (cl.dim() - 2))
        at = at.clamp(0, n - 1)
        cl[bidx, at] = torch.where(inside, tl[:, j].to(cl.dtype), cl[bidx, at])


def _write_cache(caches, values, cache_len, sq):
    """Write each of ``values`` ([B, Sq, ...]) into its cache ([B, Smax,
    ...]) in place at ``cache_len`` (a scalar, or one start per row): the
    (k, v) pair, or the int8 cache's values and scales.  Returns
    ``(kv_len, from_zero)``."""
    smax = caches[0].shape[1]
    ndim = cache_len.dim() if torch.is_tensor(cache_len) else np.ndim(cache_len)
    if ndim == 0:
        start = int(cache_len)
        if start < 0 or start + sq > smax:
            raise ValueError(f"cache write at {start}..{start + sq} outside the "
                             f"cache's {smax} positions")
        for c, t in zip(caches, values):
            _put(c, t, start)
        return start + sq, start == 0
    if not (torch.is_tensor(cache_len) and cache_len.is_cuda):
        # host positions are checked here; a device tensor is the caller's
        # to check (lm.decode_step does, on the host, before moving it)
        pos = np.asarray(cache_len)
        if pos.min() < 0 or pos.max() + sq > smax:
            raise ValueError(f"cache writes at {pos.tolist()} (+{sq}) outside "
                             f"the cache's {smax} positions")
    start = torch.as_tensor(cache_len, dtype=torch.long, device=caches[0].device)
    for c, t in zip(caches, values):
        _put_rows(c, t, start)
    return start + sq, False


def _write_ring(ck, cv, k, v, cache_len, sq):
    """Write k/v [B, Sq, nkv, D] into a ring [B, w, nkv, D] in place,
    position t at slot t mod w -> ``(k, v, k_pos)`` to attend over: at
    prefill (Sq > 1, one start for every row) the current k/v at their
    positions (None for 0..Sq-1); at decode the ring at the positions its
    slots hold, ``[w]`` for one position or ``[B, w]`` for one per row."""
    w = ck.shape[1]
    dev = ck.device
    per_row = (cache_len.dim() if torch.is_tensor(cache_len) else np.ndim(cache_len)) > 0
    if sq > 1:
        if per_row:
            raise ValueError("a ring prefill takes one start position for every row")
        start = int(cache_len)
        if sq >= w:
            # every slot is written: the last w positions rotated into their
            # slots as one copy (a DTensor cache sharded over its slots takes
            # no indexed in-place write; torch 2.11's DTensor has no roll)
            shift = (start + sq - w) % w
            for c, t in ((ck, k[:, -w:]), (cv, v[:, -w:])):
                if shift:
                    t = torch.cat([t[:, w - shift:], t[:, :w - shift]], dim=1)
                c.copy_(t.to(c.dtype))
        else:
            # slots start mod w onwards, wrapping past the ring's end
            first = min(sq, w - start % w)
            for c, t in ((ck, k), (cv, v)):
                _put(c, t[:, :first], start % w)
                if first < sq:
                    _put(c, t[:, first:], 0)
        return k, v, (None if start == 0 else start + torch.arange(sq, device=dev))
    if per_row:
        start = torch.as_tensor(cache_len, dtype=torch.long, device=dev)
        _put_rows(ck, k, start % w)
        _put_rows(cv, v, start % w)
        start = start[:, None]
    else:
        start = int(cache_len)
        _put(ck, k, start % w)
        _put(cv, v, start % w)
    t = start - ((start - torch.arange(w, device=dev)) % w)
    return ck, cv, torch.where(t >= 0, t, _EMPTY)


def _heads_stay_split(heads: int, group: int, n: int) -> bool:
    """Whether ``heads`` heads, ``group`` of them a KV head, split over a
    mesh dim of ``n`` ranks so that each rank's heads lie inside one KV
    head or form whole groups of them: a contiguous range of KV heads
    serves each rank.  (KV heads: ``group`` 1, they split where ``n``
    divides them.)"""
    if heads % n:
        return False
    local = heads // n
    return group % local == 0 or local % group == 0


def _whole_heads(t: torch.Tensor, heads: int, group: int = 1) -> torch.Tensor:
    """A projection ``[B, S, heads * D]`` ready to split into its heads
    (``group`` of them a KV head): a DTensor whose width is sharded over a
    mesh dim its heads do not split over (``_heads_stay_split``: qwen2's 4
    KV heads on a 'model' axis of 16) is gathered whole along the width,
    since DTensor refuses an uneven split of a sharded dim where XLA pads
    it.  Heads that split stay sharded: q's 48 heads over 16 (grok-1) stay
    split though its 8 KV heads are gathered (``_attend_local``)."""
    if isinstance(t, DTensor) and any(
            p.is_shard(t.dim() - 1) and not _heads_stay_split(heads, group, n)
            for p, n in zip(t.placements, t.device_mesh.shape)):
        return replicate_dim(t, -1)
    return t


def _positions_from_zero(q_positions, sq: int) -> bool:
    """True when every row of ``q_positions`` is 0..sq-1 (one host sync
    for a device tensor)."""
    pos = torch.as_tensor(q_positions)
    want = torch.arange(sq, device=pos.device)
    return pos.shape[-1] == sq and bool((pos == want).all())


def attention(
    params: dict,
    x: torch.Tensor,                    # [B, Sq, d_model]
    q_positions: Optional[torch.Tensor],  # [B, Sq]; None = 0..Sq-1 in every row
    spec: AttnSpec,
    *,
    x_kv: Optional[torch.Tensor] = None,   # cross-attention source [B, Skv, d]
    kv_cache: Optional[Tuple[torch.Tensor, ...]] = None,  # [B, Smax, n_kv, D] x 2, or int8 x 4
    cache_len=None,                     # int, or [B] per-slot positions
    window: Optional[int] = None,       # 0/None = global
    ring: bool = False,                 # kv_cache is a ring of window slots
    flash: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Returns (out [B, Sq, d_model], updated kv_cache or None).

    ``flash`` replaces the kernel route's core, ``impl(q [B, H, Sq, D],
    k, v [B, Hkv, Sk, D]) -> [B, H, Sq, D]`` for causal self-attention and
    ``impl(q, k, v, causal=False)`` for the non-causal calls (default: the
    CUDA kernel's ``attention_impl()``).
    """
    # a sequence-sharded residual (``constrain``) is gathered whole at the
    # block's entry and the output goes back on its sharding (Megatron-SP),
    # so no product sees a batch-sequence merged (strided) shard: DTensor
    # plans those for seconds a shape, or refuses them
    x_in, x = x, replicate_dim(x, 1)
    x_kv = None if x_kv is None else replicate_dim(x_kv, 1)
    b, sq, _ = x.shape
    h, nkv, dh = spec.n_heads, spec.n_kv, spec.head_dim
    g = h // nkv
    positions_given = q_positions is not None
    if not positions_given:
        q_positions = torch.arange(sq, device=x.device).expand(b, sq)

    q = x @ params["wq"]
    src = x if x_kv is None else x_kv
    k = src @ params["wk"]
    v = src @ params["wv"]
    if spec.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]

    q = _whole_heads(q, h, g).reshape(b, sq, h, dh)
    k = _whole_heads(k, nkv).reshape(b, src.shape[1], nkv, dh)
    v = _whole_heads(v, nkv).reshape(b, src.shape[1], nkv, dh)

    if spec.use_rope and x_kv is None:
        q = rope(q, q_positions, theta=spec.rope_theta)
        k = rope(k, q_positions, theta=spec.rope_theta)

    new_cache = None
    kv_len, from_zero, k_pos = None, True, None
    n_keys = k.shape[1]                  # the keys the kernel route attends over
    if kv_cache is not None and ring:
        ck, cv = kv_cache
        k, v, k_pos = _write_ring(ck, cv, k, v, cache_len, sq)
        new_cache = (ck, cv)
    elif kv_cache is not None and len(kv_cache) == 4:
        ck, cv, sk, sv = kv_cache
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        kv_len, from_zero = _write_cache(kv_cache, (kq, vq, ks, vs), cache_len, sq)
        new_cache = kv_cache
        # the JAX package casts the scale to x's dtype before the product
        k = ck.to(x.dtype) * sk[..., None].to(x.dtype)
        v = cv.to(x.dtype) * sv[..., None].to(x.dtype)
    elif kv_cache is not None:
        ck, cv = kv_cache
        kv_len, from_zero = _write_cache(kv_cache, (k, v), cache_len, sq)
        new_cache = (ck, cv)
        k, v = ck, cv

    causal = spec.causal and x_kv is None
    if records_grad(q, k, v):
        kernel_route = False            # the reference's differentiated routes
    elif causal:
        kernel_route = from_zero and not window and not ring
        if kernel_route and positions_given:
            kernel_route = _positions_from_zero(q_positions, sq)
    else:
        kernel_route = kv_cache is None and not window
    if kernel_route:
        dt = torch.promote_types(q.dtype, k.dtype)
        qh = q.transpose(1, 2).to(dt).contiguous()                    # [B, H, Sq, D]
        kh = k[:, :n_keys].transpose(1, 2).to(dt).contiguous()        # [B, Hkv, Sk, D]
        vh = v[:, :n_keys].transpose(1, 2).to(dt).contiguous()
        core = flash if flash is not None else attention_impl()

        def attend(qh, kh, vh, per_row):
            out = core(qh, kh, vh, **({} if causal else {"causal": False}))
            return out.transpose(1, 2).reshape(qh.shape[0], sq, -1)
    else:
        qh = q.transpose(1, 2)                                     # [B, H, Sq, D]
        kh = k.transpose(1, 2)                                     # [B, Hkv, Sk, D]
        vh = v.transpose(1, 2)
        ordered = not positions_given and k_pos is None
        if k_pos is None:
            k_pos = torch.arange(kh.shape[2], device=x.device)
        impl = spec.impl
        if impl == "auto":
            impl = "dense" if sq * kh.shape[2] <= spec.dense_max ** 2 else "blockwise"
        blocks = {} if impl == "dense" else {"q_block": spec.q_block,
                                             "k_block": spec.k_block, "ordered": ordered}
        scores = functools.partial(
            _attend_dense if impl == "dense" else _attend_blockwise, k_pos=k_pos,
            causal=causal, window=window, kv_len=kv_len, scale=1.0 / math.sqrt(dh),
            **blocks)

        def attend(qh, kh, vh, per_row):
            b_, h_, sq_, d_ = qh.shape                             # q as [B, Hkv, G, Sq, D]
            qg = qh.reshape(b_, kh.shape[1], h_ // kh.shape[1], sq_, d_)
            return _merge_heads(scores(qg, kh, vh, **per_row))
    # what differs row by row: the query positions, and at decode each row's
    # key length and ring slot positions (``_attend_local`` cuts them to a
    # rank's rows); the rest is bound into ``scores``
    per_row = {"q_pos": q_positions if q_positions.dim() >= 2 else q_positions.expand(b, sq)}
    if torch.is_tensor(kv_len):
        per_row["kv_len"] = kv_len
    if torch.is_tensor(k_pos) and k_pos.dim() >= 2:
        per_row["k_pos"] = k_pos
    if isinstance(qh, DTensor):
        out = _attend_local(attend, qh, kh, vh, per_row)
    else:
        out = attend(qh, kh, vh, per_row)
    out = out.to(x.dtype) @ params["wo"]
    return placed_like(out, x_in), new_cache
