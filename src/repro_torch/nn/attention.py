"""Attention layer: GQA, RoPE, the bf16/f32 KV cache; the port's copy of
the JAX package's ``nn/attention.py``.

Two routes compute the same function, chosen by the call's structure:

* **the kernel** (``kernels/flash_attention.py``): causal self-attention
  with no window whose queries sit at positions 0..S-1 against keys
  0..S-1 — ``forward`` (no cache) and ``prefill`` (a cache written from
  position 0).  With a cache the JAX package attends over all ``Smax``
  cached keys and masks those at ``>= kv_len = S``: a masked score adds
  ``exp(-1e30 - m) = 0``, so that is exactly attention over the first S
  keys, which is what the kernel gets.  The route is taken only when
  the queries sit at 0..S-1 in every row: ``q_positions=None`` says so
  (``lm.forward`` and ``lm.prefill`` pass it); given positions are
  checked on the host, one synchronisation per call, and any others go
  to the dense path, as in the JAX package.
* **the dense masked path** (``_attend_dense``) for everything else:
  decode (one query at a per-row position against a per-row ``kv_len``)
  lies outside ``flash_attention_p``'s contract, whose causal mask puts
  query row 0 at position 0; the JAX package runs no kernel there either.

The cache is updated in place (the JAX package returns a new one) and
returned.  A write past the cache's end raises, where the JAX package's
``dynamic_update_slice`` would clamp the start.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.flash_attention import attention_impl
from repro_torch.nn.embeddings import rope

_NEG = -1e30


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


def _attend_dense(q, k, v, q_pos, k_pos, *, causal, window, kv_len, scale):
    """q: [B, Hkv, G, Sq, D]; k/v: [B, Hkv, Sk, D] -> f32 [B, Hkv, G, Sq, D].

    Scores and the value product are f32 products of f32 copies of the
    operands: a bf16 product is exact in f32, so this is the JAX package's
    ``preferred_element_type=f32``.  The copy is of one layer's cache for
    the live slots, small beside that layer's weights, which a decode step
    reads as well.
    """
    b, hkv, g, sq, d = q.shape
    s = torch.matmul(q.reshape(b, hkv, g * sq, d).float(),
                     k.float().transpose(-1, -2)).reshape(b, hkv, g, sq, -1)
    s = s * scale
    m = _mask(q_pos, k_pos, causal=causal, window=window, kv_len=kv_len)
    # broadcast mask [B?, Sq, Sk] -> [B, 1, 1, Sq, Sk]
    while m.dim() < s.dim():
        m = m[:, None] if m.dim() > 2 else m[None]
    s = torch.where(m, s, _NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(p.reshape(b, hkv, g * sq, -1).float(), v.float())
    return out.reshape(b, hkv, g, sq, d)


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    causal: bool = True
    qkv_bias: bool = False
    use_rope: bool = True


def _write_cache(ck, cv, k, v, cache_len, sq):
    """Write k/v [B, Sq, nkv, D] into the cache [B, Smax, nkv, D] in place
    at ``cache_len`` (a scalar, or one start per row).  Returns
    ``(kv_len, from_zero)``."""
    smax = ck.shape[1]
    ndim = cache_len.dim() if torch.is_tensor(cache_len) else np.ndim(cache_len)
    if ndim == 0:
        start = int(cache_len)
        if start < 0 or start + sq > smax:
            raise ValueError(f"cache write at {start}..{start + sq} outside the "
                             f"cache's {smax} positions")
        ck[:, start:start + sq] = k.to(ck.dtype)
        cv[:, start:start + sq] = v.to(cv.dtype)
        return start + sq, start == 0
    if not (torch.is_tensor(cache_len) and cache_len.is_cuda):
        # host positions are checked here; a device tensor is the caller's
        # to check (lm.decode_step does, on the host, before moving it)
        pos = np.asarray(cache_len)
        if pos.min() < 0 or pos.max() + sq > smax:
            raise ValueError(f"cache writes at {pos.tolist()} (+{sq}) outside "
                             f"the cache's {smax} positions")
    start = torch.as_tensor(cache_len, dtype=torch.long, device=ck.device)
    rows = start[:, None] + torch.arange(sq, device=ck.device)
    bidx = torch.arange(ck.shape[0], device=ck.device)[:, None]
    ck[bidx, rows] = k.to(ck.dtype)
    cv[bidx, rows] = v.to(cv.dtype)
    return start + sq, False


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
    kv_cache: Optional[Tuple[torch.Tensor, ...]] = None,  # [B, Smax, n_kv, D]
    cache_len=None,                     # int, or [B] per-slot positions
    window: Optional[int] = None,       # 0/None = global
    ring: bool = False,
    flash: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Returns (out [B, Sq, d_model], updated kv_cache or None).

    ``flash`` replaces the kernel route's core, ``impl(q [B, H, S, D],
    k, v [B, Hkv, S, D]) -> [B, H, S, D]`` (default: the CUDA kernel's
    ``attention_impl(causal=True)``).
    """
    if kv_cache is not None and ring:
        raise NotImplementedError(
            "ring-buffer KV caches of windowed layers are not ported yet "
            "(ROADMAP Queue 1: ring/windowed caches)")
    if kv_cache is not None and len(kv_cache) == 4:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP Queue 1: int8 KV cache)")
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

    q = q.reshape(b, sq, h, dh)
    k = k.reshape(b, src.shape[1], nkv, dh)
    v = v.reshape(b, src.shape[1], nkv, dh)

    if spec.use_rope and x_kv is None:
        q = rope(q, q_positions, theta=spec.rope_theta)
        k = rope(k, q_positions, theta=spec.rope_theta)

    new_cache = None
    kv_len, from_zero = None, True
    if kv_cache is not None:
        ck, cv = kv_cache
        kv_len, from_zero = _write_cache(ck, cv, k, v, cache_len, sq)
        new_cache = (ck, cv)
        k, v = ck, cv

    causal = spec.causal and x_kv is None
    kernel_route = causal and from_zero and not window
    if kernel_route and positions_given:
        kernel_route = _positions_from_zero(q_positions, sq)
    if kernel_route:
        dt = torch.promote_types(q.dtype, k.dtype)
        qh = q.transpose(1, 2).to(dt).contiguous()                 # [B, H, S, D]
        kh = k[:, :sq].transpose(1, 2).to(dt).contiguous()         # [B, Hkv, S, D]
        vh = v[:, :sq].transpose(1, 2).to(dt).contiguous()
        core = flash if flash is not None else attention_impl(causal=True)
        out = core(qh, kh, vh).transpose(1, 2).reshape(b, sq, h * dh)
    else:
        qh = q.reshape(b, sq, nkv, g, dh).permute(0, 2, 3, 1, 4)  # [B, Hkv, G, Sq, D]
        kh = k.transpose(1, 2)                                     # [B, Hkv, Sk, D]
        vh = v.transpose(1, 2)
        k_pos = torch.arange(kh.shape[2], device=x.device)
        out = _attend_dense(qh, kh, vh, q_positions, k_pos, causal=causal,
                            window=window, kv_len=kv_len,
                            scale=1.0 / math.sqrt(dh))
        out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h * dh)
    out = out.to(x.dtype) @ params["wo"]
    return out, new_cache
