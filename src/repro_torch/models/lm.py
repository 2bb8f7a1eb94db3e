"""Decoder-only transformer LM; the port's copy of the JAX package's
``models/lm.py`` for dense layers with full causal attention (qwen2,
deepseek-coder, starcoder2).

Params are a dict of tensors with one dict per layer under ``"blocks"``
(the JAX package stacks them ``[L, ...]`` for ``lax.scan``; here a Python
loop runs the layers).  Entry points:

  forward      — tokens [B, S] -> (logits, aux) over every position
  prefill      — tokens [B, S] + empty caches -> (last-position logits,
                 caches); attention runs the flash kernel in every layer
  decode_step  — one token per row against the caches, at one position
                 for all rows or one per row (the engine's slots)

The caches are one stacked pair ``[L, B, Smax, n_kv, D]`` in the model's
dtype, written in place.  Not ported yet, each raising with its ROADMAP
item: MoE layers, sliding-window layers with their per-layer ring caches,
the int8 KV cache and int8 serve weights.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import AttnSpec, attention, init_attention
from repro_torch.nn.embeddings import embed, init_embedding, unembed
from repro_torch.nn.layers import ffn, init_ffn
from repro_torch.nn.norms import init_rms, rms_norm

Cache = Tuple[torch.Tensor, torch.Tensor]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what of the JAX package's LM the port does not run yet."""
    if cfg.moe_every in (1, 2):   # the JAX package's _layer_kinds
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP Queue 1: nn/moe.py)")
    if cfg.global_every > 0 and cfg.window > 0:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window layers and their per-layer ring caches "
            "are not ported yet (ROADMAP Queue 1: ring/windowed caches)")
    if cfg.kv_quant:
        raise NotImplementedError(
            f"{cfg.name}: the int8 KV cache is not ported yet (ROADMAP Queue 1: "
            "int8 KV cache); serve with dataclasses.replace(cfg, kv_quant=False)")
    if cfg.serve_weight_quant:
        raise NotImplementedError(
            f"{cfg.name}: int8 serve weights are not ported yet (ROADMAP Queue 1: "
            "serve_weight_quant)")


def _attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                    rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias)


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights drawn on ``device`` from ``generator`` (a generator on
    that device), one tensor at a time."""
    check_supported(cfg)
    dt = cfg.dtype
    params: Dict = {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model, dt, device),
        "final_norm": init_rms(cfg.d_model, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(generator, cfg.vocab, cfg.d_model, dt,
                                           device)
    params["blocks"] = [
        {
            "ln1": init_rms(cfg.d_model, dt, device=device),
            "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                   cfg.head_dim, qkv_bias=cfg.qkv_bias, dtype=dt,
                                   device=device),
            "ln2": init_rms(cfg.d_model, dt, device=device),
            "ffn": init_ffn(generator, cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind,
                            dtype=dt, device=device),
        }
        for _ in range(cfg.n_layers)
    ]
    return params


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def unstack_layers(stacked, n_layers: int, device=None) -> list:
    """A reference tree of stacked ``[L, ...]`` arrays (numpy) as ``n_layers``
    per-layer dicts of tensors on ``device``."""
    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return _to_torch(np.asarray(tree)[i], device)

    return [layer(stacked, i) for i in range(n_layers)]


def tree_to_torch(tree, device=None):
    """A reference tree of numpy arrays as the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    return _to_torch(tree, device)


def params_from_reference(ref: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's param tree (``lm.init``: stacked ``[L, ...]``
    blocks, as numpy arrays) as the port's per-layer dicts."""
    check_supported(cfg)
    out = {name: _to_torch(ref[name], device)
           for name in ("embed", "unembed", "final_norm") if name in ref}
    out["blocks"] = unstack_layers(ref["blocks_dense"], cfg.n_layers, device)
    return out


def _block(p: dict, x, positions, cfg: ModelConfig, kv_cache=None,
           cache_len=None, flash=None):
    h, new_cache = attention(p["attn"], rms_norm(x, p["ln1"], eps=cfg.norm_eps),
                             positions, _attn_spec(cfg), kv_cache=kv_cache,
                             cache_len=cache_len, flash=flash)
    x = x + h
    y = ffn(p["ffn"], rms_norm(x, p["ln2"], eps=cfg.norm_eps), kind=cfg.ffn_kind)
    return x + y, new_cache


def _head(params: dict, x, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed" if cfg.tie_embeddings else "unembed"], x)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            full_logits: bool = True, flash: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (f32 logits, aux loss, 0 for dense layers)."""
    check_supported(cfg)
    x = embed(params["embed"], tokens)
    for p in params["blocks"]:
        x, _ = _block(p, x, None, cfg, flash=flash)      # queries at 0..S-1
    if not full_logits:
        x = x[:, -1:]
    return _head(params, x, cfg), torch.zeros((), device=tokens.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Cache:
    """One stacked (k, v) pair ``[L, B, max_len, n_kv, head_dim]``."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _serve_pass(params: dict, x, positions, cache: Cache, cache_len,
                cfg: ModelConfig, flash=None):
    """Run the layers against the stacked caches (layer i writes its
    slice in place).  Returns (x, cache)."""
    ck, cv = cache
    for i, p in enumerate(params["blocks"]):
        x, _ = _block(p, x, positions, cfg, kv_cache=(ck[i], cv[i]),
                      cache_len=cache_len, flash=flash)
    return x, cache


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, cache: Cache,
            *, flash: Optional[Callable] = None) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, S] + empty caches -> (last-position f32 logits [B, 1, V],
    caches).  ``flash`` replaces the attention kernel in every layer
    (``nn.attention.attention``)."""
    check_supported(cfg)
    x = embed(params["embed"], tokens)
    x, cache = _serve_pass(params, x, None, cache, 0, cfg, flash=flash)  # 0..S-1
    return _head(params, x[:, -1:], cfg), cache


def decode_positions(pos, b: int, s: int, smax: int, device):
    """A decode step's ``pos`` (the current length: one int for every row,
    or one per row on the host, as the engine's slots give it), checked
    against a cache of ``smax`` positions -> ``(cache_len, positions
    [b, s])``: an int or a [b] tensor on ``device``."""
    pos = np.asarray(pos.cpu() if torch.is_tensor(pos) else pos, dtype=np.int64)
    if pos.ndim > 1 or (pos.ndim == 1 and pos.shape != (b,)):
        raise ValueError(f"decode_step: positions of shape {pos.shape} for {b} rows")
    if pos.min() < 0 or pos.max() + s > smax:
        raise ValueError(f"decode_step: positions {pos.tolist()} (+{s}) outside "
                         f"the cache's {smax} positions")
    steps = torch.arange(s, device=device)
    if pos.ndim == 0:
        cache_len = int(pos)
        return cache_len, (cache_len + steps).expand(b, s)
    cache_len = torch.as_tensor(pos, device=device)
    return cache_len, cache_len[:, None] + steps


def decode_step(params: dict, cache: Cache, tokens: torch.Tensor, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, 1] at ``pos``: the current length, one int for every row
    or one per row on the host (the engine's slots), checked here against
    the cache -> (f32 logits [B, 1, V], caches)."""
    check_supported(cfg)
    b, s = tokens.shape
    cache_len, positions = decode_positions(pos, b, s, cache[0].shape[2],
                                            tokens.device)
    x = embed(params["embed"], tokens)
    x, cache = _serve_pass(params, x, positions, cache, cache_len, cfg)
    return _head(params, x, cfg), cache
