"""zamba2-1.2b — Mamba2 backbone + one *shared* attention block; the port's
copy of the JAX package's ``models/hybrid.py``.

A single transformer block (attention + MLP, one set of weights) runs
before every group of ``hybrid_attn_every`` Mamba2 layers.  Params hold
``"shared"`` and one dict per Mamba2 layer under ``"blocks"``; a Python
loop runs the groups.  Prefill runs the SSD kernel in every Mamba2 layer
and the flash kernel at every shared-attention site (queries at 0..S-1,
passed as ``None``: no host check).

State: ``{"ssm": (s [L, B, H, P, N] f32, conv [L, B, K-1, conv_dim]),
"kv": (k, v [n_sites, B, max_len, n_kv, head_dim])}``, one KV cache per
shared-attention site, written in place.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba
from repro_torch.models.lm import decode_positions, tree_to_torch, unstack_layers
from repro_torch.nn.attention import AttnSpec, attention, init_attention
from repro_torch.nn.embeddings import embed, init_embedding, unembed
from repro_torch.nn.layers import ffn, init_ffn
from repro_torch.nn.norms import init_rms, rms_norm


def _attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                    rope_theta=cfg.rope_theta)


def n_sites(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights drawn on ``device`` from ``generator`` (a generator on
    that device), one tensor at a time."""
    dt = cfg.dtype
    return {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model, dt, device),
        "final_norm": init_rms(cfg.d_model, dt, device=device),
        "shared": {
            "ln1": init_rms(cfg.d_model, dt, device=device),
            "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                   cfg.head_dim, dtype=dt, device=device),
            "ln2": init_rms(cfg.d_model, dt, device=device),
            "ffn": init_ffn(generator, cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind,
                            dtype=dt, device=device),
        },
        "blocks": [mamba.init_block(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
    }


def params_from_reference(ref: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's param tree (``hybrid.init``: ``"shared"`` plus
    stacked ``[L, ...]`` blocks, as numpy arrays) as the port's dicts."""
    return {"embed": tree_to_torch(ref["embed"], device),
            "final_norm": tree_to_torch(ref["final_norm"], device),
            "shared": tree_to_torch(ref["shared"], device),
            "blocks": unstack_layers(ref["blocks"], cfg.n_layers, device)}


def init_state(cfg: ModelConfig, batch: int, max_len: int, kv_dtype=None,
               device=None) -> dict:
    kv_dtype = kv_dtype or cfg.dtype
    kv_shape = (n_sites(cfg), batch, max_len, cfg.n_kv, cfg.head_dim)
    return {
        "ssm": mamba.init_state(cfg, batch, device),
        "kv": (torch.zeros(kv_shape, dtype=kv_dtype, device=device),
               torch.zeros(kv_shape, dtype=kv_dtype, device=device)),
    }


def _shared_block(params: dict, x, positions, cfg: ModelConfig, kv=None,
                  cache_len=None, flash=None):
    p = params["shared"]
    h, _ = attention(p["attn"], rms_norm(x, p["ln1"], eps=cfg.norm_eps),
                     positions, _attn_spec(cfg), kv_cache=kv,
                     cache_len=cache_len, flash=flash)
    x = x + h
    return x + ffn(p["ffn"], rms_norm(x, p["ln2"], eps=cfg.norm_eps),
                   kind=cfg.ffn_kind)


def _pass(params: dict, x, positions, cfg: ModelConfig, state=None,
          cache_len=None, decode=False, flash=None, ssd=None):
    """The groups: the shared block at each group's boundary (with that
    site's KV cache), then the group's Mamba2 layers (with theirs)."""
    per = cfg.hybrid_attn_every
    for site in range(n_sites(cfg)):
        kv = None
        if state is not None:
            kv = (state["kv"][0][site], state["kv"][1][site])
        x = _shared_block(params, x, positions, cfg, kv=kv, cache_len=cache_len,
                          flash=flash)
        for i in range(site * per, (site + 1) * per):
            st = None
            if state is not None:
                st = (state["ssm"][0][i], state["ssm"][1][i])
            x = mamba.layer(params["blocks"][i], x, cfg, state=st, decode=decode,
                            ssd=ssd)
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            full_logits: bool = True, flash: Optional[Callable] = None,
            ssd: Optional[Callable] = None):
    """tokens [B, S] -> (f32 logits, aux loss 0); queries at 0..S-1."""
    x = _pass(params, embed(params["embed"], tokens), None, cfg, flash=flash, ssd=ssd)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    if not full_logits:
        x = x[:, -1:]
    return unembed(params["embed"], x), torch.zeros((), device=tokens.device)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, state: dict, *,
            flash: Optional[Callable] = None, ssd: Optional[Callable] = None):
    """tokens [B, S] + an empty state -> (last-position f32 logits
    [B, 1, V], state); ``flash`` and ``ssd`` replace the two kernels."""
    x = _pass(params, embed(params["embed"], tokens), None, cfg, state=state,
              cache_len=0, flash=flash, ssd=ssd)
    x = rms_norm(x[:, -1:], params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], x), state


def decode_step(params: dict, state: dict, tokens: torch.Tensor, pos,
                cfg: ModelConfig):
    """tokens [B, 1] at ``pos`` (one int, or one per row on the host) ->
    (f32 logits [B, 1, V], state)."""
    b, s = tokens.shape
    cache_len, positions = decode_positions(pos, b, s, state["kv"][0].shape[2],
                                            tokens.device)
    x = _pass(params, embed(params["embed"], tokens), positions, cfg, state=state,
              cache_len=cache_len, decode=True)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], x), state
