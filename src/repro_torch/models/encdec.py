"""seamless-m4t-medium backbone, an encoder-decoder transformer; the
port's copy of the JAX package's ``models/encdec.py``.

The speech frontend is a stub: the caller supplies frame embeddings
``[B, T, d_model]``, which go straight into the encoder.  The encoder runs
non-causal self-attention with RoPE; each decoder layer runs causal
self-attention against its KV cache, then cross-attention (no RoPE) to
the encoder's output ``memory``, whose k/v are recomputed from it every
step, as in the JAX package.  On the card every attention except a decode
step's self-attention runs the flash kernel (``nn.attention``): a prefill
launches it 3 x 12 times (encoder, decoder self, cross), a decode step 12
times (cross, one query against T keys).

Params: ``embed``, ``enc_norm``, ``final_norm`` and one dict per layer
under ``enc`` and ``dec`` (the JAX package stacks them ``[L, ...]``).  The
decoder's cache is one stacked pair ``[dec_layers, B, Smax, n_kv, D]``.
``forward`` / ``loss_fn`` train the teacher-forced decoder over the
encoded frames; with ``cfg.remat`` each encoder and decoder layer runs
under activation checkpointing while autograd records (``lm.remat``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models.lm import (cross_entropy, decode_positions, remat, tree_to_torch,
                                   unstack_layers)
from repro_torch.nn.attention import AttnSpec, attention, init_attention
from repro_torch.nn.embeddings import embed, init_embedding, unembed
from repro_torch.nn.layers import ffn, init_ffn
from repro_torch.nn.norms import init_rms, rms_norm


def _spec(cfg: ModelConfig, causal: bool) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                    rope_theta=cfg.rope_theta, causal=causal,
                    q_block=cfg.q_block, k_block=cfg.k_block)


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights drawn on ``device`` from ``generator``."""
    dt = cfg.dtype

    def attn():
        return init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv,
                              cfg.head_dim, dtype=dt, device=device)

    def block(cross: bool) -> dict:
        p = {"ln1": init_rms(cfg.d_model, dt, device=device), "attn": attn(),
             "ln2": init_rms(cfg.d_model, dt, device=device),
             "ffn": init_ffn(generator, cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind,
                             dtype=dt, device=device)}
        if cross:
            p["ln_x"] = init_rms(cfg.d_model, dt, device=device)
            p["xattn"] = attn()
        return p

    return {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model, dt, device),
        "enc_norm": init_rms(cfg.d_model, dt, device=device),
        "final_norm": init_rms(cfg.d_model, dt, device=device),
        "enc": [block(False) for _ in range(cfg.enc_layers)],
        "dec": [block(True) for _ in range(cfg.dec_layers)],
    }


def params_from_reference(ref: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's tree (``encdec.init``: stacked ``enc`` / ``dec``
    blocks, as numpy arrays) as the port's per-layer dicts."""
    out = {name: tree_to_torch(ref[name], device)
           for name in ("embed", "enc_norm", "final_norm")}
    out["enc"] = unstack_layers(ref["enc"], cfg.enc_layers, device)
    out["dec"] = unstack_layers(ref["dec"], cfg.dec_layers, device)
    return out


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           flash: Optional[Callable] = None) -> torch.Tensor:
    """frames [B, T, d_model] -> memory [B, T, d_model]."""
    spec = _spec(cfg, causal=False)

    def layer(x, p):                                     # positions 0..T-1
        if cfg.shard_activations:
            x = constrain(x, ("batch", "seq", None))
        h, _ = attention(p["attn"], rms_norm(x, p["ln1"], eps=cfg.norm_eps),
                         None, spec, flash=flash)
        x = x + h
        return x + ffn(p["ffn"], rms_norm(x, p["ln2"], eps=cfg.norm_eps),
                       kind=cfg.ffn_kind)

    x = frames.to(cfg.dtype)
    for p in params["enc"]:
        x = remat(cfg, layer, x, p)
    return rms_norm(x, params["enc_norm"], eps=cfg.norm_eps)


def _dec_pass(params: dict, x, positions, memory, cfg: ModelConfig, cache,
              cache_len, flash=None):
    """The decoder layers; ``cache=None`` is the teacher-forced training
    pass (no cache; ``remat`` per layer)."""
    self_spec, cross_spec = _spec(cfg, causal=True), _spec(cfg, causal=False)

    def layer(x, p, kv):
        if cfg.shard_activations:
            x = constrain(x, ("batch", "seq", None))
        h, _ = attention(p["attn"], rms_norm(x, p["ln1"], eps=cfg.norm_eps),
                         positions, self_spec, kv_cache=kv,
                         cache_len=cache_len, flash=flash)
        x = x + h
        h, _ = attention(p["xattn"], rms_norm(x, p["ln_x"], eps=cfg.norm_eps),
                         positions, cross_spec, x_kv=memory, flash=flash)
        x = x + h
        return x + ffn(p["ffn"], rms_norm(x, p["ln2"], eps=cfg.norm_eps),
                       kind=cfg.ffn_kind)

    if cache is None:
        for p in params["dec"]:
            x = remat(cfg, layer, x, p, None)
        return x
    for p, ck, cv in zip(params["dec"], *cache):
        x = layer(x, p, (ck, cv))
    return x


def forward(params: dict, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, *, flash: Optional[Callable] = None):
    """Training: teacher-forced decode over the encoded frames -> (f32
    logits [B, S, V], aux 0)."""
    memory = encode(params, frames, cfg, flash=flash)
    x = _dec_pass(params, embed(params["embed"], tokens), None, memory, cfg, None,
                  None, flash=flash)
    return _head(params, x, cfg), torch.zeros((), device=tokens.device)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig):
    """batch {"tokens", "labels"} [B, S] + {"frames"} [B, T, d] -> (CE,
    {"ce", "aux"})."""
    logits, aux = forward(params, batch["tokens"], batch["frames"], cfg)
    ce = cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    shape = (cfg.dec_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _head(params: dict, x, cfg: ModelConfig) -> torch.Tensor:
    return unembed(params["embed"], rms_norm(x, params["final_norm"], eps=cfg.norm_eps))


def prefill(params: dict, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, cache, *, flash: Optional[Callable] = None):
    """Encode, then the teacher-forced decoder prefill from position 0 ->
    (last-position f32 logits [B, 1, V], cache, memory)."""
    memory = encode(params, frames, cfg, flash=flash)
    x = embed(params["embed"], tokens)
    x = _dec_pass(params, x, None, memory, cfg, cache, 0, flash=flash)
    return _head(params, x[:, -1:], cfg), cache, memory


def decode_step(params: dict, cache, memory: torch.Tensor, tokens: torch.Tensor,
                pos, cfg: ModelConfig, *, flash: Optional[Callable] = None):
    """tokens [B, 1] at ``pos`` (one int, or one per row on the host) ->
    (f32 logits [B, 1, V], cache)."""
    b, s = tokens.shape
    cache_len, positions = decode_positions(pos, b, s, cache[0].shape[2],
                                            tokens.device)
    x = embed(params["embed"], tokens)
    x = _dec_pass(params, x, positions, memory, cfg, cache, cache_len, flash=flash)
    return _head(params, x, cfg), cache
