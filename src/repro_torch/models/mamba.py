"""mamba2-780m — pure SSM LM (attention-free), SSD chunked scan; the port's
copy of the JAX package's ``models/mamba.py``.

Params are a dict of tensors with one dict per layer under ``"blocks"``
(the JAX package stacks them ``[L, ...]`` for ``lax.scan``; here a Python
loop runs the layers).  Entry points:

  forward      — tokens [B, S] -> (logits, aux) over every position
  prefill      — tokens [B, S] -> (last-position logits, state); every
                 layer runs the SSD kernel
  decode_step  — one token per row against the state (the recurrent form)

State, not KV, is the decode cache: a stacked pair, the SSM state
``[L, B, H, P, N]`` in f32 and the conv cache ``[L, B, K-1, conv_dim]`` in
the model's dtype, written in place (the JAX package returns a new one).
``loss_fn`` and training are not ported yet (``get_api``'s ``loss_fn``
raises).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import tree_to_torch, unstack_layers
from repro_torch.nn.embeddings import embed, init_embedding, unembed
from repro_torch.nn.norms import init_rms, rms_norm
from repro_torch.nn.ssm import SSMSpec, init_ssm, ssm_forward

State = Tuple[torch.Tensor, torch.Tensor]


def spec(cfg: ModelConfig) -> SSMSpec:
    return SSMSpec(d_model=cfg.d_model, d_state=cfg.ssm_state,
                   d_conv=cfg.ssm_conv, expand=cfg.ssm_expand,
                   head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk)


def init_block(generator: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    return {"ln": init_rms(cfg.d_model, cfg.dtype, device=device),
            "ssm": init_ssm(generator, spec(cfg), cfg.dtype, device)}


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights drawn on ``device`` from ``generator`` (a generator on
    that device), one tensor at a time."""
    return {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model, cfg.dtype, device),
        "final_norm": init_rms(cfg.d_model, cfg.dtype, device=device),
        "blocks": [init_block(generator, cfg, device) for _ in range(cfg.n_layers)],
    }


def params_from_reference(ref: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's param tree (``mamba.init``: stacked ``[L, ...]``
    blocks, as numpy arrays) as the port's per-layer dicts."""
    return {"embed": tree_to_torch(ref["embed"], device),
            "final_norm": tree_to_torch(ref["final_norm"], device),
            "blocks": unstack_layers(ref["blocks"], cfg.n_layers, device)}


def init_state(cfg: ModelConfig, batch: int, device=None) -> State:
    sp = spec(cfg)
    return (torch.zeros((cfg.n_layers, batch, sp.n_heads, sp.head_dim, sp.d_state),
                        dtype=torch.float32, device=device),
            torch.zeros((cfg.n_layers, batch, sp.d_conv - 1, sp.conv_dim),
                        dtype=cfg.dtype, device=device))


def layer(p: dict, x, cfg: ModelConfig, state=None, decode=False, ssd=None):
    """One residual SSM layer: ``x + ssm(rms_norm(x))``; writes the layer's
    new state into ``state`` (its two [B, ...] slices) in place."""
    y, (s, c) = ssm_forward(p["ssm"], rms_norm(x, p["ln"], eps=cfg.norm_eps),
                            spec(cfg), state=state, decode=decode, ssd=ssd)
    if state is not None:
        state[0].copy_(s)
        state[1].copy_(c)
    return x + y


def _stack_pass(params: dict, x, cfg: ModelConfig, state: Optional[State] = None,
                decode: bool = False, ssd: Optional[Callable] = None):
    for i, p in enumerate(params["blocks"]):
        st = (state[0][i], state[1][i]) if state is not None else None
        x = layer(p, x, cfg, state=st, decode=decode, ssd=ssd)
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            full_logits: bool = True, ssd: Optional[Callable] = None):
    """tokens [B, S] -> (f32 logits, aux loss 0)."""
    x = _stack_pass(params, embed(params["embed"], tokens), cfg, ssd=ssd)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    if not full_logits:
        x = x[:, -1:]
    return unembed(params["embed"], x), torch.zeros((), device=tokens.device)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, state: State,
            *, ssd: Optional[Callable] = None) -> Tuple[torch.Tensor, State]:
    """tokens [B, S] -> (last-position f32 logits [B, 1, V], state).  The
    incoming state's values are not read (a prefill starts from zero);
    ``ssd`` replaces the SSD kernel in every layer."""
    x = _stack_pass(params, embed(params["embed"], tokens), cfg, state=state, ssd=ssd)
    x = rms_norm(x[:, -1:], params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], x), state


def decode_step(params: dict, state: State, tokens: torch.Tensor, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    del pos  # SSM state carries position implicitly
    x = _stack_pass(params, embed(params["embed"], tokens), cfg, state=state,
                    decode=True)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], x), state
