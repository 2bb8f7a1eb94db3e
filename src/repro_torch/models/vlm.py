"""internvl2-2b backbone: an InternLM2-style causal LM behind a stub
vision tower; the port's copy of the JAX package's ``models/vlm.py``.

The frontend is a stub: the caller supplies precomputed patch embeddings
``[B, n_patches, d_model]`` (InternViT's output after the projector),
which are concatenated ahead of the text embeddings; everything after
that is ``models/lm.py``.  The image lives in the KV cache after the
prefill, so decode is the LM's decode at ``pos = n_patches + text
length``.  The params are the LM's, int8 (``serve_weight_quant``) or not.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.nn.embeddings import embed, unembed
from repro_torch.nn.norms import rms_norm

init = lm.init                    # the vision tower is stubbed
init_cache = lm.init_cache
decode_step = lm.decode_step      # decode never sees the patches
params_from_reference = lm.params_from_reference


def _merge(params: dict, tokens: torch.Tensor, patches: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """[B, St] tokens + [B, Np, d] patches -> [B, Np + St, d] embeddings."""
    tok_x = embed(lm._table(params, "embed", cfg), tokens)
    return torch.cat([patches.to(tok_x.dtype), tok_x], dim=1)


def forward(params: dict, tokens: torch.Tensor, patches: torch.Tensor,
            cfg: ModelConfig, *, full_logits: bool = True,
            flash: Optional[Callable] = None):
    """Patches then tokens, from position 0 -> (f32 logits over every
    position [B, Np + St, V], aux summed over the MoE layers).  The head is
    the ``embed`` table, as in the JAX package's ``vlm.forward``."""
    x, aux = lm.layer_groups(params, _merge(params, tokens, patches, cfg), cfg,
                             flash=flash)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    if not full_logits:
        x = x[:, -1:]
    return unembed(params["embed"], x), aux


def loss_fn(params: dict, batch: dict, cfg: ModelConfig):
    """CE on the text region only (the labels are text-aligned) + 0.01 aux:
    batch {"tokens", "labels"} [B, St], {"patches"} [B, Np, d].  The patch
    positions take label -1, which the CE masks, rather than the logits a
    slice: logits sharded along the sequence would be gathered whole on
    every rank to be sliced (internvl2-2b's train_4k: [16, 3840, 92553] f32
    a rank on 16 x 16, 116.5 GB at the peak)."""
    logits, aux = forward(params, batch["tokens"], batch["patches"], cfg)
    labels = batch["labels"]
    pad = torch.full((labels.shape[0], cfg.n_patches), -1, dtype=labels.dtype,
                     device=labels.device)
    ce = lm.cross_entropy(logits, torch.cat([pad, labels], dim=1))
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def prefill(params: dict, tokens: torch.Tensor, patches: torch.Tensor,
            cfg: ModelConfig, cache, *, flash: Optional[Callable] = None):
    """Patches then tokens, from position 0, into empty caches ->
    (last-position f32 logits [B, 1, V], caches)."""
    x = _merge(params, tokens, patches, cfg)
    x, cache = lm._serve_pass(params, x, None, cache, 0, cfg, flash=flash)
    x = rms_norm(x[:, -1:], params["final_norm"], eps=cfg.norm_eps)
    return unembed(lm._table(params, "embed", cfg), x), cache
