"""``get_config(<id>)`` resolution + reduced configs for CPU tests (the
port's copy of the JAX package's ``configs/registry.py``)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ModelConfig
from .grok_1_314b import CONFIG as GROK
from .llama4_maverick_400b_a17b import CONFIG as LLAMA4
from .deepseek_coder_33b import CONFIG as DEEPSEEK
from .gemma3_1b import CONFIG as GEMMA3
from .starcoder2_15b import CONFIG as STARCODER2
from .qwen2_7b import CONFIG as QWEN2
from .zamba2_1p2b import CONFIG as ZAMBA2
from .mamba2_780m import CONFIG as MAMBA2
from .seamless_m4t_medium import CONFIG as SEAMLESS
from .internvl2_2b import CONFIG as INTERNVL2

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (GROK, LLAMA4, DEEPSEEK, GEMMA3, STARCODER2, QWEN2, ZAMBA2,
              MAMBA2, SEAMLESS, INTERNVL2)
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def reduced(cfg: ModelConfig, *, layers: int = 4, d_model: int = 64,
            vocab: int = 256) -> ModelConfig:
    """Same family/structure, tiny dims — for CPU smoke tests.

    Keeps every structural trait (GQA ratio, MoE interleave, window
    pattern, shared-attention spacing, enc/dec split) while shrinking
    width, depth and tables.
    """
    n_kv = max(1, min(cfg.n_kv, 2))
    n_heads = max(n_kv, min(cfg.n_heads, 4))
    n_heads = (n_heads // n_kv) * n_kv or n_kv
    head_dim = 16 if cfg.head_dim > 1 else 1
    kw = dict(
        n_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv=n_kv,
        head_dim=head_dim,
        d_ff=0 if cfg.d_ff == 0 else d_model * 2,
        vocab=vocab,
        param_dtype="float32",
        grad_accum=1,
        q_block=64,
        k_block=64,
        kv_quant=False,   # exactness tests; quant fidelity has its own test
    )
    if cfg.moe_experts:
        kw.update(moe_experts=4, moe_top_k=min(cfg.moe_top_k, 2))
        if cfg.moe_every == 2 and layers % 2:
            kw["n_layers"] = layers + 1
    if cfg.global_every:
        kw.update(global_every=2, window=8)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        kw.update(hybrid_attn_every=2)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, dec_layers=2, n_layers=4)
    if cfg.family == "vlm":
        kw.update(n_patches=8)
    return dataclasses.replace(cfg, **kw)
