"""Config system: one frozen dataclass describes every architecture.

The port's copy of the JAX package's ``configs/base.py``: the same fields
and parameter counts; ``.dtype`` is a torch dtype.  ``get_config(<id>)``
resolves through ``configs.registry`` to one of these; family dispatch
happens in ``models.registry.get_api``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # lm | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int

    ffn_kind: str = "swiglu"     # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 0           # 0: dense; 1: every layer; 2: alternate
    moe_shared: bool = False
    moe_impl: str = "einsum"     # einsum (grouped) | scatter | ragged
    moe_capacity: float = 1.25

    # --- attention pattern (gemma3) ---
    window: int = 0              # sliding-window size for local layers
    global_every: int = 0        # one global layer per N (0 = all global)

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    hybrid_attn_every: int = 0   # zamba2: shared attn block per N ssm layers

    # --- enc-dec ---
    enc_layers: int = 0
    dec_layers: int = 0

    # --- vlm ---
    n_patches: int = 0           # stub frontend: precomputed patch embeds

    # --- execution ---
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"   # full (nothing saveable) | dots (save matmul outputs)
    scan_layers: bool = True
    grad_accum: int = 1          # microbatches per train step
    grad_accum_dtype: str = "float32"  # grok/llama4: bfloat16 on the
                                       # single-pod mesh (f32 fits on 2 pods)
    adam_mu_dtype: str = "float32"   # big archs drop to bfloat16 to fit HBM
    adam_nu_dtype: str = "float32"
    adam_factored: bool = False      # Adafactor-style nu for matrix params
    adam_momentum: bool = True       # False drops mu (Adafactor) — giants only
    q_block: int = 512
    k_block: int = 1024
    sub_quadratic: bool = False  # may run the long_500k cell
    kv_quant: bool = False       # int8 KV cache (per-token/head scales)
    serve_weight_quant: bool = False  # int8 weights on the serve path (lm)
    shard_activations: bool = True  # seq->model on the residual stream
                                    # (Megatron-SP-style stash sharding)

    # -----------------------------------------------------------------
    @property
    def dtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def moe_layers(self) -> int:
        if self.moe_every == 0 or self.moe_experts == 0:
            return 0
        return self.n_layers // self.moe_every

    def window_for_layer(self, i: int) -> int:
        """gemma3 pattern: every ``global_every``-th layer is global (0)."""
        if self.global_every <= 0 or self.window <= 0:
            return 0
        return 0 if (i + 1) % self.global_every == 0 else self.window


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (for MODEL_FLOPS = 6*N*D)."""
    d, f = cfg.d_model, cfg.d_ff
    gated = cfg.ffn_kind in ("swiglu", "geglu")
    ffn_p = (3 if gated else 2) * d * f
    attn_p = d * cfg.n_heads * cfg.head_dim * 2 + d * cfg.n_kv * cfg.head_dim * 2
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)

    if cfg.family == "ssm":
        di = cfg.ssm_expand * d
        nh = di // cfg.ssm_head_dim
        conv_dim = di + 2 * cfg.ssm_state
        per = (d * (2 * di + 2 * cfg.ssm_state + nh)      # in_proj
               + cfg.ssm_conv * conv_dim + conv_dim        # conv
               + di * d + di + 3 * nh)                     # out_proj, norm, A/D/dt
        return cfg.n_layers * per + emb

    if cfg.family == "hybrid":
        ssm_cfg = dataclasses.replace(cfg, family="ssm", vocab=0,
                                      tie_embeddings=True)
        ssm_p = param_count(dataclasses.replace(ssm_cfg, n_layers=cfg.n_layers))
        shared = attn_p + ffn_p   # one shared transformer block
        return ssm_p + shared + emb

    if cfg.family == "encdec":
        enc = cfg.enc_layers * (attn_p + ffn_p)
        dec = cfg.dec_layers * (2 * attn_p + ffn_p)   # self + cross
        return enc + dec + emb

    # lm / vlm
    n_moe = cfg.moe_layers
    n_dense = cfg.n_layers - n_moe
    moe_p = n_moe * (cfg.moe_experts * ffn_p + d * cfg.moe_experts
                     + (ffn_p if cfg.moe_shared else 0))
    return (cfg.n_layers * attn_p + n_dense * ffn_p + moe_p + emb)


def active_param_count(cfg: ModelConfig) -> int:
    """Activated parameters per token (MoE: only top_k experts count)."""
    if cfg.moe_layers == 0:
        return param_count(cfg)
    d, f = cfg.d_model, cfg.d_ff
    gated = cfg.ffn_kind in ("swiglu", "geglu")
    ffn_p = (3 if gated else 2) * d * f
    inactive = cfg.moe_layers * (cfg.moe_experts - cfg.moe_top_k) * ffn_p
    return param_count(cfg) - inactive
