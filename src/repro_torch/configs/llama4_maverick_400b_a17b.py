"""llama4-maverick-400b-a17b [moe] — 48L d5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

MoE on every SECOND layer + one shared expert — required to reconcile the
assigned dims with 400B total / 17B active:
  routed  24 * 128 * 3*5120*8192 = 386.5B
  shared  24 * 3*5120*8192       =   3.0B
  dense   24 * 3*5120*8192       =   3.0B
  attn    48 * 62.9M             =   3.0B
  embed   202048 * 5120          =   1.0B (tied)     => ~397B / ~17B active
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="lm",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    ffn_kind="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    moe_experts=128,
    moe_top_k=1,
    moe_every=2,
    moe_shared=True,
    serve_weight_quant=True,  # E1: int8 weights (decode is weight-read-bound)
    moe_capacity=1.0,   # A4: aux-loss-balanced capacity (grok-style)
    grad_accum=8,
    grad_accum_dtype="bfloat16",  # f32 accumulation fits on the 2-pod mesh
    adam_mu_dtype="bfloat16",
    adam_nu_dtype="bfloat16",
    adam_factored=True,
    adam_momentum=False,  # Adafactor regime: no first moment at 314B+/16GB
)
