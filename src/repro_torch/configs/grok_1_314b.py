"""grok-1-314b [moe] — 64L d6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2 every layer.  [hf:xai-org/grok-1; unverified]

Param check: experts 64*8*3*6144*32768 = 309.2B + attn 5.6B + embed 1.6B
~= 316B (vs 314B nominal).  Adam moments in bf16 + grad accumulation keep
the train_4k cell inside 16 GB/chip on the 256-chip pod (see dry-run).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="lm",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    ffn_kind="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    moe_experts=8,
    moe_top_k=2,
    moe_every=1,
    serve_weight_quant=True,  # E1: int8 weights (decode is weight-read-bound)
    moe_capacity=1.0,   # grok routes capacity-free; aux-loss balanced
    grad_accum=16,
    grad_accum_dtype="bfloat16",  # f32 accumulation fits on the 2-pod mesh
    adam_mu_dtype="bfloat16",
    adam_nu_dtype="bfloat16",
    adam_factored=True,
    adam_momentum=False,  # Adafactor regime: no first moment at 314B+/16GB
)
