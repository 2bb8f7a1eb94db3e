"""zamba2-1.2b [hybrid] — 38L d2048 32H (kv=32, i.e. MHA) d_ff=8192
vocab=32000, ssm_state=64; Mamba2 backbone + SHARED attention block.
[arXiv:2411.15242; hf]

The shared transformer block (attention + MLP, one set of weights) is
re-invoked every ``hybrid_attn_every`` Mamba2 layers — Zamba's
parameter-free global mixing.  38 layers constrain the site spacing to a
divisor of 38 (the Eq. 7/8 divisibility constraint surfacing in model
structure); we use 19 -> 2 shared-attention sites.  Runs long_500k:
SSM state is context-independent; only 2 KV sites carry the long context.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ffn_kind="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    hybrid_attn_every=19,
    sub_quadratic=True,
    grad_accum=8,   # SSD intra-chunk buffers at 1M tokens need microbatching
)
