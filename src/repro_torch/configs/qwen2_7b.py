"""qwen2-7b [dense] — 28L d3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
GQA + QKV bias.  [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="lm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    ffn_kind="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    kv_quant=True,   # D1: int8 KV (decode roofline is KV-read-bound)
    grad_accum=2,
)
