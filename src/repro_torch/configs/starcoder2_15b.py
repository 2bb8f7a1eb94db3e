"""starcoder2-15b [dense] — 40L d6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GQA + RoPE.  [arXiv:2402.19173; hf]

Non-gated GELU FFN (2 matrices): 40*2*6144*24576 = 12.1B + attn 3.3B +
embed 0.6B ~= 16B.  QKV bias per the released config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="lm",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=4,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    ffn_kind="gelu",
    qkv_bias=True,
    rope_theta=100_000.0,
    tie_embeddings=False,
    kv_quant=True,   # D1: int8 KV (decode roofline is KV-read-bound)
    grad_accum=4,
)
