"""deepseek-coder-33b [dense] — 62L d7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch.  [arXiv:2401.14196; hf]

Params: 62*(3*7168*19200 + 117.5M attn) + 0.46B embed ~= 33.4B.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="lm",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    ffn_kind="swiglu",
    rope_theta=100_000.0,
    tie_embeddings=False,
    kv_quant=True,   # D1: int8 KV (decode roofline is KV-read-bound)
    grad_accum=4,
)
