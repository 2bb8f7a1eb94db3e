"""internvl2-2b [vlm] — 24L d2048 16H (GQA kv=8) d_ff=8192 vocab=92553,
InternViT + InternLM2.  [arXiv:2404.16821; hf]

Backbone = InternLM2-1.8B-style causal LM.  The InternViT-300M frontend
is a STUB per the task spec: input_specs supplies 256 precomputed patch
embeddings [B, 256, 2048] (post-projector), concatenated ahead of the
text tokens.  Decode shapes treat the image as KV-cache prefix.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    ffn_kind="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    n_patches=256,
    serve_weight_quant=True,  # E1: int8 weights (decode is weight-read-bound)
)
