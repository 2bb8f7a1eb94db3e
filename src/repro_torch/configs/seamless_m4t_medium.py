"""seamless-m4t-medium [audio] — 12L d1024 16H (kv=16) d_ff=4096
vocab=256206, enc-dec, multimodal.  [arXiv:2308.11596; hf]

Backbone only per the task spec: 12 encoder + 12 decoder layers; the
speech frontend is a STUB (input_specs supplies precomputed frame
embeddings [B, T, 1024]).  Decoder adds cross-attention.  The enc->dec
rate drop is the showcase for rate-aware chip allocation
(core.stage_partition) in serving.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,          # enc + dec (bookkeeping; families use enc/dec)
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    ffn_kind="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
