"""gemma3-1b [dense] — 26L d1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global attention, 128k-context design.
[hf:google/gemma-3-1b-pt; unverified]

head_dim=256 (gemma3 convention: 4 heads * 256 = 1024 != d_model — the
attention output projection maps 1024 -> 1152).  window=512 for local
layers; every 6th layer is global.  Runs the long_500k cell: local layers
are O(window), the few global layers carry the full KV (kv=1 head keeps
that cheap) — see DESIGN.md §Shape-cell skips.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="lm",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    ffn_kind="geglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    window=512,
    global_every=6,
    sub_quadratic=True,
    grad_accum=1,
)
