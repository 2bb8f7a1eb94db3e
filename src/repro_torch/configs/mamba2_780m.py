"""mamba2-780m [ssm] — 48L d1536 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060; unverified]

d_inner = 2*1536 = 3072, head_dim 64 -> 48 SSD heads.  The long_500k cell
runs natively (constant-size state).  Attention fields are placeholders
(family='ssm' never builds attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,          # unused (attention-free)
    n_kv=1,
    head_dim=1,
    d_ff=0,             # unused: SSD blocks replace FFNs entirely
    vocab=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    sub_quadratic=True,
)
