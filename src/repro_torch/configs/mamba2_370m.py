"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                # attention-free, MLP-free (mamba blocks only)
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16,
)
