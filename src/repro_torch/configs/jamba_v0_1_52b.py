"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave, 16-expert MoE
every other layer. [arXiv:2403.19887; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,          # 1 attention : 7 mamba
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
)

SMOKE = CONFIG.scaled(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, d_expert=128,
    vocab=256, n_experts=4, top_k=2, ssm_state=8, ssm_head_dim=16,
    ssm_chunk=16,
)
