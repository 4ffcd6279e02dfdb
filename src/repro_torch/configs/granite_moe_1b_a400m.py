"""granite-moe-1b-a400m [moe]: 32 experts top-8, d_expert=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,              # per-expert hidden width
    vocab=49155,
    n_experts=32,
    top_k=8,
    d_expert=512,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, d_expert=32,
    vocab=128, n_experts=4, top_k=2,
)
