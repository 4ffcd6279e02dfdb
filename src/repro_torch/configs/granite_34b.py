"""granite-34b [dense]: llama-arch code model, MQA (kv=1).
[arXiv:2405.04324; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,          # multi-query attention
    d_ff=24576,
    vocab=49152,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=1, d_ff=256, vocab=512,
)
