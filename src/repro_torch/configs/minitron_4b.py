"""minitron-4b [dense]: pruned nemotron. [arXiv:2407.14679; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256, vocab=512,
)
