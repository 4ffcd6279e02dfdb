"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution; vision frontend STUB —
backbone receives precomputed patch embeddings. [arXiv:2409.12191; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    mrope=True,
    stub_frontend=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
)
