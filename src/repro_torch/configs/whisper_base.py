"""whisper-base [audio]: enc-dec transformer backbone, conv frontend STUB.
[arXiv:2212.04356; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,            # decoder layers
    enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,          # assignment: GQA kv=8 (== MHA at 8 heads)
    d_ff=2048,
    vocab=51865,
    stub_frontend=True,    # input_specs provides frame embeddings
    rope_theta=10_000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128,
)
