"""Model / run configuration dataclasses shared by every architecture."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0              # 0 for attention-free families
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0             # 0 → d_model // n_heads
    qk_norm: bool = False
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0             # expert hidden width (d_ff used if 0)
    moe_every: int = 1            # MoE replaces MLP every k-th layer
    capacity_factor: float = 1.25

    # --- SSM / hybrid (mamba2, jamba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    attn_every: int = 0           # attention layer every k-th layer (jamba 1:8)

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0

    # --- VLM ---
    mrope: bool = False           # 3-component M-RoPE (qwen2-vl)
    stub_frontend: bool = False   # modality frontend stubbed: embeds as input

    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"       # compute dtype; params are fp32 masters

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and not self.d_expert:
            object.__setattr__(self, "d_expert", self.d_ff)

    @property
    def d_inner(self) -> int:     # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced variant for smoke tests (same family/topology knobs)."""
        return replace(self, **kw)

    # ------------------------------------------------------- param counting
    def param_count(self) -> int:
        """Approximate total parameters (embedding included)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d
        def attn() -> int:
            return d * H * hd + 2 * d * K * hd + H * hd * d
        def dense_mlp() -> int:
            return 3 * d * ff
        def moe_mlp() -> int:
            return self.n_experts * 3 * d * self.d_expert + d * self.n_experts
        def mamba() -> int:
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            inp = d * (2 * di + 2 * ds + nh)
            conv = self.conv_width * (di + 2 * ds)
            out = di * d
            return inp + conv + out + 2 * nh + di
        for i in range(L):
            is_attn = (
                self.family in ("dense", "moe", "encdec", "vlm")
                or (self.attn_every and (i % self.attn_every == self.attn_every - 1))
            )
            total += attn() if is_attn else (mamba() if self.ssm_state else attn())
            if self.n_experts and (i % self.moe_every == self.moe_every - 1):
                total += moe_mlp()
            elif ff:
                total += dense_mlp()
        if self.enc_layers:
            total += self.enc_layers * (attn() + dense_mlp())
            total += L * attn()  # decoder cross-attention
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        moe_layers = len(
            [i for i in range(L) if i % self.moe_every == self.moe_every - 1]
        )
        all_experts = moe_layers * self.n_experts * 3 * d * self.d_expert
        active = moe_layers * self.top_k * 3 * d * self.d_expert
        return full - all_experts + active


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
