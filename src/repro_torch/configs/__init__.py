"""Architecture registry (GraphPi workloads live in `graphpi.py`).

`get_config(arch)` returns the full ModelConfig; `get_smoke_config(arch)`
the reduced same-family variant the CPU tests use; `input_specs(cfg,
shape)` the batch's stand-ins as `meta` tensors (shapes and dtypes, no
storage), as the reference's `ShapeDtypeStruct`s.  Counterpart of
`repro/configs/__init__.py`.  The config modules are data only and are
copies of the reference's.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeConfig

ARCHS = [
    "whisper-base",
    "granite-moe-1b-a400m",
    "moonshot-v1-16b-a3b",
    "minitron-4b",
    "granite-34b",
    "qwen3-4b",
    "qwen3-1.7b",
    "jamba-v0.1-52b",
    "mamba2-370m",
    "qwen2-vl-72b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE


def supported_shapes(arch: str) -> list[str]:
    """Shape cells this arch runs; long_500k only for sub-quadratic
    families (DESIGN.md §4)."""
    cfg = get_config(arch)
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        shapes.append("long_500k")
    return shapes


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, batch=None):
    """`meta` tensors standing in for every model input of this cell:
    {"tokens" | "embeds" (+ "positions3"), ["enc_embeds"], ["labels"]}
    for train and prefill, {"tokens" [B, 1]} for decode.  Tokens and
    positions are int32, frame and patch embeddings bfloat16, as in the
    reference.  They allocate nothing."""
    import torch

    B = batch if batch is not None else shape.global_batch
    S = shape.seq_len

    def spec(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch_d = {}
        if cfg.stub_frontend and cfg.family == "vlm":
            batch_d["embeds"] = spec((B, S, cfg.d_model), torch.bfloat16)
            batch_d["positions3"] = spec((B, 3, S))
        else:
            batch_d["tokens"] = spec((B, S))
        if cfg.family == "encdec":
            batch_d["enc_embeds"] = spec((B, S, cfg.d_model), torch.bfloat16)
        if shape.kind == "train":
            batch_d["labels"] = spec((B, S))
        return batch_d
    # decode: one new token against a seq_len cache
    return {"tokens": spec((B, 1))}
