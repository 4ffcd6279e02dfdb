"""Architecture registry (GraphPi workloads live in `graphpi.py`).

`get_config(arch)` returns the full ModelConfig; `get_smoke_config(arch)`
the reduced same-family variant the CPU tests use.  Counterpart of
`repro/configs/__init__.py` without `input_specs`, which builds JAX
shape stand-ins for the dry-run: the port builds its prompt tensors
directly (`serve/session.py::fake_prompts`).  The config modules are
data only and are copies of the reference's.
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
