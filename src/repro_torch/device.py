"""Device resolution, card reports and the kernel build directory.

Takes the place of the reference's `compat.py`, which only smooths
over JAX API drift and so has no counterpart here.

 * `resolve_device` turns the `device=` argument every entry point
   takes into a `torch.device`.  ``"cuda"`` (the default everywhere)
   with no card raises — the port never quietly runs on the CPU; the
   CPU is used only when the caller names it.
 * `gpu_report` reads the card's name and power limit from
   `nvidia-smi`, so every timing can be written down beside them.
 * `build_dir` is where kernels compiled from `kernels/csrc/` land:
   ``<checkout>/build/kernels`` (listed in `.gitignore`).
"""
from __future__ import annotations

import pathlib
import subprocess

import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no card
    is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        # tensors report cuda:N; compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def gpu_report() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, as
    one line (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_dir() -> pathlib.Path:
    """Directory for kernel libraries compiled from the checkout's
    sources (created on demand)."""
    d = REPO_ROOT / "build" / "kernels"
    d.mkdir(parents=True, exist_ok=True)
    return d
