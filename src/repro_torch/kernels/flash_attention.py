"""Loader and launcher of kernel K4, `csrc/flash_attention.cu`.

Counterpart of `repro/kernels/flash_attention.py::flash_attention_pallas`:
forward attention with an online softmax over q [BH, Sq, hd] and
k, v [BK, Sk, hd], BH % BK == 0 (zero-copy grouped-query attention).
The CUDA source is compiled by `nvcc.build_library` at first use and
bound with `ctypes`.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from . import nvcc

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "flash_attention.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None          # the loaded ctypes library, entry points declared


def build() -> pathlib.Path:
    """Compile K4 unless a library for this exact source exists; returns
    the library path."""
    return nvcc.build_library(SOURCE)


def load():
    """Build (if needed) and load the K4 library once per process."""
    global _lib
    if _lib is None:
        lib = nvcc.load_library(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            vp, vp, vp, vp,                # q k v o
            ci, ci, ci, ci, ci,            # BH BK Sq Sk hd
            ci, ctypes.c_float, ci,        # causal sm_scale dtype
            vp,                            # stream
        ]
        lib.flash_attention_launch.restype = ci
        lib.flash_attention_max_head_dim.argtypes = []
        lib.flash_attention_max_head_dim.restype = ci
        _lib = lib
    return _lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         sm_scale: float | None = None) -> torch.Tensor:
    """Launch K4 on the current stream of `q`'s device.  Inputs are
    validated by `ops.flash_attention_rows`; the output is allocated
    here."""
    lib = load()
    BH, Sq, hd = q.shape
    BK, Sk, _ = k.shape
    if hd > lib.flash_attention_max_head_dim():
        raise ValueError(f"head dim {hd} exceeds the kernel's "
                         f"{lib.flash_attention_max_head_dim()}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        BH, BK, Sq, Sk, hd, int(causal), float(sm_scale), DTYPES[q.dtype],
        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return o
