"""Loader and launcher of kernel K4, `csrc/flash_attention.cu`.

Counterpart of `repro/kernels/flash_attention.py::flash_attention_pallas`:
forward attention with an online softmax over q [BH, Sq, hd] and
k, v [BK, Sk, hd], BH % BK == 0 (zero-copy grouped-query attention).
The CUDA source is compiled by `nvcc.build_library` at first use and
bound with `ctypes`.  Nothing here runs at import time.

The source holds two kernels, and a static rule in it
(`flash_attention_variant`) picks one per call: ``wgmma`` (bf16 tiles on
the tensor cores, fed by TMA) for bfloat16 with hd % 8 == 0, ``scalar``
(fp32 FMA) for float32 and for other head dims.  `variant_launches`
counts the launches of each, beside `ops.launches["flash"]`.
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
VARIANTS = ("scalar", "wgmma")           # the C source's variant numbers

variant_launches = dict.fromkeys(VARIANTS, 0)

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
            ci, vp,                        # variant stream
        ]
        lib.flash_attention_launch.restype = ci
        lib.flash_attention_max_head_dim.argtypes = []
        lib.flash_attention_max_head_dim.restype = ci
        lib.flash_attention_variant.argtypes = [ci, ci]
        lib.flash_attention_variant.restype = ci
        _lib = lib
    return _lib


def variant_of(dtype: torch.dtype, hd: int) -> str:
    """The kernel the source's static rule picks for `dtype` and head dim
    `hd` (builds and loads the library)."""
    return VARIANTS[load().flash_attention_variant(DTYPES[dtype], hd)]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         sm_scale: float | None = None,
                         variant: str | None = None) -> torch.Tensor:
    """Launch K4 on the current stream of `q`'s device.  Inputs are
    validated by `ops.flash_attention_rows`; the output is allocated
    here.  `variant` None takes the source's rule (`variant_of`);
    ``"scalar"`` forces the scalar kernel, which chip_smoke.py times in
    bf16 beside the wgmma kernel.  The wgmma kernel's TMA needs every
    pointer 16-byte aligned: it raises otherwise."""
    lib = load()
    BH, Sq, hd = q.shape
    BK, Sk, _ = k.shape
    if hd > lib.flash_attention_max_head_dim():
        raise ValueError(f"head dim {hd} exceeds the kernel's "
                         f"{lib.flash_attention_max_head_dim()}")
    if variant is None:
        variant = variant_of(q.dtype, hd)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    o = torch.empty_like(q)
    if variant == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned, which "
                                 f"the wgmma kernel's TMA loads need")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        BH, BK, Sq, Sk, hd, int(causal), float(sm_scale), DTYPES[q.dtype],
        VARIANTS.index(variant), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({variant}) launch failed: "
                           f"CUDA error {err}")
    variant_launches[variant] += 1
    return o
