"""Loader and launcher of kernels K2 and K3, `csrc/membership.cu`.

Counterpart of `repro/kernels/intersect.py::membership_pallas` (K2) and
`::intersect_count_pallas` (K3): membership of each candidate in its
row of a stacked, sorted [B, L] neighbour array, as a mask or as a row
count.  The CUDA source is compiled by `nvcc.build_library` at first use
and bound with `ctypes`.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from . import nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "membership.cu"
TILE = 4096          # int32 entries of a row staged in shared memory at once

_lib = None          # the loaded ctypes library, entry points declared


def build() -> pathlib.Path:
    """Compile K2/K3 unless a library for this exact source exists;
    returns the library path."""
    return nvcc.build_library(SOURCE)


def load():
    """Build (if needed) and load the K2/K3 library once per process."""
    global _lib
    if _lib is None:
        lib = nvcc.load_library(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.membership_launch.argtypes = [
            vp, vp,                        # cand nbr
            ci, ci, ci, ci, ci,            # B D L tile count
            vp, vp,                        # out stream
        ]
        lib.membership_launch.restype = ci
        lib.membership_max_tile.argtypes = []
        lib.membership_max_tile.restype = ci
        _lib = lib
    return _lib


def membership_cuda(cand: torch.Tensor, nbr: torch.Tensor, *, count: bool,
                    tile: int = TILE) -> torch.Tensor:
    """Launch K2 (`count=False`: bool [B, D]) or K3 (`count=True`: int32
    [B]) on the current stream of `cand`'s device.  Inputs are int32,
    contiguous and padded by `ops.sorted_membership` /
    `ops.intersect_count`; `tile` is the shared-memory tile width (the
    result does not depend on it).  The output is allocated here."""
    lib = load()
    B, D = cand.shape
    L = nbr.shape[1]
    if not 1 <= tile <= lib.membership_max_tile():
        raise ValueError(f"tile {tile} outside 1..{lib.membership_max_tile()}")
    if count:
        out = torch.empty((B,), dtype=torch.int32, device=cand.device)
    else:
        out = torch.empty((B, D), dtype=torch.bool, device=cand.device)
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    err = lib.membership_launch(cand.data_ptr(), nbr.data_ptr(), B, D, L,
                                int(tile), int(count), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"membership launch failed: CUDA error {err}")
    return out
