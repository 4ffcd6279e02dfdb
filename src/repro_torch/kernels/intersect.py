"""Loader and launchers of kernel K1, `csrc/level_expand.cu`.

Counterpart of `repro/kernels/intersect.py::level_expand_pallas`:
`level_expand_cuda` over a gathered candidate window (every mode; the
executor's mask mode), `level_rows_cuda` over candidate rows read from
their CSR offsets (count and signed mode).  The CUDA source is compiled
by `nvcc.build_library` at first use (a few seconds), cached under
`build/kernels/` by the source's content hash, and bound with
`ctypes`.  Nothing here runs at import time: the CPU
tests import this module on machines with no `nvcc` and no card.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from . import nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "level_expand.cu"

TILE_PER_LANE = 32   # int32 a row-sourced group stages per lane and buffer

_lib = None          # the loaded ctypes library, entry points declared


def build() -> pathlib.Path:
    """Compile K1 unless a library for this exact source exists; returns
    the library path."""
    return nvcc.build_library(SOURCE)


def load():
    """Build (if needed) and load the K1 library once per process."""
    global _lib
    if _lib is None:
        lib = nvcc.load_library(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.level_expand_launch.argtypes = [
            vp, vp, vp, vp, vp, vp,        # cand valid flat starts lens extra
            vp, ci,                        # dirs (host), n_dirs
            ci, ci, ci, ci,                # B D P window
            ci, ci,                        # count neg_from
            vp, vp,                        # out stream
        ]
        lib.level_expand_launch.restype = ci
        lib.level_expand_max_dirs.argtypes = []
        lib.level_expand_max_dirs.restype = ci
        lib.level_rows_launch.argtypes = [
            vp, vp, vp,                    # csrc cstart clen
            vp, vp, vp,                    # flat starts lens
            vp, vp, vp,                    # own extra neg
            vp, ci,                        # dirs (host), n_dirs
            ci, ci, ci, ci, ci,            # B P Q width window
            ci, ci, ci,                    # group tile_per_lane max_blocks
            vp, vp,                        # out stream
        ]
        lib.level_rows_launch.restype = ci
        lib.level_rows_max_preds.argtypes = []
        lib.level_rows_max_preds.restype = ci
        lib.level_rows_group.argtypes = [ci]
        lib.level_rows_group.restype = ci
        _lib = lib
    return _lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def level_expand_cuda(cand, flat, starts, lens, extra, cand_valid, *,
                      dirs: tuple, count: bool, neg_from: int | None,
                      window: int) -> torch.Tensor:
    """Launch K1 on the current stream of `cand`'s device.  Inputs are
    validated by `ops.level_expand`; outputs are allocated here."""
    lib = load()
    B, D = cand.shape
    P = starts.shape[0]
    n_dirs = len(dirs)
    if n_dirs > lib.level_expand_max_dirs():
        raise ValueError(f"{n_dirs} comparisons exceed the kernel's "
                         f"{lib.level_expand_max_dirs()}")
    if count:
        out = torch.empty((B,), dtype=torch.int32, device=cand.device)
    else:
        out = torch.empty((B, D), dtype=torch.bool, device=cand.device)
    dirs_arr = (ctypes.c_int * max(n_dirs, 1))(*dirs)
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    err = lib.level_expand_launch(
        _ptr(cand), _ptr(cand_valid), _ptr(flat), _ptr(starts), _ptr(lens),
        _ptr(extra) if n_dirs else None, dirs_arr, n_dirs,
        B, D, P, int(window), int(count),
        int(neg_from) if neg_from is not None else 2**31 - 1,
        _ptr(out), stream)
    if err != 0:
        raise RuntimeError(f"level_expand launch failed: CUDA error {err}")
    return out


def level_rows_cuda(csrc, cstart, clen, flat, starts, lens, own, extra, neg,
                    *, dirs: tuple, width: int, window: int, group: int = 0,
                    tile_per_lane: int = TILE_PER_LANE,
                    max_blocks: int = 0) -> torch.Tensor:
    """Launch K1's row-sourced count / signed kernel on the current
    stream of `csrc`'s device; int32 [B] out.  Inputs are validated by
    `ops.level_expand_rows`.  `group` (0: the source's rule by `width`;
    else 8, 32 or 256 threads per frontier row), `tile_per_lane`
    and `max_blocks` (> 0 caps the grid) shape the launch, never the
    result."""
    lib = load()
    P, B = starts.shape
    Q = 0 if neg is None else neg.shape[1]
    n_dirs = len(dirs)
    if n_dirs > lib.level_expand_max_dirs():
        raise ValueError(f"{n_dirs} comparisons exceed the kernel's "
                         f"{lib.level_expand_max_dirs()}")
    if P > lib.level_rows_max_preds():
        raise ValueError(f"{P} predecessors exceed the kernel's "
                         f"{lib.level_rows_max_preds()}")
    out = torch.empty((B,), dtype=torch.int32, device=csrc.device)
    dirs_arr = (ctypes.c_int * max(n_dirs, 1))(*dirs)
    stream = torch.cuda.current_stream(csrc.device).cuda_stream
    err = lib.level_rows_launch(
        _ptr(csrc), _ptr(cstart), _ptr(clen), _ptr(flat), _ptr(starts),
        _ptr(lens), _ptr(own), _ptr(extra) if n_dirs else None,
        _ptr(neg) if Q else None, dirs_arr, n_dirs, B, P, Q, int(width),
        int(window), int(group), int(tile_per_lane), int(max_blocks),
        _ptr(out), stream)
    if err != 0:
        raise RuntimeError(f"level_rows launch failed: CUDA error {err}")
    return out
