"""Loader and launchers of kernel K1, `csrc/level_expand.cu`.

Counterpart of `repro/kernels/intersect.py::level_expand_pallas`:
`level_expand_cuda` over a gathered candidate window (every mode; K1's
reference-shaped entry), `level_rows_cuda` over candidate rows read from
their CSR offsets (count and signed mode), and `level_compact_cuda`,
mask mode with the level's stream compaction (the rows' survivors
written to the next frontier in the kernel).  The CUDA source is compiled
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

# Kernels launched by `level_compact_cuda`, one count per kernel as the
# launcher reports it launched: the row counts (`level_rows_kernel`),
# their scan and the emit pass.
compact_launches = {"rows": 0, "scan": 0, "emit": 0}


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
        lib.level_compact_launch.argtypes = [
            vp, vp, vp,                    # csrc cstart clen
            vp, vp, vp,                    # flat starts lens
            vp, vp,                        # own extra
            vp, ci,                        # dirs (host), n_dirs
            ci, ci, ci, ci,                # B P width window
            vp, vp, ctypes.c_longlong,     # rows offset C
            vp, vp, vp, vp,                # cnt base parent newcol
            ci, ci, ci,                    # group tile_per_lane max_blocks
            vp, ctypes.POINTER(ci),        # stream, launched (host)
        ]
        lib.level_compact_launch.restype = ci
        lib.level_compact_group.argtypes = [ci]
        lib.level_compact_group.restype = ci
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


def level_compact_cuda(csrc, cstart, clen, flat, starts, lens, own, extra,
                       rows, offset, parent, newcol, *, dirs: tuple,
                       width: int, window: int, group: int = 0,
                       tile_per_lane: int = TILE_PER_LANE,
                       max_blocks: int = 0) -> None:
    """Launch K1's mask-and-compact passes on the current stream of
    `csrc`'s device: the surviving (rows[b], candidate) pairs written to
    `parent` / `newcol` behind `offset`, which advances by their total
    (all in place).  Inputs are validated by `ops.level_expand_compact`;
    the scratch (row counts, their scan) is allocated here.  `group`
    (0: the source's mask rule by `width`, `level_compact_group`; else
    8, 32 or 256), `tile_per_lane` and `max_blocks` shape both search
    passes as in `level_rows_cuda`, never the result."""
    lib = load()
    P, B = starts.shape
    n_dirs = len(dirs)
    if n_dirs > lib.level_expand_max_dirs():
        raise ValueError(f"{n_dirs} comparisons exceed the kernel's "
                         f"{lib.level_expand_max_dirs()}")
    if P > lib.level_rows_max_preds():
        raise ValueError(f"{P} predecessors exceed the kernel's "
                         f"{lib.level_rows_max_preds()}")
    dev = csrc.device
    cnt = torch.empty((B,), dtype=torch.int32, device=dev)
    base = torch.empty((B + 1,), dtype=torch.int64, device=dev)
    dirs_arr = (ctypes.c_int * max(n_dirs, 1))(*dirs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    err = lib.level_compact_launch(
        _ptr(csrc), _ptr(cstart), _ptr(clen), _ptr(flat), _ptr(starts),
        _ptr(lens), _ptr(own), _ptr(extra) if n_dirs else None, dirs_arr,
        n_dirs, B, P, int(width), int(window), _ptr(rows), _ptr(offset),
        parent.shape[0] - 1, _ptr(cnt), _ptr(base), _ptr(parent),
        _ptr(newcol), int(group), int(tile_per_lane), int(max_blocks),
        stream, ctypes.byref(launched))
    for k in list(compact_launches)[:launched.value]:
        compact_launches[k] += 1
    if err != 0:
        raise RuntimeError(f"level_compact launch failed: CUDA error {err}")
