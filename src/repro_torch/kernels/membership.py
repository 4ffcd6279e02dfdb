"""Loader and launcher of kernels K2 and K3, `csrc/membership.cu`.

Counterpart of `repro/kernels/intersect.py::membership_pallas` (K2) and
`::intersect_count_pallas` (K3): membership of each candidate in its
row of a stacked, sorted [B, L] neighbour array, as a mask or as a row
count.  The CUDA source is compiled by `nvcc.build_library` at first use
and bound with `ctypes`.  Nothing here runs at import time.

The source holds two kernels.  `membership_cuda` launches the padded
kernel (rows double-buffered in shared memory at slot(i) = i + (i >> 5)
+ (i >> 10), the ragged contract read in the kernel); `ops.sorted_membership`
and `ops.intersect_count` always take it.  `membership_linear_cuda`
launches the first version (a block per row, a linear shared tile,
inputs padded by the caller), which only side-by-side timings and card
tests call.  `kernel_launches` counts the launches of each.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from . import nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "membership.cu"
TILE = 16384         # int32 entries of a row staged in shared memory at once
LINEAR_TILE = 4096   # the same for the first version
KERNELS = ("padded", "linear")

kernel_launches = dict.fromkeys(KERNELS, 0)

_lib = None          # the loaded ctypes library, entry points declared
_max_tile = {}       # kernel -> its largest tile, asked once at load


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
            vp, vp, vp, vp,                # cand nbr nbr_len valid
            ci, ci, ci, ci, ci, ci,        # B D L tile count group
            vp, vp,                        # out stream
        ]
        lib.membership_launch.restype = ci
        lib.membership_linear_launch.argtypes = [
            vp, vp,                        # cand nbr
            ci, ci, ci, ci, ci,            # B D L tile count
            vp, vp,                        # out stream
        ]
        lib.membership_linear_launch.restype = ci
        for name in ("membership_max_tile", "membership_linear_max_tile"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ci
        lib.membership_group.argtypes = [ci]
        lib.membership_group.restype = ci
        _max_tile["padded"] = lib.membership_max_tile()
        _max_tile["linear"] = lib.membership_linear_max_tile()
        _lib = lib
    return _lib


def group_of(L: int) -> int:
    """Threads per row the source's static rule gives rows of L entries
    (32: a warp, 256: a block; builds and loads the library)."""
    return load().membership_group(int(L))


def _output(cand, count):
    B, D = cand.shape
    if count:
        return torch.empty((B,), dtype=torch.int32, device=cand.device)
    return torch.empty((B, D), dtype=torch.bool, device=cand.device)


def _check_tile(kernel, tile):
    if not 1 <= tile <= _max_tile[kernel]:
        raise ValueError(f"tile {tile} outside 1..{_max_tile[kernel]}")


def membership_cuda(cand: torch.Tensor, nbr: torch.Tensor,
                    nbr_len: torch.Tensor | None = None,
                    cand_valid: torch.Tensor | None = None, *, count: bool,
                    tile: int = TILE, group: int = 0) -> torch.Tensor:
    """Launch K2 (`count=False`: bool [B, D]) or K3 (`count=True`: int32
    [B]) on the current stream of `cand`'s device, with the padded
    kernel.  cand int32 [B, D] and nbr int32 [B, L] contiguous; nbr_len
    int32 [B] (clamped to [0, L] in the kernel) and cand_valid bool
    [B, D] contiguous, or None (inputs validated by `ops`).  `tile` is
    the shared-memory tile width, `group` forces a warp (32) or a block
    (256) per row (0: the source's rule; the launch refuses others);
    the result depends on neither.  A pointer that is not
    16-byte aligned, or D % 4 != 0, takes the kernel's 4-byte path.  The
    output is allocated here."""
    lib = load()
    B, D = cand.shape
    L = nbr.shape[1]
    _check_tile("padded", tile)
    out = _output(cand, count)
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    err = lib.membership_launch(
        cand.data_ptr(), nbr.data_ptr(),
        None if nbr_len is None else nbr_len.data_ptr(),
        None if cand_valid is None else cand_valid.data_ptr(),
        B, D, L, int(tile), int(count), int(group), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"membership launch failed: CUDA error {err}")
    kernel_launches["padded"] += 1
    return out


def membership_linear_cuda(cand: torch.Tensor, nbr: torch.Tensor, *,
                           count: bool,
                           tile: int = LINEAR_TILE) -> torch.Tensor:
    """The first version of K2/K3, for side-by-side timing: inputs int32,
    contiguous and already padded (`ops._stacked_rows`); otherwise as
    `membership_cuda`."""
    lib = load()
    B, D = cand.shape
    L = nbr.shape[1]
    _check_tile("linear", tile)
    out = _output(cand, count)
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    err = lib.membership_linear_launch(cand.data_ptr(), nbr.data_ptr(), B,
                                       D, L, int(tile), int(count),
                                       out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"membership (linear) launch failed: CUDA error "
                           f"{err}")
    kernel_launches["linear"] += 1
    return out
