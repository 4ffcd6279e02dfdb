"""Loader and launcher of kernel K1, `csrc/level_expand.cu`.

Counterpart of `repro/kernels/intersect.py::level_expand_pallas`.  The
CUDA source is compiled with `nvcc` for `sm_90a` into a shared library
with a plain C interface at first use (a few seconds), cached under
`build/kernels/` by the source's content hash, and bound with `ctypes`.
Nothing here runs at import time: the CPU tests import this module on
machines with no `nvcc` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from ..device import build_dir

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "level_expand.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None          # the loaded ctypes library (one per process)
build_log = ""       # nvcc/ptxas output of the build this process ran


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin); K1 cannot be built")
    return nvcc


def build() -> pathlib.Path:
    """Compile K1 unless a library for this exact source exists; returns
    the library path.  Writes to a temporary name and renames, so
    concurrent builders never load a half-written file."""
    global build_log
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = build_dir() / f"level_expand-{digest}.so"
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {SOURCE.name}:\n{build_log}")
    os.replace(tmp, out)
    return out


def load():
    """Build (if needed) and load the K1 library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
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
