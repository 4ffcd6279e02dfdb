"""One builder for every hand-written CUDA kernel of the port.

Each source under `kernels/csrc/` is compiled on its own with `nvcc` for
`sm_90a` into a shared library with a plain C interface, at first use,
cached under `build/kernels/` as ``<stem>-<sha256[:16]>.so`` of the
source's content, and loaded with `ctypes` once per process.  Nothing
here runs at import time: the CPU tests import it on machines with no
`nvcc` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

from ..device import build_dir

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

build_logs: dict[str, str] = {}   # source name -> nvcc/ptxas output of
                                  # the build this process ran
_libs: dict[pathlib.Path, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin); CUDA kernels cannot be "
                           "built")
    return path


def build_library(source: pathlib.Path) -> pathlib.Path:
    """Compile `source` unless a library for this exact content exists;
    returns the library path.  Writes to a temporary name and renames,
    so concurrent builders never load a half-written file."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = build_dir() / f"{source.stem}-{digest}.so"
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    build_logs[source.name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {source.name}:\n"
                           f"{build_logs[source.name]}")
    os.replace(tmp, out)
    return out


def load_library(source: pathlib.Path) -> ctypes.CDLL:
    """Build (if needed) and load `source`'s library once per process.
    The caller declares the argument and result types of its entry
    points."""
    if source not in _libs:
        _libs[source] = ctypes.CDLL(str(build_library(source)))
    return _libs[source]
