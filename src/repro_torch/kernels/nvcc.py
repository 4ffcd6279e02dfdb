"""One builder for every hand-written CUDA kernel of the port.

Each source under `kernels/csrc/` is compiled on its own with `nvcc` for
`sm_90a` into a shared library with a plain C interface, at first use,
cached under `build/kernels/` as ``<stem>-<sha256[:16]>.so`` of the
content of the source and of every local header it includes
(``#include "..."``, followed into the headers), and loaded with
`ctypes` once per process.  CUTLASS's headers are on the include path
for the building blocks a kernel may use; no library is linked.
Nothing here runs at import time: the CPU tests import it on machines
with no `nvcc` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

from ..device import build_dir

CUTLASS_INCLUDE = "/usr/local/cutlass/include"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-I{CUTLASS_INCLUDE}")

build_logs: dict[str, str] = {}   # source name -> nvcc/ptxas output of
                                  # the build this process ran
build_seconds: dict[str, float] = {}   # source name -> that build's time
_libs: dict[pathlib.Path, ctypes.CDLL] = {}
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


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


def local_includes(source: pathlib.Path) -> list[pathlib.Path]:
    """`source` and the local headers it includes, recursively, each
    once, in the order first met (resolved beside the including file, as
    nvcc resolves ``#include "..."``).  A named header that is missing
    is left to nvcc to report."""
    seen: list[pathlib.Path] = []
    todo = [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.append(path)
        todo += [(path.parent / name).resolve()
                 for name in _LOCAL_INCLUDE.findall(path.read_text())]
    return seen


def digest_of(source: pathlib.Path) -> str:
    """sha256[:16] over the source and its local headers, so an edit to
    either rebuilds."""
    h = hashlib.sha256()
    for path in local_includes(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def build_library(source: pathlib.Path) -> pathlib.Path:
    """Compile `source` unless a library for this exact content exists;
    returns the library path.  Writes to a temporary name and renames,
    so concurrent builders never load a half-written file."""
    out = build_dir() / f"{source.stem}-{digest_of(source)}.so"
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    build_seconds[source.name] = time.perf_counter() - t0
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
