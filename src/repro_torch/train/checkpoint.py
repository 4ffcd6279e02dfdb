"""Atomic, resumable checkpoints of tensor trees.

Counterpart of `repro/train/checkpoint.py`, with the same layout:

    <dir>/step_<k>/
        manifest.json        tree paths, shapes, dtypes, step
        arr_<i>.npy          one file per leaf (copied to the host)
    <dir>/LATEST             text file → "step_<k>"  (atomic rename)

Trees are nested dicts and lists of tensors.  numpy has no bfloat16, so
a bfloat16 leaf is saved as its raw 16-bit pattern (an int16 view) and
the manifest keeps the real dtype's name; `restore` views it back.  A
reference checkpoint, whose bfloat16 leaves numpy stores as 2-byte
records, restores the same way.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from .tree import flatten, unflatten

_VIEWS = {torch.bfloat16: torch.int16}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save(ckpt_dir: str, step: int, tree) -> str:
    """Atomic: write to tmp dir, fsync manifest, rename, repoint LATEST."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": step, "leaves": []}
    try:
        for i, (p, v) in enumerate(flatten(tree)):
            t = v.detach().cpu()
            arr = t.view(_VIEWS.get(t.dtype, t.dtype)).numpy()
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            manifest["leaves"].append(
                {"path": p, "file": f"arr_{i}.npy",
                 "shape": list(t.shape), "dtype": _dtype_name(t.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(f"step_{step}")
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> int | None:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, tree_like, *, step: int | None = None,
            device="cpu"):
    """Load into the structure of `tree_like` (leaves with `.shape`,
    e.g. tensors) as tensors on `device`.  Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {m["path"]: m for m in manifest["leaves"]}
    out = []
    for p, like in flatten(tree_like):
        m = by_path[p]
        want = getattr(torch, m["dtype"])
        arr = np.load(os.path.join(d, m["file"]))
        if want in _VIEWS:
            arr = arr.view(np.int16)
            t = torch.from_numpy(arr).view(want)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {p}: shape {tuple(t.shape)} "
                             f"!= {tuple(like.shape)}")
        out.append(t.to(device))
    return unflatten(tree_like, out), step
