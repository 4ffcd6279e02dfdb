# Checkpoints (the serving session resumes from them).
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

Elastic resharding, as the reference's `restore(..., shardings=)`:
under a grid (`save` / `restore` with `pieces=`, a tree of
`parallel.sharding.Piece` like the tree, and `grid=`) every leaf is
written whole, gathered from the ranks' pieces one leaf at a time (so
the host holds one whole leaf), by rank 0 after the gathers and
before a barrier; `restore` reads each whole leaf memory-mapped and
keeps the rank's piece of it.  So a run written under one grid resumes
under any other, or on one device, and one device's checkpoint
resumes under a grid.  With `cfg=`, `restore` also reads a checkpoint
of the reference's train state, whose layers are stacked for its scan
(`blocks/l<j>` with a leading [n_blocks] axis; `encoder`, `cross`).
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


def save(ckpt_dir: str, step: int, tree, *, pieces=None, grid=None) -> str:
    """Atomic: write to tmp dir, fsync manifest, rename, repoint LATEST.
    Under `grid` (with `pieces`) a collective over the grid: rank 0
    writes the gathered leaves, and every rank returns once the step is
    in place (a rank that fails leaves no step behind: rank 0's
    gathers raise and its temporary directory goes)."""
    from ..parallel.sharding import Piece

    writer = grid is None or grid.rank == 0
    final = os.path.join(ckpt_dir, f"step_{step}")
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": step, "leaves": []}
    cuts = {} if pieces is None else dict(flatten(pieces))
    try:
        for i, (p, v) in enumerate(flatten(tree)):
            piece = cuts.get(p)
            if isinstance(piece, Piece):
                from ..parallel import tp

                v = tp.whole(v, piece, grid)
            if not writer:
                continue
            t = v.detach().cpu()
            arr = t.view(_VIEWS.get(t.dtype, t.dtype)).numpy()
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            manifest["leaves"].append(
                {"path": p, "file": f"arr_{i}.npy",
                 "shape": list(t.shape), "dtype": _dtype_name(t.dtype)})
            del v, t, arr
        if writer:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
    except BaseException:
        if writer:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    if writer:
        latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(f"step_{step}")
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    if grid is not None:
        import torch.distributed as dist

        dist.barrier()
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


def _reference_source(path: str, cfg):
    """(the reference's leaf path, index along its stacked axis) of the
    port's leaf `path` ("p/layers/5/attn/wq/w" → "p/blocks/l<5 % blk>/
    attn/wq/w", 5 // blk), or (path, None) when it maps one to one."""
    from ..models.transformer import _block_len

    parts = path.split("/")
    for at, key in enumerate(parts[:-1]):
        if key in ("layers", "encoder", "cross") and parts[at + 1].isdigit():
            i = int(parts[at + 1])
            if key == "layers":
                blk = _block_len(cfg)
                head = ["blocks", f"l{i % blk}"]
                i //= blk
            else:
                head = [key]
            return "/".join(parts[:at] + head + parts[at + 2:]), i
    return path, None


def restore(ckpt_dir: str, tree_like, *, step: int | None = None,
            device="cpu", pieces=None, grid=None, cfg=None):
    """Load into the structure of `tree_like` (leaves with `.shape`,
    e.g. tensors) as tensors on `device`.  Returns (tree, step).

    With `pieces` and `grid`, `tree_like` has the whole shapes and each
    rank keeps its piece of every leaf (see the module); with `cfg`, a
    leaf missing from the manifest is looked up in the reference's
    stacked layout.  A leaf whose shape differs from `tree_like`'s
    raises."""
    from ..parallel.sharding import Piece

    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {m["path"]: m for m in manifest["leaves"]}
    cuts = {} if pieces is None else dict(flatten(pieces))
    out = []
    for p, like in flatten(tree_like):
        src, index = (p, None)
        if p not in by_path and cfg is not None:
            src, index = _reference_source(p, cfg)
        if src not in by_path:
            raise KeyError(f"checkpoint {d} has no leaf {p}")
        m = by_path[src]
        want = getattr(torch, m["dtype"])
        arr = np.load(os.path.join(d, m["file"]), mmap_mode="r")
        if want in _VIEWS:
            arr = arr.view(np.int16)
        if index is not None:
            arr = arr[index]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {p}: shape {tuple(arr.shape)} "
                             f"!= {tuple(like.shape)}")
        piece = cuts.get(p)
        if isinstance(piece, Piece):
            arr = piece.cut(arr, grid)
        t = torch.from_numpy(np.array(arr))
        if want in _VIEWS:
            t = t.view(want)
        out.append(t.to(device))
    return unflatten(tree_like, out), step
