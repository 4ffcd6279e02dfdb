"""Public wrapper of kernel K1 with the reference's padding contract.

Counterpart of `repro/kernels/ops.py:18-35, 113-191`.  `level_expand`
dispatches on where its tensors lie: CUDA tensors go to the hand-written
kernel (`intersect.level_expand_cuda`), CPU tensors to the plain
PyTorch version (`ref.level_expand_ref`).  It never falls back from one
to the other: a build or launch failure raises.

`launches` counts kernel launches per mode (`mask`, `count`, `signed`);
it moves only where the CUDA kernel is launched.
"""
from __future__ import annotations

import torch

from .intersect import level_expand_cuda, load
from .ref import level_expand_ref

CAND_PAD = -1
NBR_PAD = torch.iinfo(torch.int32).max

# device_graph pads the flat CSR array by flat_gather_pad() sentinels,
# as the reference does, so the device layout (and every window gather
# that runs past a row) is the same in both packages.
MAX_BLOCK_L = 512

launches = {"mask": 0, "count": 0, "signed": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def prepare(device) -> None:
    """Build and load K1 for tensors on `device` (its first use compiles
    it); CPU tensors take the plain version, which needs nothing."""
    if torch.device(device).type == "cuda":
        load()


def flat_gather_pad() -> int:
    """Sentinel entries appended to a flat CSR array on the device.

    The reference needs them so its in-kernel window DMAs stay in
    bounds; K1's binary search never reads outside a row, but the
    executor's candidate-window gathers read past the last rows, and
    keeping the reference's layout keeps both packages' arrays equal."""
    return MAX_BLOCK_L


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype} != {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, cand on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def level_expand(
    cand: torch.Tensor,                      # [B, D] candidate window
    flat: torch.Tensor,                      # [F] flat CSR indices array
    starts: torch.Tensor,                    # [P, B] CSR row offsets
    lens: torch.Tensor,                      # [P, B] valid row lengths
    extra: torch.Tensor | None = None,       # [B, E] prefix-vertex values
    cand_valid: torch.Tensor | None = None,  # [B, D] bool
    *,
    dirs: tuple = (),
    count: bool = False,
    neg_from: int | None = None,
    window: int,
) -> torch.Tensor:
    """One fused pass for a whole expansion level.

    mask[b, d] = cand_valid[b, d]
               ∧ (∀p: cand[b, d] ∈ flat[starts[p, b] : +lens[p, b]])
               ∧ (∀e: cand[b, d] <op dirs[e]> extra[b, e])
    with <op> ∈ {+1: >, -1: <, 0: !=}.  `count=True` returns
    cnt[b] = Σ_d mask[b, d] (int32) instead; with `neg_from` set,
    columns ≥ neg_from subtract instead of add (the fused IEP
    prefix-correction tail).

    Contracts (the reference's): rows flat[starts[p,b] : +lens[p,b]]
    strictly increasing; `window` ≥ every lens[p, b] (only the first
    `window` entries of a row are searched); every row inside `flat`.
    All integer inputs are int32 and every input is contiguous and on
    `cand`'s device."""
    if cand.dim() != 2:
        raise ValueError(f"cand must be [B, D], got {tuple(cand.shape)}")
    B, D = cand.shape
    dev = cand.device
    if starts.dim() != 2 or starts.shape[1] != B or starts.shape[0] < 1:
        raise ValueError(f"starts must be [P>=1, {B}], got "
                         f"{tuple(starts.shape)}")
    P = starts.shape[0]
    _check("cand", cand, torch.int32, (B, D), dev)
    _check("flat", flat, torch.int32, None, dev)
    if flat.dim() != 1:
        raise ValueError(f"flat must be 1-D, got {tuple(flat.shape)}")
    _check("starts", starts, torch.int32, (P, B), dev)
    _check("lens", lens, torch.int32, (P, B), dev)
    if cand_valid is not None:
        _check("cand_valid", cand_valid, torch.bool, (B, D), dev)
    dirs = tuple(int(d) for d in dirs)
    if dirs:
        if extra is None:
            raise ValueError("dirs given without extra")
        _check("extra", extra, torch.int32, (B, len(dirs)), dev)
    else:
        extra = None
    if neg_from is not None and not count:
        raise ValueError("neg_from needs count=True")

    if dev.type == "cpu":
        return level_expand_ref(cand, flat, starts, lens, extra, cand_valid,
                                dirs=dirs, count=count, neg_from=neg_from,
                                window=window)
    if dev.type != "cuda":
        raise ValueError(f"level_expand runs on cuda or cpu, not {dev}")
    if B == 0:
        shape = (0,) if count else (0, D)
        return torch.zeros(shape, dtype=torch.int32 if count else torch.bool,
                           device=dev)
    out = level_expand_cuda(cand, flat, starts, lens, extra, cand_valid,
                            dirs=dirs, count=count, neg_from=neg_from,
                            window=window)
    mode = "mask" if not count else ("count" if neg_from is None
                                     else "signed")
    launches[mode] += 1
    return out
