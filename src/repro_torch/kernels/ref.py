"""Plain PyTorch versions of the port's kernels (the `ref.py` contract).

Counterpart of `repro/kernels/ref.py:28-71`.  These run wherever the
tensors lie and are what `kernels/ops.py` uses for CPU tensors; on the
card they are only the yardstick the CUDA kernel is held against
(`chip_smoke.py`, bit-equal).

The reference's oracle gathers each predecessor window and
broadcast-compares it with every candidate, an O(B·D·W) cube; at the
executor's shapes (B = 32768, D = W = 1917) that cube does not fit in
any memory, so membership here is a vectorized binary search over each
sorted CSR row instead.  On rows that are strictly increasing (the
contract both versions share) the two are the same function.
"""
from __future__ import annotations

import math

import torch


def bs_iters(window: int) -> int:
    """Binary-search steps that settle any segment of length ≤ window."""
    return max(1, math.ceil(math.log2(max(window, 2))) + 1)


def segment_member(flat: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   target: torch.Tensor, iters: int) -> torch.Tensor:
    """Vectorized binary search: is `target` in sorted flat[lo:hi)?

    lo/hi/target broadcast together; `iters` must be
    ≥ ceil(log2(max segment length)) + 1.  An active probe lies inside
    [lo, hi) ⊂ [0, len(flat)); settled lanes (lo == hi, possibly at
    len(flat)) and the final read are clamped, so no index ever leaves
    `flat` — JAX clamps silently, CUDA torch would assert."""
    lo, hi, target = torch.broadcast_tensors(lo, hi, target)
    hi0 = hi
    last = flat.shape[0] - 1
    for _ in range(iters):
        mid = (lo + hi) // 2
        val = flat[mid.clamp(max=last)]
        active = lo < hi
        go_right = active & (val < target)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return (lo < hi0) & (flat[lo.clamp(max=last)] == target)


def level_expand_ref(
    cand: torch.Tensor,                      # [B, D] int32
    flat: torch.Tensor,                      # [F] int32 flat CSR indices
    starts: torch.Tensor,                    # [P, B] int32 row offsets
    lens: torch.Tensor,                      # [P, B] int32 row lengths
    extra: torch.Tensor | None = None,       # [B, E] int32
    cand_valid: torch.Tensor | None = None,  # [B, D] bool
    *,
    dirs: tuple = (),
    count: bool = False,
    neg_from: int | None = None,
    window: int,
) -> torch.Tensor:
    """Plain version of the fused level-expansion kernel
    (kernels/csrc/level_expand.cu): membership of each candidate in the
    first min(lens[p, b], window) entries of every predecessor row, the
    restriction / injectivity comparisons against `extra` (dirs[e] ∈
    {+1: >, -1: <, 0: !=}), then the mask — or, with `count=True`, its
    int32 row sum where columns ≥ `neg_from` count −1."""
    mask = (torch.ones(cand.shape, dtype=torch.bool, device=cand.device)
            if cand_valid is None else cand_valid.clone())
    iters = bs_iters(window)
    for p in range(starts.shape[0]):
        lo = starts[p][:, None]
        hi = lo + lens[p].clamp(max=window)[:, None]
        mask &= segment_member(flat, lo, hi, cand, iters)
    for e, d in enumerate(dirs):
        ev = extra[:, e][:, None]
        if d > 0:
            mask &= cand > ev
        elif d < 0:
            mask &= cand < ev
        else:
            mask &= cand != ev
    if not count:
        return mask
    if neg_from is not None:
        col = torch.arange(cand.shape[1], device=cand.device)
        w = torch.where(col < neg_from, 1, -1).to(torch.int32)
        return (mask.to(torch.int32) * w[None, :]).sum(
            dim=1, dtype=torch.int32)
    return mask.sum(dim=1, dtype=torch.int32)
