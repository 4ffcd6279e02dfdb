"""K1's bound per call, and the card's peaks: a frozen copy of the
program's `roofline/kernels.py` (`bound_of`, `rows_bound_of`) and of the
window gather it uses (`kernels/ref.py` `gather_window`).

A bound is the least time the card could take for one call on its
inputs: the larger of the bytes the call must move (each input read
once, each output written once) over HBM's rate, and the compares it
must do over the rate of the cores outside the tensor cores, whose int32
rate is no higher than their fp32 rate.  Where the work depends on the
data (rows searched by several frontier rows, candidates cut by the
comparisons) it counts what these inputs need.

The copy is the yardstick: a later change to the program's kernels or
their bounds leaves it as it is.  The tests hold it equal to the
program's functions on the same arguments.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# NVIDIA H100 SXM data sheet (dense rates, 700 W).
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_ops_per_s": 67e12,       # outside the tensor cores
    "bf16_flops": 989e12,          # tensor cores
    "memory_bytes": 80e9,
}


class Bound(NamedTuple):
    ms: float
    by: str            # "bytes" or "operations"
    ops: float         # compares
    nbytes: float


def _bound(ops: float, nbytes: float) -> Bound:
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"] * 1e3
    t_ops = ops / PEAKS["fp32_ops_per_s"] * 1e3
    if t_bytes >= t_ops:
        return Bound(t_bytes, "bytes", ops, nbytes)
    return Bound(t_ops, "operations", ops, nbytes)


def gather_window(src, start, length, width: int):
    """cand[b, d] = src[start[b] + d] for d < width, indices clamped to
    the array's end, and ok[b, d] = d < length[b]."""
    cols = torch.arange(width, dtype=torch.int32, device=src.device)
    idx = (start[:, None] + cols[None, :]).clamp_(max=src.shape[0] - 1)
    return src[idx], cols[None, :] < length[:, None]


def bound_of(cand, starts, lens, extra, valid, count, window) -> Bound:
    """One call of K1's gathered-window entry (`ops.level_expand`).
    Bytes: cand, valid, starts/lens, extra, each distinct predecessor row
    once, and the output once.  Compares: a full binary search of each
    valid candidate in each predecessor row, plus one per extra."""
    B, D = cand.shape
    P = starts.shape[0]
    key = (starts.to(torch.int64) << 32) | lens.clamp(max=window).to(
        torch.int64)
    rows = int((torch.unique(key) & 0xFFFFFFFF).sum())
    nbytes = (4 * B * D + (B * D if valid is not None else 0) + 4 * rows
              + 8 * P * B + (4 * extra.numel() if extra is not None else 0)
              + (4 * B if count else B * D))
    n_valid = (valid.sum(dim=1) if valid is not None
               else torch.full((B,), D, device=cand.device)).double()
    steps = torch.ceil(torch.log2(
        lens.clamp(min=0, max=window).double() + 1)).sum(dim=0)
    E = extra.shape[1] if extra is not None else 0
    compares = float((n_valid * (steps + E)).sum())
    return _bound(compares, nbytes)


def rows_bound_of(csrc, cstart, clen, flat, starts, lens, own, extra, neg,
                  *, dirs, width, window, written=None) -> Bound:
    """One call of K1's row-sourced entry (`ops.level_expand_rows`) or of
    its mask-and-compact entry (`ops.level_expand_compact`, with
    `written`, the pairs it wrote below the capacity).  Bytes: the
    per-row inputs and the int32 output once each, each distinct CSR
    row the call must read once, and 8 bytes a written pair.  Compares:
    a binary search of each candidate left by the > / < comparisons in
    each other row plus its != compares, a search per comparison to cut
    the range, and a search of each prefix column in every row."""
    P, B = starts.shape
    Q = 0 if neg is None else neg.shape[1]
    E = len(dirs)
    dev = cstart.device
    n_own = 0 if own is None else 1
    own = (torch.full((B,), -1, dtype=torch.int32, device=dev)
           if own is None else own)
    plen = lens.clamp(min=0, max=window)
    clen_w = clen.clamp(min=0, max=width)
    searched = torch.arange(P, device=dev)[:, None] != own[None, :]
    keys = [(cstart.to(torch.int64) << 32) | clen_w.to(torch.int64)]
    pkeys = (starts.to(torch.int64) << 32) | plen.to(torch.int64)
    keys.append(pkeys[searched] if Q == 0 else pkeys.reshape(-1))
    rows = int((torch.unique(torch.cat(keys)) & 0xFFFFFFFF).sum())
    nbytes = (4 * B * (2 + 2 * P + n_own + E + Q + 1)
              + 4 * rows + 8 * (written or 0))
    cand, ok = gather_window(csrc, cstart, clen, width)
    for e, d in enumerate(dirs):
        if d:
            ev = extra[:, e][:, None]
            ok &= (cand > ev) if d > 0 else (cand < ev)
    n_in = ok.sum(dim=1).double()
    steps = torch.ceil(torch.log2(plen.double() + 1))
    other = (steps * searched).sum(dim=0)
    n_range = sum(1 for d in dirs if d)
    n_ne = E - n_range
    compares = float((n_in * (other + n_ne)).sum()
                     + n_range * torch.ceil(torch.log2(
                         clen_w.double() + 1)).sum()
                     + Q * (steps.sum(dim=0) + E).sum())
    return _bound(compares, nbytes)
