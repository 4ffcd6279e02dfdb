"""The kernels' bounds: the least time the card could take for one
launch of K1–K4 on given inputs.

A bound is the larger of two times: the bytes the launch must move
(each input read once, each output written once) over HBM's rate, and
the operations it must do on these inputs over the peak rate of their
type (`launch.mesh.HW`: K1–K3's integer compares over the fp32 rate of
the cores outside the tensor cores, whose int32 rate is no higher; K4's
matmul FLOP over the bf16 tensor-core peak).  Where the work depends on
the data (a row searched by several frontier rows, candidates cut by
the comparisons), the bound counts what these inputs need.

Each returns a `Bound`: the time in ms, which of the two bounds it
("bytes" or "operations"), and the operations and bytes it counted, so
that the roofline (`roofline.op_cost`) can add them up.  `chip_smoke.py`
holds every kernel's time against these.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..launch.mesh import HW

HBM_BYTES_PER_S = HW["hbm_bw"]
CORE_OPS_PER_S = HW["peak_flops_fp32"]
BF16_FLOPS = HW["peak_flops_bf16"]


class Bound(NamedTuple):
    ms: float
    by: str            # "bytes" or "operations"
    ops: float         # compares (K1–K3) or matmul FLOP (K4)
    nbytes: float


def _bound(ops: float, nbytes: float, ops_per_s: float) -> Bound:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    if t_bytes >= t_ops:
        return Bound(t_bytes, "bytes", ops, nbytes)
    return Bound(t_ops, "operations", ops, nbytes)


def bound_of(cand, starts, lens, extra, valid, count, window) -> Bound:
    """One launch of K1's gathered-window entry (`ops.level_expand`).
    Bytes: cand, valid, starts/lens, extra, and each distinct
    predecessor row this launch searches (rows recur across frontier
    rows; they are counted once), and the output written once.
    Operations: a full binary search of each valid candidate in each
    predecessor row, plus one compare per extra."""
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
    return _bound(compares, nbytes, CORE_OPS_PER_S)


def rows_bound_of(csrc, cstart, clen, flat, starts, lens, own, extra, neg,
                  *, dirs, width, window, written=None) -> Bound:
    """One launch of K1's row-sourced kernel (`ops.level_expand_rows`,
    and the first pass of `ops.level_expand_compact`).  Bytes: the
    per-row inputs (cstart, clen, starts/lens, own, extra, neg) and the
    int32 output once each, and each distinct CSR row the launch must
    read once (candidate rows; predecessor rows other than own; own rows
    too where prefix columns are searched there).  `written` given (the
    mask-and-compact entry): the int32 output is the `rows` input
    instead, and each of the `written` pairs below the capacity adds 8
    bytes (parent and newcol).  Operations: a full binary search of each
    candidate left by the > / < comparisons in each other row plus its
    != compares, a search per comparison to cut the range, and a search
    of each prefix column in every row plus its compares."""
    from ..kernels.ref import gather_window

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
    return _bound(compares, nbytes, CORE_OPS_PER_S)


def k4_bound(shape, causal, *, elem: int = 2) -> Bound:
    """One K4 launch of rows (BH, BK, Sq, Sk, hd): its matmul FLOP
    (causal: the pairs on or below the diagonal only) over the card's
    bf16 tensor-core peak, against q, k, v read once and o written once
    (`elem` bytes an element: 2 for bf16) over HBM's rate."""
    BH, BK, Sq, Sk, hd = shape
    pairs = Sq * (Sq + 1) / 2 if causal else Sq * Sk
    flops = 4.0 * BH * hd * pairs
    nbytes = elem * (2 * BH * Sq * hd + 2 * BK * Sk * hd)
    return _bound(flops, nbytes, BF16_FLOPS)


def membership_bound(B, D, L, count, ragged=False) -> Bound:
    """One K2/K3 launch: cand and nbr read once (4 B per entry), nbr_len
    (4 B a row) and cand_valid (1 B a candidate) where passed, and the
    output written once (1 B per candidate, or 4 B per row); against a
    binary search of each candidate, ceil(log2(L + 1)) compares."""
    nbytes = 4 * B * D + 4 * B * L + (4 * B if count else B * D)
    if ragged:
        nbytes += 4 * B + B * D
    compares = B * D * math.ceil(math.log2(L + 1))
    return _bound(compares, nbytes, CORE_OPS_PER_S)
