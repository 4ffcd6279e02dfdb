"""The triangle: each one once, at its largest id c, as the pair of its
other vertices b > a among c's lower neighbours with the edge (b, a).

Every pair (b, a) of lower neighbours of a vertex is looked up among the
graph's edges (u, w), w < u, sorted as the CSR holds them, by a binary
search; the pairs go through in blocks.  The sum of the hits runs in
int64."""
from __future__ import annotations

import torch

EDGES = ((0, 1), (1, 2), (0, 2))
BLOCK_PAIRS = 1 << 25


def count(g, dtype=torch.float64) -> int:
    n = g.n
    e = g.edges()
    low = e[:, 1] < e[:, 0]
    src, flat = e[low, 0], e[low, 1]       # rows sorted, each ascending
    keys = src * n + flat
    if keys.numel() == 0:
        return 0
    olen = torch.bincount(src, minlength=n)
    start = torch.cumsum(olen, 0) - olen
    pos = torch.arange(src.numel(), device=e.device) - start[src]
    # the entry at position i of its row pairs with the i entries before
    ends = torch.cumsum(pos, 0)
    exact = dtype == torch.float64
    acc = torch.int64 if exact else dtype
    total = torch.zeros((), dtype=acc, device=e.device)
    lo, done = 0, 0
    while lo < src.numel():
        hi = int(torch.searchsorted(ends, done + BLOCK_PAIRS, right=True))
        hi = max(hi, lo + 1)
        cnt = pos[lo:hi]
        idx = torch.repeat_interleave(
            torch.arange(lo, hi, device=e.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        j = (torch.arange(idx.numel(), device=e.device)
             - torch.repeat_interleave(first, cnt))
        q = flat[idx] * n + flat[start[src[idx]] + j]
        at = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
        hit = keys[at] == q
        total = total + (hit.sum() if exact else hit.to(acc).sum())
        done = int(ends[hi - 1])
        lo = hi
    return int(total) if exact else int(round(float(total)))
