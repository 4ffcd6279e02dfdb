"""The house (the paper's P1): the square 0-1-2-3 and a roof apex 4 on
its side (0, 1); two automorphisms.

Its embeddings, counted through the roof's base edge (u, v) = (0, 1)
taken in both directions and halved:

    house = 1/2 · Σ_(u,v) [ T(u,v) · Q(u,v)
                            − Σ_(a ∈ N(u) ∩ N(v)) (T(u,a) + T(v,a) − 2) ]

with T(x,y) = |N(x) ∩ N(y)| = (A²)[x,y] the apexes over an edge and
Q(u,v) = (A³)[u,v] − d(u) − d(v) + 1 the paths u-x-y-v through other
vertices (the square's far side x-y); the inner sum takes out the maps
where the apex is x or y.  Summed over the edges it is
Σ T·Q − 2·Σ T² + 2·Σ T, since each triangle appears six times in Σ T.
A, A² and A³ are dense products on the card, in blocks of rows; in
float64 every entry is an exact integer, and the sums run in int64."""
from __future__ import annotations

import torch

EDGES = ((0, 1), (1, 2), (2, 3), (0, 3), (0, 4), (1, 4))
MAX_N = 1 << 15          # A is dense: n² entries
BLOCK_ROWS = 2048


def count(g, dtype=torch.float64) -> int:
    n = g.n
    if n > MAX_N:
        raise ValueError(f"the dense house reference holds n <= {MAX_N}, "
                         f"got {n}")
    exact = dtype == torch.float64
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        e = g.edges()
        A = torch.zeros(n, n, dtype=dtype, device=e.device)
        A[e[:, 0], e[:, 1]] = 1
        acc = torch.int64 if exact else dtype
        d = g.degrees.to(acc)
        tq = sq = t1 = torch.zeros((), dtype=acc, device=e.device)
        for r0 in range(0, n, BLOCK_ROWS):
            r1 = min(r0 + BLOCK_ROWS, n)
            A2 = A[r0:r1] @ A
            A3 = A2 @ A
            sel = (e[:, 0] >= r0) & (e[:, 0] < r1)
            u, v = e[sel, 0], e[sel, 1]
            T, W = A2[u - r0, v], A3[u - r0, v]
            if exact:
                T, W = T.round().to(acc), W.round().to(acc)
            tq = tq + (T * (W - d[u] - d[v] + 1)).sum()
            sq = sq + (T * T).sum()
            t1 = t1 + T.sum()
            del A2, A3
        total = tq - 2 * sq + 2 * t1
        if exact:
            return int(total) // 2
        return int(round(float(total) / 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
