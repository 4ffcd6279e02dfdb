"""R-MAT graphs drawn on the device: a frozen copy of the stand-in
generator (`repro_torch.graph.datasets.rmat` and `GraphCSR.from_edges`
with `relabel_by_degree=True`).  Its draw is the Graph 500 spec's
Kronecker generator: each of the n * edge_factor edges falls, bit by
bit, into a quadrant with the chances a, b, c and 1 - a - b - c.

The copy builds the same sorted CSR from the same uniform draws: the
edges fall into quadrants bit by bit, self-loops and duplicates go,
vertices are renumbered densest first (id 0 has the highest degree), and
each row is sorted by id, with `max(degree)` sentinels (value n) after the
last row.  Two things differ, both on purpose:

* the draws come from a `torch.Generator` on the device, in one call per
  bit, so a run pays milliseconds where the host generator pays 42 s at
  scale 22;
* `tie_seed` breaks ties between vertices of equal degree in an order
  drawn from that seed (the original keeps them in id order).  The
  configuration fixes the graph; the run's `--seed` only orders its
  equal-degree vertices, so every seed gets the same graph, and the same
  work, under another numbering.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class DeviceCSR:
    """A sorted, symmetric CSR on one device, in the layout of the
    program's `GraphCSR`: int32 `indptr` [n + 1], `indices` [2m + pad]
    (rows sorted, then `pad` sentinels equal to n), `degrees` [n]."""

    n: int
    m: int
    indptr: torch.Tensor
    indices: torch.Tensor
    degrees: torch.Tensor

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0

    def edges(self) -> torch.Tensor:
        """The 2m ordered edges (src, dst) in CSR order, int64 [2m, 2]."""
        nnz = int(self.indptr[-1])
        src = torch.repeat_interleave(
            torch.arange(self.n, device=self.indptr.device),
            self.degrees.to(torch.int64))
        return torch.stack([src, self.indices[:nnz].to(torch.int64)], 1)


def rmat_edges(scale: int, edge_factor: int, draw, *, a: float = 0.57,
               b: float = 0.19, c: float = 0.19):
    """(src, dst) int64 of the n * edge_factor drawn edges, n = 2**scale.
    `draw(m)` returns m uniforms in [0, 1) as a float64 tensor; it is
    called once per bit, lowest bit first, as the original draws them."""
    n = 1 << scale
    m = n * edge_factor
    src = dst = None
    for bit in range(scale):
        r = draw(m)
        go_right = r >= a + b
        go_down = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        if src is None:
            src = torch.zeros(m, dtype=torch.int64, device=r.device)
            dst = torch.zeros(m, dtype=torch.int64, device=r.device)
        src |= go_down.to(torch.int64) << bit
        dst |= go_right.to(torch.int64) << bit
    return src, dst


def csr_from_edges(n: int, src: torch.Tensor, dst: torch.Tensor, *,
                   tie_rank: torch.Tensor | None = None) -> DeviceCSR:
    """Dedup, drop self-loops, symmetrize, renumber densest first (ties
    by `tie_rank`, a permutation of range(n), or by id where None) and
    sort each row, as `GraphCSR.from_edges(..., relabel_by_degree=True)`
    does."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = torch.unique(torch.minimum(src, dst) * n + torch.maximum(src, dst))
    lo, hi = key // n, key % n
    deg = torch.bincount(torch.cat([lo, hi]), minlength=n)
    if tie_rank is None:
        perm = torch.argsort(-deg, stable=True)
    else:
        perm = torch.argsort(-deg * n + tie_rank.to(torch.int64))
    inv = torch.empty(n, dtype=torch.int64, device=key.device)
    inv[perm] = torch.arange(n, device=key.device)
    lo, hi = inv[lo], inv[hi]
    lo, hi = torch.minimum(lo, hi), torch.maximum(lo, hi)
    src = torch.cat([lo, hi])
    dst = torch.cat([hi, lo])
    order = torch.argsort(src * n + dst)
    src, dst = src[order], dst[order]
    degrees = torch.bincount(src, minlength=n).to(torch.int32)
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=key.device)
    indptr[1:] = torch.cumsum(degrees, 0)
    pad = max(int(degrees.max()) if n else 0, 1)
    indices = torch.cat([dst.to(torch.int32),
                         torch.full((pad,), n, dtype=torch.int32,
                                    device=key.device)])
    return DeviceCSR(n=n, m=int(lo.numel()), indptr=indptr, indices=indices,
                     degrees=degrees)


def draw_rmat(graph: dict, tie_seed: int, device) -> DeviceCSR:
    """The graph of a configuration ({"scale", "edge_factor", "a", "b",
    "c", "graph_seed", ...}) drawn on `device`, its equal-degree vertices
    ordered by `tie_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(graph["graph_seed"]))
    src, dst = rmat_edges(
        graph["scale"], graph["edge_factor"],
        lambda m: torch.rand(m, generator=gen, dtype=torch.float64,
                             device=device),
        a=graph["a"], b=graph["b"], c=graph["c"])
    n = 1 << graph["scale"]
    ties = torch.Generator(device=device)
    ties.manual_seed(int(tie_seed))
    rank = torch.randperm(n, generator=ties, device=device)
    return csr_from_edges(n, src, dst, tie_rank=rank)
