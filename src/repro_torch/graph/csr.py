"""Sorted CSR graph storage (paper §IV-E: sorted neighborhoods, O(n+m)
merges) plus torch device views.

The executor never materializes a dense [V, max_deg] matrix for the whole
graph; it gathers fixed-width neighbor windows per frontier row from the
flat CSR `indices` array (padded with a sentinel), and performs membership
tests with a vectorized per-segment binary search.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import numpy as np


class LabelView(NamedTuple):
    """Per-label CSR view over a shared label-grouped flat array.

    ``flat[starts[v, c] : starts[v, c] + lens[v, c]]`` is N(v) restricted
    to vertices of label c, sorted by id — so labeled candidate windows
    gather straight from contiguous segments and membership tests against
    full rows keep using the plain sorted CSR.
    """

    flat: np.ndarray            # [2m (+pad)] int32, rows grouped by label
    starts: np.ndarray          # [n, L] int32 absolute offsets into flat
    lens: np.ndarray            # [n, L] int32 segment lengths
    max_label_degree: np.ndarray  # [L] int32, max over v of lens[v, c]


@dataclass(frozen=True)
class GraphCSR:
    n: int                     # vertices
    m: int                     # undirected edges
    indptr: np.ndarray         # [n+1] int32
    indices: np.ndarray        # [2m (+pad)] int32, sorted per segment
    degrees: np.ndarray        # [n] int32
    name: str = ""
    labels: np.ndarray | None = None   # [n] int32 vertex labels, or None

    # ------------------------------------------------------------ construct
    @staticmethod
    def from_edges(
        n: int,
        edges: np.ndarray,
        *,
        relabel_by_degree: bool = False,
        name: str = "",
        labels: np.ndarray | None = None,
    ) -> "GraphCSR":
        """Build from an undirected edge array [E, 2]; dedups, drops
        self-loops, symmetrizes, sorts neighborhoods by vertex id.
        `labels` ([n] small non-negative ints) makes a property graph."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        edges = edges[edges[:, 0] != edges[:, 1]]
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        key = lo * n + hi
        _, uniq = np.unique(key, return_index=True)
        lo, hi = lo[uniq], hi[uniq]

        if labels is not None:
            labels = np.asarray(labels, dtype=np.int32)
            if labels.shape != (n,):
                raise ValueError(f"labels shape {labels.shape} != ({n},)")
            if len(labels) and labels.min() < 0:
                raise ValueError("vertex labels must be non-negative")

        if relabel_by_degree:
            deg = np.bincount(
                np.concatenate([lo, hi]), minlength=n
            )
            # densest-first relabel: new id 0 = highest degree.  With the
            # executor's strided task striping this balances per-device work
            # and makes `id(a) > id(b)` restrictions prune early.
            perm = np.argsort(-deg, kind="stable")
            inv = np.empty(n, dtype=np.int64)
            inv[perm] = np.arange(n)
            lo, hi = inv[lo], inv[hi]
            lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
            if labels is not None:
                labels = labels[perm]

        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        degrees = np.bincount(src, minlength=n).astype(np.int32)
        indptr = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(degrees, out=indptr[1:])
        # pad the flat array with sentinels so fixed-width windows starting
        # at indptr[v] never index past the end
        pad = int(degrees.max()) if len(degrees) and degrees.max() > 0 else 1
        indices = np.concatenate(
            [dst.astype(np.int32), np.full(pad, n, dtype=np.int32)]
        )
        return GraphCSR(
            n=n,
            m=len(lo),
            indptr=indptr,
            indices=indices,
            degrees=degrees,
            name=name,
            labels=labels,
        )

    # ------------------------------------------------------------ properties
    @cached_property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0

    @cached_property
    def fingerprint(self) -> str:
        """Stable content hash of the adjacency structure (not the name).

        Cache keys in the query subsystem (DESIGN.md §5) use this to
        invalidate plans when the resident graph changes; two loads of
        the same edge list (any name) share one fingerprint."""
        h = hashlib.sha256()
        h.update(f"{self.n}|{self.m}|".encode())
        h.update(np.ascontiguousarray(self.indptr).tobytes())
        h.update(np.ascontiguousarray(self.indices[: self.indptr[-1]])
                 .tobytes())
        if self.labels is not None:
            # Same structure with different labels must never share a
            # plan-cache entry; unlabeled graphs keep historical digests.
            h.update(b"|labels|")
            h.update(np.ascontiguousarray(self.labels).tobytes())
        return h.hexdigest()

    @cached_property
    def n_labels(self) -> int:
        """Number of distinct label slots L (labels are 0..L-1); 0 if
        unlabeled."""
        if self.labels is None:
            return 0
        return int(self.labels.max()) + 1 if self.n else 0

    @cached_property
    def label_view(self) -> LabelView:
        """Per-label CSR view (see LabelView).  Labeled graphs only."""
        if self.labels is None:
            raise ValueError(f"graph {self.name!r} has no vertex labels")
        L = self.n_labels
        nnz = int(self.indptr[-1])
        flat = np.full(len(self.indices), self.n, dtype=np.int32)
        starts = np.zeros((self.n, L), dtype=np.int32)
        lens = np.zeros((self.n, L), dtype=np.int32)
        dst = self.indices[:nnz]
        dst_lab = self.labels[dst]
        # Stable sort within each row by destination label: rows are already
        # sorted by id, so each (row, label) segment stays sorted by id.
        row = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)
        order = np.lexsort((dst_lab, row))   # row-major, label-grouped
        flat[:nnz] = dst[order]
        # Segment bookkeeping: per (row, label) counts -> offsets.
        counts = np.zeros((self.n, L), dtype=np.int64)
        np.add.at(counts, (row, dst_lab.astype(np.int64)), 1)
        seg_starts = (
            self.indptr[:-1].astype(np.int64)[:, None]
            + np.concatenate(
                [np.zeros((self.n, 1), dtype=np.int64),
                 np.cumsum(counts, axis=1)[:, :-1]], axis=1)
        )
        starts[:] = seg_starts.astype(np.int32)
        lens[:] = counts.astype(np.int32)
        max_label_degree = (lens.max(axis=0) if self.n
                            else np.zeros(L, dtype=np.int32))
        return LabelView(flat=flat, starts=starts, lens=lens,
                         max_label_degree=max_label_degree.astype(np.int32))

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        nb = self.neighbors(u)
        i = np.searchsorted(nb, v)
        return bool(i < len(nb) and nb[i] == v)

    def triangle_count_numpy(self) -> int:
        """Exact triangle count via per-edge sorted intersection (numpy).
        Fine up to ~1M edges; bigger graphs use the torch executor instead."""
        total = 0
        for u in range(self.n):
            nu = self.neighbors(u)
            nu = nu[nu > u]
            for v in nu:
                nv = self.neighbors(int(v))
                nv = nv[nv > v]
                total += int(np.intersect1d(nu, nv, assume_unique=True).size)
        return total

    def to_device(self, device="cuda"):
        """Tensors consumed by the executor, on `device`."""
        import torch

        return {
            "indptr": torch.as_tensor(self.indptr, device=device),
            "indices": torch.as_tensor(self.indices, device=device),
            "degrees": torch.as_tensor(self.degrees, device=device),
            "n": self.n,
            "max_degree": self.max_degree,
        }

    def edge_array(self) -> np.ndarray:
        """Undirected [m, 2] array (u < v)."""
        out = []
        for u in range(self.n):
            nb = self.neighbors(u)
            for v in nb[nb > u]:
                out.append((u, int(v)))
        return np.asarray(out, dtype=np.int64).reshape(-1, 2)


@dataclass(frozen=True)
class GraphView:
    """Overlay-aware CSR view (live/overlay.py builds these); the
    reference's `GraphView`.

    Same duck type the executor consumes (`n`, `indptr`, `indices`,
    `degrees`, `max_degree`, `labels`, `fingerprint`) with two deliberate
    departures from `GraphCSR`:

      * `indptr` holds per-row STARTS, not prefix sums — a mutated
        (dirty) row points into the patch region appended after the base
        flat array, so `indptr[v + 1]` is NOT row v's end.  The executor
        reads every row as ``[indptr[v], indptr[v] + degrees[v])``
        (gather windows, the binary-search membership test, and K1's
        row-sourced entries, which take (start, len) pairs), so this is
        invisible to it; host code must use :meth:`neighbors`, never
        slice between consecutive offsets.
      * `max_degree` reports the overlay's fixed gather `window`, which
        over-provisions the true max degree by the mutation headroom.
        That keeps the candidate-window width a matcher is built for
        IDENTICAL across epochs, so a mutation swap is a
        `Matcher.rebind`, never a rebuild.

    `fingerprint` is a precomputed content key (the overlay's edge-delta
    digest, O(1) to read) rather than a hash of the arrays: views are
    rebuilt per epoch and per-round identity checks must not re-hash the
    adjacency (live/epoch.py).
    """

    n: int                      # vertices
    m: int                      # undirected edges at this epoch
    indptr: np.ndarray          # [n+1] int32 row STARTS (see above)
    indices: np.ndarray         # [flat_capacity] int32, sentinel-padded
    degrees: np.ndarray         # [n] int32 row lengths
    window: int                 # static gather width (>= any row length)
    fingerprint: str            # content key: base ⊕ delta digest
    name: str = ""
    labels: np.ndarray | None = None    # live views are unlabeled

    @property
    def max_degree(self) -> int:
        """The static gather window, NOT the true max degree — every
        matcher is built for this candidate width, so it must be
        epoch-stable (and ≥ every actual row length)."""
        return self.window

    def neighbors(self, v: int) -> np.ndarray:
        s = int(self.indptr[v])
        return self.indices[s : s + int(self.degrees[v])]

    def has_edge(self, u: int, v: int) -> bool:
        nb = self.neighbors(u)
        i = np.searchsorted(nb, v)
        return bool(i < len(nb) and nb[i] == v)

    def edge_array(self) -> np.ndarray:
        """Undirected [m, 2] array (u < v) — oracle verification reads
        the PATCHED rows, so it sees base ⊕ delta."""
        out = []
        for u in range(self.n):
            nb = self.neighbors(u)
            for v in nb[nb > u]:
                out.append((u, int(v)))
        return np.asarray(out, dtype=np.int64).reshape(-1, 2)
