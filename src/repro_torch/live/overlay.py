"""Versioned delta overlay over a resident padded CSR.

A copy of `repro/live/overlay.py`.  In the port, "the fused kernel" is
K1 (`kernels/csrc/level_expand.cu`), whose row-sourced entries take
(start, len) pairs, and "recompiles" are matcher rebuilds.

`DeltaOverlay` keeps the immutable base `GraphCSR` device layout intact
and materializes mutations as PATCHED ROWS in a reserved region of the
flat neighbor array:

    indices = [ base flat (nnz) | patch region | window sentinel pad ]
               ^ clean rows      ^ dirty rows    ^ gather overhang

A vertex whose neighborhood changed gets its fully-merged, sorted row
written into the patch region and its row start (`indptr[v]`) repointed
there; untouched rows keep their base offsets.  The executor reads every
row as ``[indptr[v], indptr[v] + degrees[v])`` — gather windows, the
vectorized binary-search membership test, and the fused kernel's per-row
DMAs all consume (start, len) pairs — so counts over `base ⊕ delta` are
exact on both the portable and fused paths without rebuilding the CSR,
and the two stay bit-identical for free.

Shape stability is the load-bearing invariant: `flat_capacity` (and the
gather `window`) are FIXED at construction, so every epoch's device
arrays have identical shapes and a mutation swap is `Matcher.rebind` —
zero re-searches, zero recompiles.  Compaction folds the delta into a
fresh base CSR laid out in the same fixed-capacity flat array, so even
the compacted swap replays the compiled programs; only genuine growth
(a merged row outrunning the window, or the patch region filling up)
forces new shapes, and that path compacts + rebuilds honestly.

Two deltas are tracked: the *current-base* delta (drives the view; reset
by compaction) and the *cumulative* delta vs the epoch-0 base (drives
`edge_key`, the content digest count memos key on — compaction leaves it
untouched, so memoized counts survive compaction).
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..graph.csr import GraphCSR, GraphView
from .epoch import edge_delta_digest

# Keep enough mutation batches to answer "what changed since the memo's
# epoch" for any plausibly-live memo; older memos fall back to a full
# recount (correct, just not incremental).
_MUTATION_LOG_LIMIT = 128

MUTATION_VERBS = ("insert_edges", "delete_edges", "compact")


class OverlayOverflow(RuntimeError):
    """A merged row outgrew the gather window, or the patch region is
    full.  `apply` handles this internally by compacting (growing the
    fixed shapes when it must); seeing it escape means a bug."""


def _normalize_edges(n: int, edges) -> list[tuple[int, int]]:
    out = []
    for e in edges:
        u, v = int(e[0]), int(e[1])
        if u == v:
            raise ValueError(f"self-loop ({u},{u}) is not a valid edge")
        if not (0 <= u < n and 0 <= v < n):
            raise ValueError(
                f"edge ({u},{v}) outside vertex range [0, {n}) — the live "
                "subsystem mutates edges over a fixed vertex set")
        out.append((min(u, v), max(u, v)))
    return out


class DeltaOverlay:
    """A live (mutable) graph: base CSR + versioned edge delta.

    The engine constructs one per resident graph, reads `.view` for the
    executor-facing adjacency, and calls `.apply()` only at round
    boundaries (query/engine.py) so no in-flight `CountState` ever
    straddles an epoch.
    """

    def __init__(self, base: GraphCSR, *, window_headroom: int = 8,
                 patch_capacity: int | None = None):
        if base.labels is not None:
            raise NotImplementedError(
                "live overlays cover unlabeled graphs; labeled mutation "
                "needs per-label segment patching (future work)")
        self.base0 = base
        self.base = base
        self.n = base.n
        self.name = base.name
        self.window_headroom = int(window_headroom)
        # Static gather width for every epoch: base max degree plus
        # headroom for rows that grow under inserts.
        self.window = max(base.max_degree, 1) + self.window_headroom
        nnz0 = int(base.indptr[-1])
        self.patch_capacity = (int(patch_capacity) if patch_capacity
                               else max(4 * self.window, 256))
        self.flat_capacity = nnz0 + self.patch_capacity + self.window
        # base0.fingerprint is a cached_property: hash once here, O(1)
        # reads forever after (satellite: no per-round re-hashing).
        self.base0_fingerprint = base.fingerprint
        # Current-base delta (view); cumulative delta vs base0 (edge_key).
        self.inserts: set[tuple[int, int]] = set()
        self.deletes: set[tuple[int, int]] = set()
        self._ins0: set[tuple[int, int]] = set()
        self._del0: set[tuple[int, int]] = set()
        self.edge_epoch = 0
        self.stats_epoch = 0
        self.compactions = 0
        self.resizes = 0
        # (edge_key before batch, edge_key after batch, touched vertices)
        self.mutation_log: list[tuple[str, str, frozenset[int]]] = []
        self._edge_key_cache: dict[int, str] = {}
        self._edge_key_computes = 0     # memoization evidence for tests
        self._view: GraphView | None = None

    # ------------------------------------------------------------ keys
    @property
    def edge_key(self) -> str:
        """Content digest of base ⊕ delta, memoized per edge epoch so
        per-round identity checks are O(1) (recomputed only when a
        mutation actually lands; compaction reuses the memo because the
        cumulative delta — hence the content — is unchanged)."""
        key = self._edge_key_cache.get(self.edge_epoch)
        if key is None:
            self._edge_key_computes += 1
            key = edge_delta_digest(self.base0_fingerprint,
                                    self._ins0, self._del0)
            self._edge_key_cache = {self.edge_epoch: key}
        return key

    def overlay_edges(self) -> int:
        """Current-base delta size (what compaction thresholds watch)."""
        return len(self.inserts) + len(self.deletes)

    def dirty_vertices(self) -> set[int]:
        out: set[int] = set()
        for u, v in self.inserts:
            out.add(u); out.add(v)
        for u, v in self.deletes:
            out.add(u); out.add(v)
        return out

    # ------------------------------------------------------------ mutate
    def apply(self, verb: str, edges=None) -> int:
        """Apply one mutation batch; returns the number of EFFECTIVE
        edge changes (no-ops — inserting a present edge, deleting an
        absent one — don't bump the epoch).  Always succeeds: overflow
        of the fixed patch/window triggers an internal compaction (and,
        if the graph genuinely outgrew its shapes, a resize)."""
        if verb == "compact":
            self.compact()
            return 0
        if verb not in ("insert_edges", "delete_edges"):
            raise ValueError(
                f"unknown mutation verb {verb!r}; expected one of "
                f"{MUTATION_VERBS}")
        pairs = _normalize_edges(self.n, edges or ())
        prev_key = self.edge_key
        touched: set[int] = set()
        changed = 0
        for uv in pairs:
            if verb == "insert_edges":
                if uv in self.deletes:
                    self.deletes.discard(uv)
                elif uv not in self.inserts and not self.base.has_edge(*uv):
                    self.inserts.add(uv)
                else:
                    continue
                # cumulative mirror vs base0
                if uv in self._del0:
                    self._del0.discard(uv)
                elif not self.base0.has_edge(*uv):
                    self._ins0.add(uv)
            else:
                if uv in self.inserts:
                    self.inserts.discard(uv)
                elif uv not in self.deletes and self.base.has_edge(*uv):
                    self.deletes.add(uv)
                else:
                    continue
                if uv in self._ins0:
                    self._ins0.discard(uv)
                elif self.base0.has_edge(*uv):
                    self._del0.add(uv)
            changed += 1
            touched.add(uv[0]); touched.add(uv[1])
        if not changed:
            return 0
        self.edge_epoch += 1
        self._view = None
        self.mutation_log.append((prev_key, self.edge_key,
                                  frozenset(touched)))
        del self.mutation_log[:-_MUTATION_LOG_LIMIT]
        try:
            self._view = self._build_view()
        except OverlayOverflow:
            self.compact()
        return changed

    def compact(self) -> None:
        """Fold the current delta into a fresh base CSR.  Content (hence
        `edge_key` and every count memo) is unchanged; the resident
        arrays are relaid.  Fixed shapes are kept whenever the new base
        fits, so the post-compaction swap is still rebind-only."""
        new_base = GraphCSR.from_edges(self.n, self.materialize_edges(),
                                       name=self.name)
        self.base = new_base
        self.inserts.clear()
        self.deletes.clear()
        self.compactions += 1
        self._view = None
        grew = False
        if new_base.max_degree > self.window:
            self.window = new_base.max_degree + self.window_headroom
            grew = True
        nnz = int(new_base.indptr[-1])
        # Keep the fixed flat_capacity whenever the relaid base still
        # leaves room for at least one window-wide patch row — the view
        # bounds its patch region by (flat_capacity - window), not by
        # patch_capacity, so the post-compaction swap stays rebind-only.
        # Only genuine growth (patch squeezed below one row) re-lays out
        # to the full patch budget and pays the matcher rebuild.
        if nnz + 2 * self.window > self.flat_capacity:
            self.flat_capacity = nnz + self.patch_capacity + self.window
            grew = True
        if grew:
            self.resizes += 1

    def materialize_edges(self) -> np.ndarray:
        """Undirected [E, 2] edge array of base ⊕ current delta (u < v),
        built directly from the base CSR + delta sets (valid even when
        the patched view itself cannot be built for want of space)."""
        base = self.base
        nnz = int(base.indptr[-1])
        dst = base.indices[:nnz].astype(np.int64)
        src = np.repeat(np.arange(self.n, dtype=np.int64), base.degrees)
        fwd = dst > src
        keys = src[fwd] * self.n + dst[fwd]
        if self.deletes:
            drop = np.asarray(
                [u * self.n + v for u, v in self.deletes], dtype=np.int64)
            keys = keys[~np.isin(keys, drop)]
        if self.inserts:
            keys = np.concatenate([keys, np.asarray(
                [u * self.n + v for u, v in self.inserts], dtype=np.int64)])
        return np.stack([keys // self.n, keys % self.n], axis=1)

    # ------------------------------------------------------------ view
    @property
    def view(self) -> GraphView:
        if self._view is None:
            self._view = self._build_view()
        return self._view

    def _build_view(self) -> GraphView:
        base = self.base
        nnz = int(base.indptr[-1])
        flat = np.full(self.flat_capacity, self.n, dtype=np.int32)
        flat[:nnz] = base.indices[:nnz]
        # Row starts: [n+1] so the executor's valid-row test
        # (v0 < indptr.shape[0]-1) and sentinel-row indexing still work;
        # the final entry is a degree-0 row parked at nnz.
        starts = np.empty(self.n + 1, dtype=np.int32)
        starts[:-1] = base.indptr[:-1]
        starts[-1] = nnz
        degrees = base.degrees.copy()
        ins_p: dict[int, list[int]] = defaultdict(list)
        del_p: dict[int, set[int]] = defaultdict(set)
        for u, v in self.inserts:
            ins_p[u].append(v)
            ins_p[v].append(u)
        for u, v in self.deletes:
            del_p[u].add(v)
            del_p[v].add(u)
        off = nnz
        patch_end = self.flat_capacity - self.window
        for v in sorted(set(ins_p) | set(del_p)):
            row = sorted((set(base.neighbors(v).tolist()) - del_p[v])
                         | set(ins_p[v]))
            if len(row) > self.window:
                raise OverlayOverflow(
                    f"row {v} merged to {len(row)} > window {self.window}")
            if off + len(row) > patch_end:
                raise OverlayOverflow(
                    f"patch region full at vertex {v} "
                    f"(off={off}, patch_end={patch_end})")
            flat[off:off + len(row)] = np.asarray(row, dtype=np.int32)
            starts[v] = off
            degrees[v] = len(row)
            off += len(row)
        m = int(degrees.sum()) // 2
        return GraphView(n=self.n, m=m, indptr=starts, indices=flat,
                         degrees=degrees, window=self.window,
                         fingerprint=self.edge_key, name=self.name)

    # ------------------------------------------------------- maintenance
    def dirty_roots_since(self, edge_key: str, depth: int):
        """Vertices whose depth-`depth` pattern embeddings may have
        changed since the epoch identified by `edge_key`; None when the
        epoch is unknown (log evicted / different lineage) and the
        caller must fall back to a full recount.

        Roots = all vertices touched by mutation batches since that
        epoch, expanded `depth - 1` hops over the CURRENT adjacency.
        BFS over the current graph suffices: any edge on a path that
        existed at some epoch in the window but not now was deleted
        inside the window, so its endpoints are themselves touched —
        walking back from the last touched vertex on any old-epoch path
        leaves a suffix of current edges of length ≤ depth - 1.
        """
        if edge_key == self.edge_key:
            return set()
        touched: set[int] = set()
        found = False
        for prev_key, _new_key, tv in reversed(self.mutation_log):
            touched |= tv
            if prev_key == edge_key:
                found = True
                break
        if not found:
            return None
        view = self.view
        seen = set(touched)
        frontier = touched
        for _ in range(max(int(depth) - 1, 0)):
            nxt: set[int] = set()
            for v in frontier:
                for u in view.neighbors(v).tolist():
                    if u not in seen:
                        seen.add(u)
                        nxt.add(u)
            if not nxt:
                break
            frontier = nxt
        return seen

    # ------------------------------------------------------- persistence
    def to_record(self) -> dict:
        """Overlay store record (query/store.py `live-<base0 fp>.json`):
        the cumulative delta vs base0, enough to rehydrate this epoch's
        edge content next to the plans it shares a store with."""
        return {
            "base_fingerprint": self.base0_fingerprint,
            "edge_epoch": int(self.edge_epoch),
            "stats_epoch": int(self.stats_epoch),
            "compactions": int(self.compactions),
            "inserts": sorted([int(u), int(v)] for u, v in self._ins0),
            "deletes": sorted([int(u), int(v)] for u, v in self._del0),
        }

    @staticmethod
    def from_record(base: GraphCSR, record: dict, **kwargs) -> "DeltaOverlay":
        """Rehydrate an overlay onto its epoch-0 base from a store
        record.  Edge content (and hence `edge_key`) matches the saved
        epoch; epoch COUNTERS restart from the replayed batches."""
        live = DeltaOverlay(base, **kwargs)
        if record.get("base_fingerprint") != live.base0_fingerprint:
            raise ValueError("overlay record does not match this base graph")
        live.apply("insert_edges", record.get("inserts", []))
        live.apply("delete_edges", record.get("deletes", []))
        live.stats_epoch = int(record.get("stats_epoch", 0))
        return live
