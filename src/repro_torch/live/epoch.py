"""Epoch fingerprints — the two-level cache key for mutable graphs.

A copy of `repro/live/epoch.py`; the port persists no executables, so
"plans / AOT executables" below reads "plans and warmed matchers".

The immutable stack keys EVERYTHING on `GraphCSR.fingerprint`: one edge
insert moves the content hash, so every plan, AOT executable, and
memoized count dies together.  But those artifacts depend on different
facets of the graph:

  * plans / AOT executables depend on the graph *statistics* the
    configuration search consumed (|V|, |E|, triangle count feed the
    perf model) and on array SHAPES — not on exact edge content.  A
    handful of edge flips leaves the searched configuration and the
    compiled program exactly as valid as before.
  * memoized counts depend on exact edge content: any single flip can
    change a count.

`EpochStamp` splits the key accordingly:

  plan_key  — what `PlanCache`/`PlanStore` entries key on.  Live graphs
              use ("live", base fingerprint, stats_epoch): stable across
              edge mutations AND compactions, bumped only when the
              serving layer decides the stats drifted far enough that
              re-searching plans is worth it.  Non-live engines keep the
              legacy (content fingerprint, |V|, |E|, tri) tuple —
              byte-compatible with every persisted store.
  edge_key  — what memoized counts key on: a content digest of
              (epoch-0 base fingerprint, cumulative inserts, cumulative
              deletes).  It is *content-stable*: two mutation paths that
              reach the same edge set produce the same key, and a
              compaction (which changes the resident arrays but not the
              edge set) leaves it untouched — so count memos survive
              compaction and invalidate on exactly the mutations that
              can change a count.

Stamps are frozen value objects.  Serving code (serve/, query/) holds
THESE across round boundaries, never raw `fingerprint()` results.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass


def edge_delta_digest(base_fingerprint: str, inserts, deletes) -> str:
    """Content digest of `base ⊕ delta` without materializing the edge
    set: sha256 over the epoch-0 base fingerprint plus the SORTED
    cumulative insert/delete lists (normalized u < v pairs).  O(|delta|
    log |delta|) per call — the LiveGraph memoizes it per edge epoch so
    per-round checks are O(1)."""
    h = hashlib.sha256()
    h.update(base_fingerprint.encode())
    for tag, edges in (("+", inserts), ("-", deletes)):
        h.update(tag.encode())
        for u, v in sorted(edges):
            h.update(f"{u},{v};".encode())
    return h.hexdigest()


@dataclass(frozen=True)
class EpochStamp:
    """One round's view identity: carry THIS across rounds, not a raw
    fingerprint.  `plan_key` slots into the PlanCache entry key where
    the legacy graph fingerprint tuple went; `edge_key` keys count
    memos (live/maintain.py)."""

    stats_epoch: int
    edge_epoch: int
    plan_key: tuple
    edge_key: str

    @staticmethod
    def legacy(graph, stats) -> "EpochStamp":
        """Immutable-graph stamp: plan_key is byte-identical to the
        historical `query.cache.graph_fingerprint` tuple, so persisted
        plan stores keep warm-loading across this refactor."""
        return EpochStamp(
            stats_epoch=0,
            edge_epoch=0,
            plan_key=(graph.fingerprint, stats.n_vertices, stats.n_edges,
                      stats.tri_cnt),
            edge_key=graph.fingerprint,
        )

    @staticmethod
    def for_live(live, stats) -> "EpochStamp":
        """Mutable-graph stamp for the current epoch of a `LiveGraph`.
        plan_key survives mutations and compactions (until the live
        graph bumps its stats epoch); edge_key moves with every
        effective mutation and ONLY with effective mutations."""
        return EpochStamp(
            stats_epoch=live.stats_epoch,
            edge_epoch=live.edge_epoch,
            plan_key=("live", live.base0_fingerprint, live.stats_epoch,
                      stats.n_vertices, stats.n_edges, stats.tri_cnt),
            edge_key=live.edge_key,
        )
