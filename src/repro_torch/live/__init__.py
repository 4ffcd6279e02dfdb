"""Live-graph subsystem: serve pattern counts while the graph mutates.

The port's counterpart of `repro/live/` (epoch, compaction and overlay
are copies; maintain is ported over the port's executor).

    overlay.py     DeltaOverlay — versioned insert/delete buffers merged
                   as patched rows beside the padded CSR; fixed shapes
                   so epoch swaps are rebind-only (no matcher rebuilds).
    epoch.py       EpochStamp — two-level cache keys: plans key on
                   the stats epoch (survive mutations), memoized counts
                   key on the edge epoch (invalidate precisely).
    compaction.py  when to fold the overlay into a fresh CSR and when
                   stats drift warrants a plan re-search.
    maintain.py    CountMaintainer — per-span raw memos + dirty-root
                   incremental recount with full-recount break-even.

The engine (query/engine.py) owns the round-boundary discipline: queued
mutations apply between rounds, never under an in-flight CountState.
"""
from .compaction import (CompactionPolicy, maybe_compact, overlay_budget,
                         should_compact, stats_drifted)
from .epoch import EpochStamp, edge_delta_digest
from .maintain import CountMaintainer, MaintState
from .overlay import MUTATION_VERBS, DeltaOverlay, OverlayOverflow

__all__ = [
    "CompactionPolicy", "CountMaintainer", "DeltaOverlay", "EpochStamp",
    "MaintState", "MUTATION_VERBS", "OverlayOverflow", "edge_delta_digest",
    "maybe_compact", "overlay_budget", "should_compact", "stats_drifted",
]
