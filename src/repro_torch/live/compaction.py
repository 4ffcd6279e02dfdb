"""Compaction policy: when to fold the delta overlay back into a fresh
padded CSR, and when graph statistics have drifted far enough that the
plan search itself should rerun.  A copy of `repro/live/compaction.py`.

Read-path cost of the overlay is ~zero for clean rows (same gather, same
membership test) and one extra merged row per dirty vertex, so the
trigger is overlay SIZE, not read amplification: past a threshold the
patch region risks overflow and the per-mutation view rebuild (O(dirty ·
window)) starts to rival a full relayout.  `overlay_budget` turns the
graph's stats into that threshold — a crude perf-model stand-in with the
same shape as core/perf_model.py's cost accounting: compaction costs one
O(m) relayout, the overlay costs O(delta) per batch, so budget scales
with m and breaks even around m/8.

Compaction itself lives on `DeltaOverlay.compact()` (it must also run on
overflow, policy or not); the engine calls `maybe_compact` between
rounds so the swap is atomic w.r.t. in-flight counts — paired with
`stats_drifted`, which bumps the stats epoch (new plan_key → fresh
config search) when |E| has moved materially from what the searched
configurations assumed.
"""
from __future__ import annotations

from dataclasses import dataclass


def overlay_budget(n_edges: int) -> int:
    """Overlay size past which compaction beats carrying the delta."""
    return max(256, int(n_edges) // 8)


@dataclass(frozen=True)
class CompactionPolicy:
    max_overlay_edges: int = 4096       # hard cap, any graph size
    max_overlay_fraction: float = 0.25  # delta / base edges
    stats_drift: float = 0.5            # relative |E| drift → re-search
    use_model: bool = True              # also apply overlay_budget(m)


def should_compact(live, policy: CompactionPolicy) -> str | None:
    """Reason to compact now, or None."""
    delta = live.overlay_edges()
    if not delta:
        return None
    if delta >= policy.max_overlay_edges:
        return f"overlay {delta} >= cap {policy.max_overlay_edges}"
    base_m = max(live.base.m, 1)
    if delta / base_m >= policy.max_overlay_fraction:
        return f"overlay {delta} >= {policy.max_overlay_fraction:.0%} of base"
    if policy.use_model and delta >= overlay_budget(base_m):
        return f"overlay {delta} >= model budget {overlay_budget(base_m)}"
    return None


def stats_drifted(live, stats, policy: CompactionPolicy) -> bool:
    """Has |E| moved far enough from the stats the plan search used that
    searched configurations (perf-model ranked on |V|, |E|, tri) are
    stale?  Plans stay VALID either way — this gates re-SEARCH."""
    assumed = max(int(stats.n_edges), 1)
    return abs(live.view.m - assumed) / assumed > policy.stats_drift


def maybe_compact(live, policy: CompactionPolicy) -> str | None:
    """Engine hook: compact if the policy says so; returns the reason
    when a compaction ran."""
    reason = should_compact(live, policy)
    if reason is not None:
        live.compact()
    return reason
