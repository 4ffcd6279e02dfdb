"""Incremental count maintenance over a delta overlay.

Port of `repro/live/maintain.py` over the port's `Matcher.count_partial`
/ `CountState` / `CountResult`.  Sharded entries (`ShardedMatcher`, one
collective pass over fixed stripes) take the reference's memo-or-full-
recount branch: no spans, no budget.

Pattern counts decompose over the engine's fixed root-vertex grid: the
raw embedding total is a sum of per-span raws (the same spans
`Matcher.count_partial` walks), and a mutation can only change the raw
of a span containing a vertex within `depth - 1` hops of a touched
vertex (every embedding is connected and rooted at its span's v0).  So
the maintainer memoizes per-span raw totals keyed on the overlay's
`edge_key` and, after a mutation, re-expands ONLY the spans holding
dirty roots — provably the full set of spans whose raw can have moved —
splicing the rest from the memo.  When the dirty spans exceed a
break-even fraction of the grid it falls back to a full recount (the
incremental walk would do most of the work anyway and the memo
bookkeeping is pure overhead).

Division order is preserved exactly: per-span RAWS are summed, then the
plan's IEP divisor and (naive mode) |Aut| divide ONCE at the end —
mirroring `Matcher.count_partial` + `CacheEntry._finish` — so the
maintained count is bit-identical to an uninterrupted fresh count.

The maintainer sits between the engine's group loop and the cache
entry: `count_partial(key, entry, state, ...)` has the same
(state, result) preemption contract as `CacheEntry.count_partial`, and
`MaintState.dispatches` feeds the engine's quantum accounting the same
way `CountState.dispatches` does.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.executor import CountResult, CountState

DEFAULT_BREAK_EVEN = 0.5


@dataclass
class _Memo:
    edge_key: str                  # overlay content at memoization time
    chunk: int | None              # grid the span totals decompose over
    span_totals: dict              # span start -> raw total
    result: CountResult
    max_needed: int = 0


@dataclass
class MaintState:
    """Resumable incremental/full recount: pending grid spans plus the
    raw per-span totals gathered so far (carried-from-memo + fresh)."""

    spans: list                    # [(start, end)] pending, LIFO
    chunk: int
    edge_key: str                  # epoch this recount is FOR
    span_totals: dict = field(default_factory=dict)
    inner: CountState | None = None   # span in progress (budget cut)
    inner_span: tuple | None = None
    dispatches: int = 0            # engine quantum accounting
    overflowed: bool = False
    max_needed: int = 0


class CountMaintainer:
    """Per-engine memo of counts (and their per-span raws) keyed on the
    group key + overlay edge_key, with dirty-root incremental refresh."""

    def __init__(self, live, *, break_even: float = DEFAULT_BREAK_EVEN):
        self.live = live
        self.break_even = float(break_even)
        self._memos: dict = {}        # engine group key -> _Memo
        self.memo_hits = 0            # served straight from memo
        self.incremental_hits = 0     # dirty-span refresh chosen
        self.full_recounts = 0        # stale memo, full refresh chosen
        self.invalidations = 0        # stale memos encountered
        self.spans_reused = 0         # grid spans spliced from memo
        self.spans_recomputed = 0     # grid spans re-expanded

    def counters(self) -> dict:
        return {
            "memo_hits": self.memo_hits,
            "incremental_hits": self.incremental_hits,
            "full_recounts": self.full_recounts,
            "memo_invalidations": self.invalidations,
            "spans_reused": self.spans_reused,
            "spans_recomputed": self.spans_recomputed,
        }

    def forget(self) -> None:
        """Drop every memo (e.g. the maintainer's overlay was replaced)."""
        self._memos.clear()

    # ------------------------------------------------------------ count
    def count_partial(self, key, entry, state, *, chunk=None,
                      max_dispatches=None):
        """Same contract as `CacheEntry.count_partial`, plus memo/
        incremental routing.  `key` is the engine's coalescing group key
        (canonical pattern class + mode) — one memo per group."""
        edge_key = self.live.edge_key
        if entry.sharded:
            memo = self._memos.get(key)
            if memo is not None:
                if memo.edge_key == edge_key:
                    self.memo_hits += 1
                    return None, memo.result
                self.invalidations += 1
                self.full_recounts += 1
            st, out = entry.count_partial(state, chunk=chunk,
                                          max_dispatches=max_dispatches)
            if out is not None and not out.overflowed:
                self._memos[key] = _Memo(edge_key=edge_key, chunk=None,
                                         span_totals=None, result=out,
                                         max_needed=out.max_needed)
            return st, out

        matcher = entry.matcher
        cfg = matcher.cfg
        if state is None:
            width = min(chunk or cfg.capacity, cfg.capacity)
            memo = self._memos.get(key)
            if (memo is not None and memo.edge_key == edge_key
                    and memo.chunk == width):
                self.memo_hits += 1
                return (MaintState(spans=[], chunk=width, edge_key=edge_key),
                        memo.result)
            state = self._fresh_state(key, memo, edge_key, width, entry)

        budget = (None if max_dispatches is None
                  else max(int(max_dispatches), 1))
        used = 0
        while ((state.inner is not None or state.spans)
               and (budget is None or used < budget)):
            if state.inner is None:
                s, e = state.spans.pop()
                state.inner_span = (s, e)
                state.inner = CountState(
                    spans=[(s, e, cfg.capacity)], chunk=state.chunk)
            before = state.inner.dispatches
            inner, out = matcher.count_partial(
                state.inner, chunk=state.chunk,
                max_dispatches=None if budget is None else budget - used)
            step = max(inner.dispatches - before, 0)
            used += step
            state.dispatches += step
            state.inner = inner
            if out is None:
                break                      # budget exhausted mid-span
            state.span_totals[state.inner_span[0]] = inner.total
            state.overflowed |= inner.overflowed
            state.max_needed = max(state.max_needed, inner.max_needed)
            self.spans_recomputed += 1
            state.inner = None
            state.inner_span = None
        if state.inner is not None or state.spans:
            return state, None

        raw = sum(state.span_totals.values())
        count = raw // entry.plan.iep_divisor
        if entry.mode == "naive":
            count //= entry.pattern.aut_count()
        result = CountResult(count=count, overflowed=state.overflowed,
                             max_needed=state.max_needed)
        if not state.overflowed and state.edge_key == self.live.edge_key:
            self._memos[key] = _Memo(
                edge_key=state.edge_key, chunk=state.chunk,
                span_totals=dict(state.span_totals), result=result,
                max_needed=state.max_needed)
        return state, result

    # ------------------------------------------------------------ routing
    def _fresh_state(self, key, memo, edge_key, width, entry) -> MaintState:
        n = self.live.n
        grid = [(s, min(s + width, n)) for s in range(0, n, width)]
        if memo is not None and memo.chunk == width:
            self.invalidations += 1
            dirty = self.live.dirty_roots_since(memo.edge_key,
                                                entry.plan.depth)
            if dirty is not None:
                idxs = sorted({v // width for v in dirty})
                affected = [grid[i] for i in idxs if i < len(grid)]
                if len(affected) <= self.break_even * len(grid):
                    self.incremental_hits += 1
                    carried = {s: memo.span_totals[s] for s, _ in grid
                               if s not in {a for a, _ in affected}}
                    self.spans_reused += len(carried)
                    return MaintState(
                        spans=list(reversed(affected)), chunk=width,
                        edge_key=edge_key, span_totals=carried,
                        max_needed=memo.max_needed)
            self.full_recounts += 1
        return MaintState(spans=list(reversed(grid)), chunk=width,
                          edge_key=edge_key)
