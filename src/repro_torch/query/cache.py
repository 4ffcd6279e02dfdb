"""PlanCache — memoized planning pipeline for pattern queries.

Port of `repro/query/cache.py` over the port's `Matcher`.  A cold
pattern query pays the configuration search (schedules × restriction
sets × IEP ranked by the perf model), the `MatchingPlan` build and the
matcher's warmup (which builds kernel K1 on a card); the cache pays them
once per *isomorphism class* and replays the warmed matcher afterwards.

Cache key, as in the reference:
  (canonical pattern key,
   graph fingerprint     — CSR content hash + (|V|, |E|, tri_cnt),
   executor fingerprint  — capacity, dynamic_base, kernel path, buckets,
   mode, use_iep,
   layout fingerprint    — ("single", outer-loop chunk width), or
                           ("sharded", "data", stripe chunk,
                            (("data", W),), every rank's device))
The canonical key and the graph fingerprint are byte-equal to the
reference's; the executor fingerprint is `ExecutorConfig.fingerprint()`,
whose `kernel=` facet stands where the reference has `pallas=`.  Given
a `torch.distributed` group (``group=``, the counterpart of the
reference's ``mesh=`` / ``axis=``), entries hold a `ShardedMatcher`
striped over the group's ranks; every rank of the group must then make
the same calls in the same order.
Eviction beyond `max_entries` is LRU, and evicted matchers are
`release()`d.

With a `PlanStore` attached (query/store.py) the cache is load-through /
write-behind: an in-memory miss first consults the on-disk index — a
persisted entry skips the configuration search (`persist_hits`) and
only warms its matcher; a full miss writes the searched result back
after warmup; `preload` (warm-from-disk) installs every compatible
record before the first request (`preloads`).  The store holds no
executables, so the reference's AOT counters (`aot_loads`,
`aot_load_fails`, `export_fails`, `aot_load_seconds`) stay 0 and a
snapshot keeps the reference's keys.  Under a group only rank 0 writes
the store; every rank reads it.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, replace as dc_replace

import torch.distributed as dist

from ..core.config_search import (
    Configuration, graphzero_configuration, search_configuration,
)
from ..core.executor import (
    CountResult, ExecutorConfig, Matcher, ShardedMatcher,
)
from ..core.pattern import Pattern
from ..core.perf_model import GraphStats
from ..core.plan import MatchingPlan, build_plan
from ..graph.csr import GraphCSR
from ..obs import get_tracer, timer
from .canon import canonical_form, canonical_key

MODES = ("graphpi", "graphzero", "naive")

# Default LRU bound for serving engines: each entry pins a warmed matcher,
# so an unbounded cache on an arbitrary request stream is a memory leak.
DEFAULT_MAX_ENTRIES = 256


def executor_fingerprint(cfg: ExecutorConfig) -> str:
    """The ExecutorConfig facets that shape a count program, as the
    stable string `ExecutorConfig.fingerprint()`."""
    return cfg.fingerprint()


def layout_fingerprint(chunk: int | None, cfg: ExecutorConfig, *,
                       group=None, device="cuda") -> tuple:
    """Execution-layout part of the cache key, shaped as the reference's
    `layout_fingerprint(mesh, axis, chunk, cfg)`: on one device the
    outer-loop chunk width; under `group` the stripe chunk, the group's
    one data axis and every rank's device (all-gathered once, so every
    rank builds the same key).  `chunk` is resolved as the matchers
    resolve it, so chunk=None and an explicit default share one
    entry."""
    if group is None:
        return ("single", min(chunk or cfg.capacity, cfg.capacity))
    from ..launch.mesh import group_devices

    return ("sharded", "data", int(chunk or max(64, cfg.capacity // 16)),
            (("data", dist.get_world_size(group)),),
            group_devices(group, device))


def graph_fingerprint(graph: GraphCSR, stats: GraphStats) -> tuple:
    return (graph.fingerprint, stats.n_vertices, stats.n_edges,
            stats.tri_cnt)


def plan_for(pattern: Pattern, stats: GraphStats, *, mode: str = "graphpi",
             use_iep: bool = False) -> tuple[Configuration, MatchingPlan]:
    """(config, plan) for one request — the search and `build_plan` that
    a cache miss runs (`repro/query/cache.py:236-253`), over the
    pattern's canonical form.  Naive plans carry no restrictions: their
    raw count is |Aut| times the answer (`CacheEntry._finish`)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    canon = canonical_form(pattern)
    if mode == "graphpi":
        config = search_configuration(canon, stats, use_iep=use_iep).best
    elif mode == "graphzero":
        config = graphzero_configuration(canon, stats, use_iep=use_iep)
    else:
        config = search_configuration(canon, stats, use_iep=False).best
    res_set = () if mode == "naive" else config.res_set
    return config, build_plan(canon, config.order, res_set,
                              iep_k=config.iep_k)


@dataclass
class CacheEntry:
    canon_key: str
    pattern: Pattern            # canonical labeling
    config: Configuration
    plan: MatchingPlan
    matcher: object             # warmed Matcher | ShardedMatcher
    sharded: bool
    mode: str
    search_seconds: float
    compile_seconds: float      # the matcher's warmup (K1 build on a card)
    hits: int = 0
    executions: int = 0         # completed counts (coalescing evidence:
                                # N same-class tickets in one round → +1)

    def count(self, *, chunk: int | None = None) -> CountResult:
        """Run the cached matcher to completion.  `chunk` stripes the
        outer loop on one device; a sharded matcher fixed its stripes
        when it was built."""
        if self.sharded:
            return self._finish(self.matcher.count())
        return self._finish(self.matcher.count(chunk=chunk))

    def count_partial(self, state=None, *, chunk: int | None = None,
                      max_dispatches: int | None = None):
        """Preemptible execution: run up to `max_dispatches` dispatches
        and return ``(state, result)`` — result None while work remains
        (pass state back in to resume; the completed count is
        bit-identical to :meth:`count`).  A sharded count is one
        collective pass (or a few, escalating), so it ignores the budget
        and always completes with state None."""
        if self.sharded:
            return None, self._finish(self.matcher.count())
        state, out = self.matcher.count_partial(
            state, chunk=chunk, max_dispatches=max_dispatches)
        return state, (None if out is None else self._finish(out))

    def _finish(self, out: CountResult) -> CountResult:
        if self.mode == "naive":
            # no restrictions in the plan: every embedding found |Aut| times
            out = dc_replace(out, count=out.count // self.pattern.aut_count())
        return out


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0              # in-memory misses
    n_searches: int = 0          # configuration searches actually run
    n_compiles: int = 0          # matcher warmups
    evictions: int = 0
    persist_hits: int = 0        # misses served from the on-disk store
    preloads: int = 0            # entries installed by warm-from-disk
    aot_loads: int = 0           # no executables in the port's store:
    aot_load_fails: int = 0      # these three stay 0
    export_fails: int = 0
    search_seconds: float = 0.0
    compile_seconds: float = 0.0
    aot_load_seconds: float = 0.0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class PlanCache:
    """LRU cache of warmed (Configuration, MatchingPlan, Matcher) triples,
    optionally backed by a persistent on-disk `PlanStore`."""

    def __init__(self, *, max_entries: int | None = None, store=None):
        self.max_entries = max_entries
        self.store = store                    # PlanStore | None
        self.stats = CacheStats()
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> list[CacheEntry]:
        return list(self._entries.values())

    @staticmethod
    def entry_key(pattern: Pattern, graph_fp: tuple, cfg: ExecutorConfig,
                  *, mode: str = "graphpi", use_iep: bool = False,
                  layout_fp: tuple | None = None) -> tuple:
        if layout_fp is None:
            layout_fp = layout_fingerprint(None, cfg)
        # naive ignores use_iep (it always searches without IEP), so the
        # flag must not split one program into two entries
        use_iep = bool(use_iep) and mode != "naive"
        return (canonical_key(pattern), graph_fp,
                executor_fingerprint(cfg), mode, use_iep, layout_fp)

    def get_or_build(
        self,
        pattern: Pattern,
        graph: GraphCSR,
        stats: GraphStats,
        *,
        cfg: ExecutorConfig | None = None,
        mode: str = "graphpi",
        use_iep: bool = False,
        chunk: int | None = None,
        arrays=None,
        device="cuda",
        group=None,
        warm: bool = True,
        graph_fp: tuple | None = None,
    ) -> tuple[CacheEntry, bool]:
        """Return (entry, was_hit).  Misses run the configuration search
        (or load it from the store), build the plan and (when `warm`)
        warm the matcher on `device` before the entry becomes visible —
        a hit never searches or warms.  With `group` the matcher is a
        `ShardedMatcher` over its ranks (`chunk` = stripe chunk).
        `graph_fp` overrides the graph facet of the key: live engines
        pass their `EpochStamp.plan_key` (stable across edge mutations)
        so plans survive churn."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; have {MODES}")
        cfg = cfg or ExecutorConfig()
        key = self.entry_key(
            pattern,
            graph_fp if graph_fp is not None
            else graph_fingerprint(graph, stats),
            cfg, mode=mode, use_iep=use_iep,
            layout_fp=layout_fingerprint(chunk, cfg, group=group,
                                         device=device),
        )
        entry = self._entries.get(key)
        if entry is not None:
            self.stats.hits += 1
            entry.hits += 1
            self._entries.move_to_end(key)
            return entry, True

        self.stats.misses += 1
        # load-through: a persisted entry skips the configuration search
        if self.store is not None:
            rec = self.store.load(key)
            if rec is not None:
                self.stats.persist_hits += 1
                entry = self._install_record(rec, key, graph, cfg=cfg,
                                             chunk=chunk, arrays=arrays,
                                             device=device, group=group,
                                             warm=warm)
                self._insert(key, entry)
                return entry, False

        with get_tracer().span("cache.search", canon_key=key[0],
                               mode=mode), timer() as t:
            config, plan = plan_for(pattern, stats, mode=mode,
                                    use_iep=use_iep)
        search_s = t.seconds
        self.stats.n_searches += 1
        self.stats.search_seconds += search_s

        matcher, compile_s = self._matcher(
            "cache.compile", plan, key, graph, cfg=cfg, chunk=chunk,
            arrays=arrays, device=device, group=group, warm=warm)
        entry = CacheEntry(
            canon_key=key[0], pattern=plan.pattern, config=config,
            plan=plan, matcher=matcher, sharded=group is not None,
            mode=mode, search_seconds=search_s, compile_seconds=compile_s,
        )
        # write-behind: persist the searched result (plan-only; under a
        # group rank 0 alone writes, after every rank built the matcher
        # and so had read the store for this key)
        if self.store is not None and (group is None
                                       or dist.get_rank(group) == 0):
            self.store.save(key, pattern=plan.pattern, config=config,
                            plan=plan, search_seconds=search_s,
                            compile_seconds=compile_s)
        self._insert(key, entry)
        return entry, False

    # -------------------------------------------------------- persistence
    def _matcher(self, span: str, plan: MatchingPlan, key: tuple,
                 graph: GraphCSR, *, cfg: ExecutorConfig, chunk: int | None,
                 arrays, device, group, warm: bool) -> tuple[object, float]:
        """A matcher for `plan` (sharded over `group` when given), warmed
        (and counted as a compile) when `warm`; returns it with the
        warmup's seconds."""
        if group is not None:
            matcher = ShardedMatcher(graph, plan, group, cfg=cfg,
                                     chunk=chunk, arrays=arrays,
                                     device=device)
        else:
            matcher = Matcher(graph, plan, cfg, arrays=arrays, device=device)
        compile_s = 0.0
        if warm:
            with get_tracer().span(span, canon_key=key[0], mode=key[3]), \
                    timer() as t:
                if group is not None:
                    matcher.warmup()      # the chunk is in the stripes
                else:
                    matcher.warmup(chunk=chunk)
            compile_s = t.seconds
            self.stats.n_compiles += 1
            self.stats.compile_seconds += compile_s
        return matcher, compile_s

    def _install_record(self, rec, key: tuple, graph: GraphCSR, *,
                        cfg: ExecutorConfig, chunk: int | None, arrays,
                        device, group=None, warm: bool) -> CacheEntry:
        """Turn a loaded StoreRecord into a live warmed entry: no
        configuration search; the matcher's warmup counts as a compile,
        as in the reference's fallback when no executable installs."""
        matcher, compile_s = self._matcher(
            "cache.warm", rec.plan, key, graph, cfg=cfg, chunk=chunk,
            arrays=arrays, device=device, group=group, warm=warm)
        return CacheEntry(
            canon_key=key[0], pattern=rec.pattern, config=rec.config,
            plan=rec.plan, matcher=matcher, sharded=group is not None,
            mode=rec.mode, search_seconds=0.0, compile_seconds=compile_s,
        )

    def preload(self, graph: GraphCSR, stats: GraphStats, *,
                cfg: ExecutorConfig | None = None, chunk: int | None = None,
                arrays=None, device="cuda", group=None, warm: bool = True,
                graph_fp: tuple | None = None) -> int:
        """Warm-from-disk: install every store record compatible with the
        current serving context (same graph/executor/layout fingerprints
        — checked by re-deriving each record's key digest) before the
        first request arrives.  Returns the number of entries installed.
        `group` and `graph_fp` as in :meth:`get_or_build`."""
        if self.store is None:
            return 0
        from .store import key_digest

        cfg = cfg or ExecutorConfig()
        gfp = (graph_fp if graph_fp is not None
               else graph_fingerprint(graph, stats))
        lfp = layout_fingerprint(chunk, cfg, group=group, device=device)
        installed = 0
        for rec in self.store.records():
            key = self.entry_key(rec.pattern, gfp, cfg, mode=rec.mode,
                                 use_iep=rec.use_iep, layout_fp=lfp)
            if key_digest(key) != rec.digest or key in self._entries:
                continue
            self.stats.preloads += 1
            self._insert(key, self._install_record(
                rec, key, graph, cfg=cfg, chunk=chunk, arrays=arrays,
                device=device, group=group, warm=warm))
            installed += 1
        return installed

    def _insert(self, key: tuple, entry: CacheEntry) -> None:
        self._entries[key] = entry
        if self.max_entries is not None:
            while len(self._entries) > self.max_entries:
                _, evicted = self._entries.popitem(last=False)
                # drop the warmed matcher's count functions and device
                # references now, not whenever GC reaches the cycle
                # (max_entries=0 pops `entry` itself — the caller is
                # about to count on it, so it must stay live)
                if evicted is not entry:
                    evicted.matcher.release()
                self.stats.evictions += 1
