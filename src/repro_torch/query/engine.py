"""QueryEngine — the batched pattern-count request path on one device.

Port of `repro/query/engine.py`.  The engine loads a dataset once: the
CSR is uploaded to the device a single time (shared by every cached
matcher through ``arrays=``) and graph statistics are computed once at
startup.  Requests then stream through the `PlanCache`: the first query
of an isomorphism class pays configuration search and warmup, repeats
replay the warmed matcher.

Request surface, as in the reference:

  * ``plan(request)``    — cache/plan resolution only (search + warmup
                           on a miss); never executes a count.
  * ``enqueue(request)`` — admit a request, returning a :class:`Ticket`
                           that resolves later (raises
                           :class:`AdmissionRejected` past the
                           per-tenant depth bound; ``try_enqueue``
                           returns the :class:`Rejection` instead).
  * ``run_pending(limit)`` — execute up to ``limit`` queued tickets as
                           one round, COALESCING tickets of the same
                           isomorphism class (× mode × use_iep) into a
                           single plan execution; the N−1 riders are
                           accounted as cache hits.

Tenants: queued tickets live in per-tenant FIFO queues drained by
deterministic weighted round-robin (``tenant_shares``), each bounded by
``tenant_depth``.  Preemption: with ``preempt_dispatches=k`` a round
issues at most `k` dispatches of the chunked outer loop; a class still
mid-count checkpoints its span stack (`CountState`) and resumes in a
later round, rotated behind other waiting classes, bit-identically.

Persistence: with a `PlanStore` (``store=``, or a cache built with
one) plans are loaded through and written behind, graph statistics are
read from the store at startup, and ``warm_from_disk()`` preloads every
compatible record, so a restarted replica runs no configuration search.

Live graph: ``live=True`` (or a prebuilt `DeltaOverlay`) serves over a
mutable graph.  ``request_mutation`` queues insert/delete/compact verbs
that apply atomically at round boundaries; every cached matcher then
swaps in the new epoch's tensors by `Matcher.rebind` (no re-search, no
rebuild while the overlay's fixed shapes hold), plans key on the
stats-epoch plan key, and a `CountMaintainer` memoizes counts on the
edge-epoch key and recounts only dirty root spans.

The constructor takes ``device=`` (default ``"cuda"``, which raises
without a card) where the reference takes ``mesh=`` / ``axis=``;
`ShardedMatcher` waits for the multi-GPU slice.
"""
from __future__ import annotations

import warnings
from collections import deque
from dataclasses import dataclass

from ..core.executor import (ExecutorConfig, Matcher, compute_stats,
                             device_graph)
from ..core.pattern import Pattern
from ..core.perf_model import GraphStats
from ..device import resolve_device
from ..graph.csr import GraphCSR
from ..live import (CompactionPolicy, CountMaintainer, DeltaOverlay,
                    EpochStamp, maybe_compact, stats_drifted)
from ..obs import MetricsRegistry, get_tracer, latency_summary, timer
from .cache import DEFAULT_MAX_ENTRIES, CacheEntry, PlanCache
from .canon import canonical_key

DEFAULT_TENANT = "default"


@dataclass(frozen=True)
class QueryRequest:
    """One pattern-count request (per-request options ride along)."""

    pattern: Pattern
    use_iep: bool = False
    verify: bool = False          # check against the pure-python oracle
    mode: str = "graphpi"
    tenant: str = DEFAULT_TENANT  # multi-tenant queue / fairness id


@dataclass
class QueryResult:
    pattern_name: str
    canon_key: str
    count: int
    latency_s: float              # wall time incl. cache miss costs
    cache_hit: bool
    mode: str
    use_iep: bool
    order: tuple
    res_set: tuple
    iep_k: int
    search_seconds: float         # 0.0 on a hit
    compile_seconds: float        # 0.0 on a hit
    overflowed: bool
    max_needed: int
    expected: int | None = None   # oracle count when verified
    verified: bool | None = None  # None = not requested
    coalesced: bool = False       # resolved by another ticket's execution

    def line(self) -> str:
        """One human-readable serving-log line."""
        v = ("" if self.verified is None
             else ("  verify=OK" if self.verified else "  verify=MISMATCH"))
        o = "  OVERFLOWED" if self.overflowed else ""
        how = "HIT " if self.cache_hit else "MISS"
        if self.coalesced:
            how = "COAL"
        return (f"{self.pattern_name:<16} count={self.count:<12} "
                f"{how} "
                f"lat={self.latency_s * 1e3:8.1f}ms "
                f"(search={self.search_seconds:.3f}s "
                f"compile={self.compile_seconds:.3f}s){v}{o}")


@dataclass(frozen=True)
class PlannedQuery:
    """What ``plan()`` resolves: the warmed cache entry plus whether the
    resolution was a cache hit (misses paid search and warmup just now)."""

    entry: CacheEntry
    cache_hit: bool


@dataclass(frozen=True)
class Rejection:
    """Why admission control refused a request (deterministic, counted)."""

    tenant: str
    reason: str
    depth: int                    # tenant's queue depth at rejection time
    limit: int                    # the configured bound it hit


class AdmissionRejected(RuntimeError):
    """Raised by :meth:`QueryEngine.enqueue` when a tenant's queue is at
    its depth bound; carries the structured :class:`Rejection`."""

    def __init__(self, rejection: Rejection):
        super().__init__(
            f"tenant {rejection.tenant!r} rejected: {rejection.reason} "
            f"(depth={rejection.depth}, limit={rejection.limit})")
        self.rejection = rejection


@dataclass
class Ticket:
    """Handle for an enqueued request; resolves when a round executes it
    (``QueryEngine.run_pending`` or the Gateway's graph workload)."""

    request: QueryRequest
    seq: int
    _result: QueryResult | None = None
    cancelled: bool = False

    @property
    def done(self) -> bool:
        return self._result is not None

    @property
    def result(self) -> QueryResult:
        if self._result is None:
            raise RuntimeError(
                f"ticket #{self.seq} not resolved yet — run the engine's "
                f"pending queue (run_pending) or schedule it via the Gateway")
        return self._result


@dataclass
class _InFlight:
    """One isomorphism-class group mid-round: its tickets, the resolved
    plan (lazy), and the resumable count checkpoint (`CountState`) when a
    preemption budget suspended it between dispatches."""

    key: tuple
    tickets: list
    planned: PlannedQuery | None = None
    state: object | None = None   # core.executor.CountState when started
    seconds: float = 0.0          # accumulated plan + execute wall time


class QueryEngine:
    """Serve pattern-count queries over one resident graph on one device.

    Parameters
    ----------
    graph:   the data graph, uploaded once.
    cfg:     executor configuration shared by every cached matcher
             (part of the cache key).
    chunk:   vertex-chunk striping of the outer loop — smaller chunks
             bound frontier memory and give preemption finer grain at the
             price of more dispatches per query.
    device:  where the graph lives and counts run (default ``"cuda"``;
             ``"cpu"`` only when asked).
    tenant_depth:  admission bound — max queued tickets per tenant;
             ``None`` (default) admits everything.
    tenant_shares: tickets drained per tenant per take-cycle of the
             weighted round-robin (missing tenants weigh 1).
    preempt_dispatches: default per-round dispatch budget; a class still
             mid-count when the budget runs out is checkpointed and
             rotated behind other waiting classes.  ``None`` = run every
             class in the round to completion.
    store:   optional `PlanStore` attached to the cache (persistence).
    live:    ``True`` (or a prebuilt `DeltaOverlay`) serves over a
             MUTABLE graph (see the module docstring).
    compaction_policy: live-mode thresholds (`live.CompactionPolicy`).
    """

    def __init__(self, graph: GraphCSR, *, cfg: ExecutorConfig | None = None,
                 chunk: int | None = None, device="cuda",
                 cache: PlanCache | None = None,
                 store=None,
                 stats: GraphStats | None = None,
                 metrics: MetricsRegistry | None = None,
                 tenant_depth: int | None = None,
                 tenant_shares: dict[str, int] | None = None,
                 preempt_dispatches: int | None = None,
                 live=None,
                 compaction_policy: CompactionPolicy | None = None):
        if live is True:
            live = DeltaOverlay(graph)
        elif live is not None and not isinstance(live, DeltaOverlay):
            raise TypeError(
                f"live must be True or a DeltaOverlay, got {type(live)!r}")
        self.live = live
        if live is not None:
            graph = live.view              # executor-facing adjacency
        self.graph = graph
        self.cfg = cfg or ExecutorConfig()
        self.chunk = chunk
        self.device = resolve_device(device)
        if cache is None:
            cache = PlanCache(max_entries=DEFAULT_MAX_ENTRIES, store=store)
        elif store is not None and cache.store is None:
            cache.store = store            # attach persistence to the
        self.cache = cache                 # caller-provided cache
        self._arrays = device_graph(graph, self.device)   # ONE upload
        with timer() as t:
            if stats is None:
                # a restarted engine skips the startup triangle count when
                # the store has a stats record for this exact graph
                if self.cache.store is not None:
                    stats = self.cache.store.load_graph_stats(
                        graph.fingerprint)
                if stats is None:
                    stats = compute_stats(graph, self.cfg,
                                          device=self.device,
                                          arrays=self._arrays)
                    if self.cache.store is not None:
                        self.cache.store.save_graph_stats(
                            graph.fingerprint, stats)
        self.stats = stats
        self.stats_seconds = t.seconds
        # round-boundary epoch identity: serving code carries THIS stamp,
        # never raw fingerprints
        self._epoch = (EpochStamp.for_live(live, stats) if live is not None
                       else EpochStamp.legacy(graph, stats))
        self._maintainer = (CountMaintainer(live) if live is not None
                            else None)
        self.compaction_policy = compaction_policy or CompactionPolicy()
        self._mutations: deque = deque()       # queued (verb, edges) batches
        self.mutations_applied = 0             # effective edge changes
        self.last_round_mutations = 0          # batches applied last round
        self.matcher_rebinds = 0               # epoch swaps, no rebuild
        self.matcher_rebuilds = 0              # shape-growth rebuilds
        # registries are per-engine; launchers that want one pane pass a
        # shared instance
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._lat_hist = self.metrics.histogram("engine.query_latency_ms")
        self.metrics.register_collector(self._collect)
        self._edges = None                     # lazy, for oracle verification
        self._oracle: dict[str, int] = {}      # canon_key -> oracle count
        self._queues: dict[str, deque] = {}    # tenant -> FIFO of Tickets
        self._inflight: deque = deque()        # _InFlight groups, mid-round
        self._seq = 0
        self.tenant_depth = tenant_depth
        self.tenant_shares = dict(tenant_shares or {})
        self.preempt_dispatches = preempt_dispatches
        # round-execution counters (the coalescing/preemption evidence)
        self.requests_resolved = 0
        self.executions = 0                    # completed class executions
        self.coalesced = 0                     # tickets riding an execution
        self.preemptions = 0                   # groups suspended mid-count
        self.last_round_dispatches = 0         # dispatches last round
        self.rejections: dict[str, int] = {}   # tenant -> admission rejects
        self._resolved_by_tenant: dict[str, int] = {}

    def _collect(self) -> dict:
        """Engine, cache, store and live counters for
        `metrics.snapshot()`."""
        out = {
            "engine.requests_resolved": self.requests_resolved,
            "engine.executions": self.executions,
            "engine.coalesced": self.coalesced,
            "engine.pending": self.pending(),
            "engine.inflight": self.inflight(),
            "engine.preemptions": self.preemptions,
            "engine.admission_rejected": sum(self.rejections.values()),
            "engine.cache_entries": len(self.cache),
        }
        for k, v in self.cache.stats.as_dict().items():
            out[f"cache.{k}"] = v
        if self.cache.store is not None:
            for k, v in self.cache.store.stats.as_dict().items():
                out[f"store.{k}"] = v
        if self.live is not None:
            out.update({
                "live.epoch": self.live.edge_epoch,
                "live.stats_epoch": self.live.stats_epoch,
                "live.overlay_edges": self.live.overlay_edges(),
                "live.compactions": self.live.compactions,
                "live.mutations_applied": self.mutations_applied,
                "live.pending_mutations": len(self._mutations),
                "live.matcher_rebinds": self.matcher_rebinds,
                "live.matcher_rebuilds": self.matcher_rebuilds,
            })
            for k, v in self._maintainer.counters().items():
                out[f"live.{k}"] = v
        return out

    # ------------------------------------------------------ async serving
    def plan(self, request: QueryRequest) -> PlannedQuery:
        """Cache/plan resolution ONLY — search + plan build + warmup on a
        miss, pure lookup on a hit.  Never executes a count."""
        with get_tracer().span(
                "engine.plan", pattern=request.pattern.name or "anon",
                mode=request.mode) as sp:
            entry, hit = self.cache.get_or_build(
                request.pattern, self.graph, self.stats,
                cfg=self.cfg, mode=request.mode, use_iep=request.use_iep,
                chunk=self.chunk, arrays=self._arrays, device=self.device,
                graph_fp=self._epoch.plan_key,
            )
            sp.set(cache_hit=hit, canon_key=entry.canon_key)
        return PlannedQuery(entry=entry, cache_hit=hit)

    def try_enqueue(self, request: QueryRequest) -> Ticket | Rejection:
        """Admission-controlled enqueue: returns a :class:`Ticket`, or a
        :class:`Rejection` when the request's tenant already has
        ``tenant_depth`` tickets queued (deterministic, counted per
        tenant)."""
        tenant = request.tenant
        q = self._queues.setdefault(tenant, deque())
        if self.tenant_depth is not None and len(q) >= self.tenant_depth:
            self.rejections[tenant] = self.rejections.get(tenant, 0) + 1
            self.metrics.counter("engine.admission_rejected",
                                 tenant=tenant).inc()
            return Rejection(tenant=tenant, reason="queue depth bound",
                             depth=len(q), limit=self.tenant_depth)
        ticket = Ticket(request=request, seq=self._seq)
        self._seq += 1
        q.append(ticket)
        return ticket

    def enqueue(self, request: QueryRequest) -> Ticket:
        """Admit a request; the returned ticket resolves when a round
        executes it.  Raises :class:`AdmissionRejected` past the tenant
        depth bound."""
        out = self.try_enqueue(request)
        if isinstance(out, Rejection):
            raise AdmissionRejected(out)
        return out

    def cancel(self, ticket: Ticket) -> bool:
        """Withdraw a still-queued ticket.  Returns False when the ticket
        already resolved, was cancelled before, or is mid-execution in an
        in-flight group (a dispatched count is not torn down)."""
        if ticket.done or ticket.cancelled:
            return False
        q = self._queues.get(ticket.request.tenant)
        if q is None or ticket not in q:
            return False
        q.remove(ticket)
        ticket.cancelled = True
        return True

    def pending(self, tenant: str | None = None) -> int:
        """Queued (not yet taken into a round) tickets — one tenant or
        all."""
        if tenant is not None:
            return len(self._queues.get(tenant, ()))
        return sum(len(q) for q in self._queues.values())

    def inflight(self) -> int:
        """Tickets taken into a round whose class is still mid-count."""
        return sum(len(f.tickets) for f in self._inflight)

    # --------------------------------------------------------- mutation
    def mutations_pending(self) -> int:
        """Queued mutation batches (0 for non-live engines — safe for
        schedulers to poll unconditionally)."""
        return len(self._mutations)

    def request_mutation(self, verb: str, edges=None) -> dict:
        """Queue one mutation batch (`insert_edges` / `delete_edges` /
        `compact`).  Batches apply atomically at the START of the next
        round — never under an in-flight `CountState` — so a query
        submitted after this call is answered on the post-mutation
        epoch.  Returns an ack with the queue depth and current epoch."""
        if self.live is None:
            raise RuntimeError(
                "engine is not live: construct QueryEngine(..., live=True) "
                "to serve mutate verbs")
        from ..live import MUTATION_VERBS

        if verb not in MUTATION_VERBS:
            raise ValueError(
                f"unknown mutation verb {verb!r}; have {MUTATION_VERBS}")
        batch = None
        if verb != "compact":
            batch = [(int(e[0]), int(e[1])) for e in (edges or ())]
        self._mutations.append((verb, batch))
        return {
            "verb": verb,
            "queued_edges": 0 if batch is None else len(batch),
            "pending_batches": len(self._mutations),
            "edge_epoch": self.live.edge_epoch,
        }

    def _apply_mutations(self) -> int:
        """Drain the mutation queue at a round boundary.

        In-flight groups are RE-ENQUEUED (their tickets return to the
        head of their tenant queues in admission order and the partial
        states are dropped): a preempted count never resumes across an
        epoch, so every resolved count is computed on one epoch."""
        live = self.live
        batches = len(self._mutations)
        requeue = [t for fl in self._inflight for t in fl.tickets]
        with get_tracer().span("engine.mutate", batches=batches,
                               requeued=len(requeue)):
            self._inflight.clear()
            for t in sorted(requeue, key=lambda t: t.seq, reverse=True):
                self._queues.setdefault(t.request.tenant,
                                        deque()).appendleft(t)
            applied = 0
            while self._mutations:
                verb, batch = self._mutations.popleft()
                applied += live.apply(verb, batch)
            maybe_compact(live, self.compaction_policy)
            if stats_drifted(live, self.stats, self.compaction_policy):
                # |E| moved materially: plans stay valid but their
                # perf-model ranking is stale — bump the stats epoch so
                # the next plan() re-searches under fresh statistics
                live.stats_epoch += 1
                self.stats = compute_stats(live.view, self.cfg,
                                           device=self.device)
                if self.cache.store is not None:
                    self.cache.store.save_graph_stats(
                        live.view.fingerprint, self.stats)
            self._refresh_live()
        self.mutations_applied += applied
        self.last_round_mutations = batches
        if self.cache.store is not None:
            self.cache.store.save_overlay(live.to_record())
        return applied

    def _refresh_live(self) -> None:
        """Swap the new epoch's view and device tensors into the engine
        and every cached matcher.  The overlay's fixed shapes make this a
        `Matcher.rebind`; genuine growth rebuilds a matcher (counted in
        `cache.stats.n_compiles` and `matcher_rebuilds`)."""
        live = self.live
        view = live.view
        arrays = device_graph(view, self.device)
        for entry in self.cache.entries():
            try:
                entry.matcher.rebind(arrays, graph=view)
                self.matcher_rebinds += 1
            except ValueError:
                matcher = Matcher(view, entry.plan, self.cfg, arrays=arrays,
                                  device=self.device)
                matcher.warmup(chunk=self.chunk)
                self.cache.stats.n_compiles += 1
                entry.matcher.release()
                entry.matcher = matcher
                self.matcher_rebuilds += 1
        self.graph = view
        self._arrays = arrays
        self._epoch = EpochStamp.for_live(live, self.stats)
        # oracle memos are content-addressed to the old epoch
        self._oracle.clear()
        self._edges = None

    @staticmethod
    def _group_key(request: QueryRequest) -> tuple:
        # mirrors PlanCache.entry_key: naive ignores use_iep
        use_iep = bool(request.use_iep) and request.mode != "naive"
        return (canonical_key(request.pattern), request.mode, use_iep)

    def _take_tickets(self, limit: int | None) -> list[Ticket]:
        """Drain up to ``limit`` tickets by deterministic weighted
        round-robin: tenants in first-seen order, each yielding up to
        ``tenant_shares[tenant]`` (default 1) tickets per cycle.  A single
        tenant degenerates to exact FIFO."""
        out: list[Ticket] = []
        while limit is None or len(out) < limit:
            progressed = False
            for tenant, q in self._queues.items():
                share = max(int(self.tenant_shares.get(tenant, 1)), 1)
                for _ in range(share):
                    if not q or (limit is not None and len(out) >= limit):
                        break
                    out.append(q.popleft())
                    progressed = True
            if not progressed:
                break
        return out

    def run_pending(self, limit: int | None = None, *,
                    max_dispatches: int | None = None) -> list[Ticket]:
        """Execute up to ``limit`` queued tickets as ONE round.

        Tickets of one isomorphism class (and mode/use_iep) are
        coalesced: the class is planned and executed once and every rider
        resolves with that count, accounted as a cache hit.  With a
        dispatch budget (``max_dispatches`` here, or the engine's
        ``preempt_dispatches``) the round is preemptive: once the budget
        is spent the mid-count class checkpoints and rotates to the back
        of the in-flight queue.  Returns the tickets resolved THIS round,
        in admission order."""
        if limit is not None and limit < 0:
            raise ValueError(f"limit must be >= 0, got {limit}")
        budget_n = (self.preempt_dispatches if max_dispatches is None
                    else max_dispatches)
        remaining = None if budget_n is None else max(int(budget_n), 1)
        self.last_round_dispatches = 0
        self.last_round_mutations = 0
        if self._mutations:
            # round boundary: apply queued mutations BEFORE taking
            # tickets, so everything executed below runs on one epoch
            self._apply_mutations()
        take = self._take_tickets(limit)
        fresh = 0
        for t in take:
            key = self._group_key(t.request)
            fl = next((f for f in self._inflight if f.key == key), None)
            if fl is not None:
                fl.tickets.append(t)       # same class mid-round: ride it
            else:
                self._inflight.append(_InFlight(key=key, tickets=[t]))
                fresh += 1
        if not self._inflight:
            return []
        resolved: list[Ticket] = []
        with get_tracer().span("engine.round", tickets=len(take),
                               groups=fresh,
                               coalesced=len(take) - fresh,
                               budget=-1 if remaining is None else remaining):
            while self._inflight:
                if remaining is not None and remaining <= 0:
                    break
                fl = self._inflight.popleft()
                done, used = self._run_group(fl, remaining)
                self.last_round_dispatches += used
                if remaining is not None:
                    remaining -= used
                if done:
                    resolved.extend(fl.tickets)
                else:
                    # suspended mid-count: rotate BEHIND other waiting
                    # classes so they complete between this one's quanta
                    self.preemptions += 1
                    self._inflight.append(fl)
        resolved.sort(key=lambda t: t.seq)
        return resolved

    def _run_group(self, fl: _InFlight,
                   remaining: int | None) -> tuple[bool, int]:
        """Start or resume one class group under a dispatch budget.
        Returns (completed, dispatches_used); on completion every ticket
        in the group is resolved with the final count."""
        lead = fl.tickets[0].request
        if fl.planned is None:
            with timer() as t_plan:
                fl.planned = self.plan(lead)
            fl.seconds += t_plan.seconds
        entry, hit = fl.planned.entry, fl.planned.cache_hit
        before = 0 if fl.state is None else fl.state.dispatches
        with get_tracer().span(
                "engine.execute", pattern=lead.pattern.name or "anon",
                canon_key=entry.canon_key, cache_hit=hit,
                riders=len(fl.tickets) - 1,
                resumed=fl.state is not None):
            with timer() as t_run:
                if self._maintainer is not None:
                    fl.state, out = self._maintainer.count_partial(
                        fl.key, entry, fl.state, chunk=self.chunk,
                        max_dispatches=remaining)
                else:
                    fl.state, out = entry.count_partial(
                        fl.state, chunk=self.chunk, max_dispatches=remaining)
            fl.seconds += t_run.seconds
        used = max(fl.state.dispatches - before, 0)
        if out is None:
            return False, used
        entry.executions += 1
        self.executions += 1
        latency = fl.seconds

        expected = None
        if any(t.request.verify for t in fl.tickets):
            with get_tracer().span("engine.verify",
                                   canon_key=entry.canon_key):
                expected = self._oracle_count(entry.canon_key,
                                              lead.pattern)
        for j, t in enumerate(fl.tickets):
            self._lat_hist.observe(latency * 1e3)
            self.metrics.histogram("engine.query_latency_ms",
                                   tenant=t.request.tenant).observe(
                                       latency * 1e3)
            self.requests_resolved += 1
            self._resolved_by_tenant[t.request.tenant] = (
                self._resolved_by_tenant.get(t.request.tenant, 0) + 1)
            if j > 0:
                # a coalesced rider is a logical cache hit: served without
                # a search, a warmup or its own dispatch
                self.cache.stats.hits += 1
                entry.hits += 1
                self.coalesced += 1
            verified = (expected == out.count
                        if t.request.verify and expected is not None else None)
            t._result = QueryResult(
                pattern_name=t.request.pattern.name or "anon",
                canon_key=entry.canon_key,
                count=out.count,
                latency_s=latency,
                cache_hit=hit if j == 0 else True,
                mode=t.request.mode,
                use_iep=t.request.use_iep,
                order=entry.config.order,
                res_set=entry.plan.res_set,
                iep_k=entry.config.iep_k,
                search_seconds=0.0 if (hit or j > 0) else entry.search_seconds,
                compile_seconds=0.0 if (hit or j > 0)
                else entry.compile_seconds,
                overflowed=out.overflowed,
                max_needed=out.max_needed,
                expected=expected if t.request.verify else None,
                verified=verified,
                coalesced=j > 0,
            )
        return True, used

    def _oracle_count(self, canon_key: str, pattern: Pattern) -> int:
        # oracle counts are (label-)isomorphism-invariant — memoize per
        # class; the canonical key already separates label variants
        if canon_key not in self._oracle:
            from ..core.oracle import count_embeddings_oracle

            if self._edges is None:
                self._edges = self.graph.edge_array()
            self._oracle[canon_key] = count_embeddings_oracle(
                self.graph.n, self._edges, pattern,
                labels=self.graph.labels)
        return self._oracle[canon_key]

    # ------------------------------------------- deprecated sync serving
    def submit(self, request: QueryRequest) -> QueryResult:
        """Deprecated synchronous path: one request, one round (earlier
        tickets, if any, resolve first, one per round)."""
        warnings.warn(
            "QueryEngine.submit() is deprecated; use plan()/enqueue() with "
            "run_pending()", DeprecationWarning, stacklevel=2)
        ticket = self.enqueue(request)
        while not ticket.done and (self.pending() or self.inflight()):
            self.run_pending(limit=1)
        return ticket.result

    def serve(self, requests) -> list[QueryResult]:
        """Deprecated synchronous path: each request is its own round
        (sequential, no coalescing)."""
        warnings.warn(
            "QueryEngine.serve() is deprecated; enqueue() tickets and run "
            "run_pending()", DeprecationWarning, stacklevel=2)
        out = []
        for r in requests:
            ticket = self.enqueue(r)
            while not ticket.done and (self.pending() or self.inflight()):
                self.run_pending(limit=1)
            out.append(ticket.result)
        return out

    def warm_from_disk(self) -> int:
        """Preload every persisted plan compatible with this engine's
        (graph, executor, layout) before the first request arrives, so a
        restarted replica serves warm from query one.  Returns the
        number of entries installed (0 without an attached store)."""
        return self.cache.preload(
            self.graph, self.stats, cfg=self.cfg, chunk=self.chunk,
            arrays=self._arrays, device=self.device,
            graph_fp=self._epoch.plan_key)

    # ------------------------------------------------------------- reporting
    def latency_percentiles(self, tenant: str | None = None) -> dict:
        """Per-query wall-latency summary (n / p50_ms / p95_ms / p99_ms /
        mean_ms), all tenants or one."""
        if tenant is None:
            return latency_summary(self._lat_hist)
        return latency_summary(
            self.metrics.histogram("engine.query_latency_ms", tenant=tenant))

    def tenant_report(self) -> dict:
        """Per-tenant resolved / rejected / queued depths and latency."""
        tenants = sorted(set(self._queues)
                         | set(self._resolved_by_tenant)
                         | set(self.rejections))
        out = {}
        for t in tenants:
            out[t] = {
                "resolved": self._resolved_by_tenant.get(t, 0),
                "rejected": self.rejections.get(t, 0),
                "pending": self.pending(t),
                "share": max(int(self.tenant_shares.get(t, 1)), 1),
                "latency": self.latency_percentiles(t),
            }
        return out

    def summary(self) -> dict:
        out = {
            "graph": self.graph.name,
            "devices": 1,
            "device": str(self.device),
            "stats_seconds": self.stats_seconds,
            "latency": self.latency_percentiles(),
            "cache": self.cache.stats.as_dict(),
            "cache_entries": len(self.cache),
            "requests_resolved": self.requests_resolved,
            "executions": self.executions,
            "coalesced": self.coalesced,
            "preemptions": self.preemptions,
            "rejections": sum(self.rejections.values()),
            "tenants": self.tenant_report(),
        }
        if self.cache.store is not None:
            out["store"] = self.cache.store.stats.as_dict()
        if self.live is not None:
            out["live"] = {
                "edge_epoch": self.live.edge_epoch,
                "stats_epoch": self.live.stats_epoch,
                "overlay_edges": self.live.overlay_edges(),
                "compactions": self.live.compactions,
                "mutations_applied": self.mutations_applied,
                "matcher_rebinds": self.matcher_rebinds,
                "matcher_rebuilds": self.matcher_rebuilds,
                **self._maintainer.counters(),
            }
        return out
