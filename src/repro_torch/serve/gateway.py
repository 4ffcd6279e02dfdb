"""The serving front door: one Gateway, one device, many workloads.

Counterpart of `repro/serve/gateway.py` on one device.  The Gateway is
the single object that owns the process's device and co-schedules
heterogeneous tenants on it:

    gw = Gateway(device=torch.device("cuda"))
    graph = gw.add(GraphQueryWorkload(engine, requests),
                   Share(quantum=4))
    lm = gw.add(LMDecodeWorkload(LMSession("qwen3-1.7b", smoke=True)),
                Share(quantum=2, weight=2))
    gw.run()
    print(gw.report())

Workloads implement the `Workload` protocol (scheduler.py): warmup(),
ready(), step(quantum), metrics().  The two shipped implementations:

  * `GraphQueryWorkload` — wraps a `QueryEngine`'s ticket queue; each
    step executes one coalescing round (`run_pending`): same-class
    duplicate queries in the round cost ONE execution, distinct classes
    run back-to-back on the warmed resident graph.
  * `LMDecodeWorkload` — wraps an `LMSession`; each step runs `quantum`
    greedy decode steps (resumable via the session's checkpoints).

The gateway's report includes, per workload, the scheduler-level turn
latencies split into *solo* (no other workload was ready that round)
vs *contended* (another tenant was hot).  Every launcher is a thin
client of this module: `launch/gateway.py` runs mixed traffic (and the
RPC front door, serve/rpc.py), `launch/query_serve.py` schedules a
single graph workload and `launch/serve.py` a single LM workload.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..obs import (
    Histogram, MetricsRegistry, get_tracer, latency_summary, timer,
)
from .scheduler import RoundScheduler, Share, StepReport, Workload

__all__ = [
    "Gateway",
    "GraphQueryWorkload",
    "LMDecodeWorkload",
    "RoundScheduler",
    "Share",
    "StepReport",
    "Workload",
]


class GraphQueryWorkload:
    """Pattern-query tenant: a `QueryEngine` ticket queue as a Workload.

    `prewarm=True` resolves every distinct isomorphism class in the
    initial queue during warmup() (search + warmup, no counting), so
    scheduled rounds measure steady-state execution; serving CLIs keep
    the default and pay cold costs in-round.
    """

    def __init__(self, engine, requests=(), *, name: str = "graph",
                 prewarm: bool = False):
        self.engine = engine
        self.name = name
        self.prewarm = prewarm
        self.tickets = [engine.enqueue(r) for r in requests]

    def add(self, request):
        ticket = self.engine.enqueue(request)
        self.tickets.append(ticket)
        return ticket

    def warmup(self) -> None:
        if not self.prewarm:
            return
        seen = set()
        for t in self.tickets:
            if t.done:
                continue
            key = self.engine._group_key(t.request)
            if key not in seen:
                seen.add(key)
                self.engine.plan(t.request)

    def ready(self) -> bool:
        # a preempted class (taken off the queue, mid-count) still needs
        # rounds to finish; so do queued mutations (live engines apply
        # them at round boundaries)
        return (self.engine.pending() > 0 or self.engine.inflight() > 0
                or self.engine.mutations_pending() > 0)

    def step(self, quantum: int) -> StepReport:
        with timer() as t:
            resolved = self.engine.run_pending(limit=quantum)
        # a fully-preempted quantum resolves zero tickets but dispatched
        # real work — and a mutation-only round made progress too:
        # report it so the scheduler keeps rounds coming
        return StepReport(
            items=len(resolved), seconds=t.seconds,
            progressed=bool(resolved)
            or self.engine.last_round_dispatches > 0
            or self.engine.last_round_mutations > 0)

    def results(self):
        """Resolved results in admission order (unresolved tickets are
        skipped — drain the queue first via Gateway.run)."""
        return [t.result for t in self.tickets if t.done]

    def metrics(self) -> dict:
        eng = self.engine
        return {
            "requests": eng.requests_resolved,
            "executions": eng.executions,
            "coalesced": eng.coalesced,
            "pending": eng.pending(),
            "inflight": eng.inflight(),
            "preemptions": eng.preemptions,
            "rejections": sum(eng.rejections.values()),
            "latency": eng.latency_percentiles(),
            "tenants": eng.tenant_report(),
            "cache_hits": eng.cache.stats.hits,
            "cache_misses": eng.cache.stats.misses,
        }


class LMDecodeWorkload:
    """LM tenant: an `LMSession`'s decode loop as a Workload.  One work
    item = one greedy decode step; prefill (or checkpoint restore, with
    `resume=True`) happens in warmup()."""

    def __init__(self, session, *, name: str = "lm", resume: bool = False):
        self.session = session
        self.name = name
        self.resume = resume

    def warmup(self) -> None:
        self.session.start(resume=self.resume)

    def ready(self) -> bool:
        return self.session.remaining > 0

    def step(self, quantum: int) -> StepReport:
        with timer() as t:
            n = self.session.decode_steps(quantum)
        return StepReport(items=n, seconds=t.seconds)

    def metrics(self) -> dict:
        return self.session.metrics()


def _turn_summary(per_item_seconds: list[float]) -> dict:
    """Per-item turn latencies → the unified percentile dict
    (`obs.latency_summary`, the one shape every report uses)."""
    h = Histogram()
    for s in per_item_seconds:
        h.observe(s * 1e3)
    return latency_summary(h)


@dataclass
class Gateway:
    """Owns the process's device and schedules registered workloads on
    it.

    The device is *advisory glue*: workloads that need it (the query
    engine, the LM session) are constructed against `Gateway.device`,
    so there is exactly one device per process and the scheduler is the
    only interleaving authority."""

    device: object = None
    scheduler: RoundScheduler = field(default_factory=RoundScheduler)
    workloads: list = field(default_factory=list)
    trace: object = None
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    _warmed: bool = field(default=False, repr=False)

    def add(self, workload: Workload, share: Share | None = None):
        if any(w.name == workload.name for w in self.workloads):
            raise ValueError(f"duplicate workload name {workload.name!r}")
        if share is not None:
            self.scheduler.shares[workload.name] = share
        self.workloads.append(workload)
        return workload

    def warmup(self) -> None:
        with get_tracer().span("gateway.warmup",
                               workloads=len(self.workloads)):
            for w in self.workloads:
                w.warmup()
        self._warmed = True

    def run_round(self) -> tuple[int, bool] | None:
        """Drive exactly ONE scheduler round (warm first, once).  The
        RPC server's event loop calls this between socket reads so N
        remote clients share the resident graph without threads.
        Returns None when no workload is ready, else (items, progressed)
        — the trace accumulates across calls."""
        if not self._warmed:
            self.warmup()
        if self.trace is None:
            from .scheduler import ScheduleTrace
            self.trace = ScheduleTrace()
        return self.scheduler.run_round(self.workloads, self.trace,
                                        metrics=self.metrics)

    def run(self, *, max_rounds: int | None = None, warmup: bool = True):
        """Warm every workload, then drive scheduler rounds until all
        are drained (or `max_rounds`).  Returns the ScheduleTrace."""
        with get_tracer().span(
                "gateway.run", workloads=len(self.workloads)) as sp:
            if warmup:
                self.warmup()
            self.trace = self.scheduler.run(self.workloads,
                                            max_rounds=max_rounds,
                                            metrics=self.metrics)
            sp.set(rounds=self.trace.rounds, turns=len(self.trace.turns))
        return self.trace

    def reset_window(self) -> None:
        """Reset the registry's measurement window (once, however many
        tenants share the registry)."""
        self.metrics.reset_window()

    def report(self) -> dict:
        """Per-workload metrics plus the interference evidence: turn
        latency (seconds per work item) split solo vs contended."""
        out = {"rounds": 0, "workloads": {}}
        turns = self.trace.turns if self.trace is not None else []
        if self.trace is not None:
            out["rounds"] = self.trace.rounds
        for w in self.workloads:
            mine = [t for t in turns if t.name == w.name and t.items > 0]
            solo = [t.seconds / t.items for t in mine if not t.contended]
            cont = [t.seconds / t.items for t in mine if t.contended]
            solo_s, cont_s = _turn_summary(solo), _turn_summary(cont)
            rep = {
                "items": sum(t.items for t in mine),
                "turns": len(mine),
                "turn_item_ms": {"solo": solo_s, "contended": cont_s},
                "metrics": w.metrics(),
            }
            if solo and cont:
                s50, c50 = solo_s["p50_ms"], cont_s["p50_ms"]
                rep["interference_x"] = c50 / s50 if s50 > 0 else float("inf")
            out["workloads"][w.name] = rep
        return out
