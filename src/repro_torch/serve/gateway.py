"""The serving front door: one Gateway, one device, many workloads.

Counterpart of `repro/serve/gateway.py` on one device.  The Gateway is
the single object that owns the process's device and co-schedules
heterogeneous tenants on it:

    gw = Gateway(device=torch.device("cuda"))
    lm = gw.add(LMDecodeWorkload(LMSession("qwen3-1.7b", smoke=True)),
                Share(quantum=2, weight=2))
    gw.run()
    print(gw.report())

Workloads implement the `Workload` protocol (scheduler.py): warmup(),
ready(), step(quantum), metrics().  The port ships `LMDecodeWorkload`,
which wraps an `LMSession`: each step runs `quantum` greedy decode
steps (resumable via the session's checkpoints).  The graph-query
tenant (`GraphQueryWorkload`) waits for the query engine's port
(ROADMAP.md queue 1, item 4).

The gateway's report includes, per workload, the scheduler-level turn
latencies split into *solo* (no other workload was ready that round)
vs *contended* (another tenant was hot).  `launch/serve.py` schedules a
single LM workload through it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..obs import (
    Histogram, MetricsRegistry, get_tracer, latency_summary, timer,
)
from .scheduler import RoundScheduler, Share, StepReport, Workload

__all__ = [
    "Gateway",
    "LMDecodeWorkload",
    "RoundScheduler",
    "Share",
    "StepReport",
    "Workload",
]


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

    The device is *advisory glue*: workloads that need it (the LM
    session) are constructed against `Gateway.device`, so there is
    exactly one device per process and the scheduler is the only
    interleaving authority."""

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
        """Drive exactly ONE scheduler round (warm first, once), for a
        caller that interleaves rounds with its own event loop.
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
