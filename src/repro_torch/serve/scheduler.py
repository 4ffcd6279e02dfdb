"""Round-based co-scheduler for heterogeneous workloads on one mesh.

The Gateway (gateway.py) owns the process's devices; this module owns
*when each workload runs*.  Scheduling is deliberately cooperative and
deterministic: kernel dispatch is single-threaded per process, so
instead of threads + locks the scheduler runs discrete ROUNDS.  Each round it
visits the registered workloads in a fixed order (priority, then
registration order) and grants every ready workload `weight` turns of
`quantum` work items each.  A workload's `step(quantum)` call is its
entire opportunity for that turn — it must return promptly (quantum
bounds the work, not wall time) so a hot LM decode can never starve a
burst of graph queries, and vice versa.

Determinism is the tested property: two workloads with fixed shares
produce a known interleaving (tests/test_gateway.py), which is what
makes the mixed-traffic acceptance runs reproducible.

Nothing in this module imports torch — `Workload` is a structural
protocol, so the scheduler is unit-testable with scripted fakes
(repro_torch.obs is stdlib-only by the same contract).  A copy of
`repro/serve/scheduler.py`; only the docstrings differ.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

from ..obs import get_tracer, timer


@dataclass(frozen=True)
class StepReport:
    """What one `step(quantum)` call actually did."""

    items: int                   # work units completed (<= quantum)
    seconds: float               # wall time of the step
    # preemptive workloads can burn a whole turn mid-item (a suspended
    # query resolves zero tickets yet dispatched real kernels): they set
    # `progressed` explicitly so the stall-break doesn't kill the loop.
    # None (the default) keeps the legacy meaning: progress == items > 0.
    progressed: bool | None = None

    @property
    def made_progress(self) -> bool:
        return self.items > 0 if self.progressed is None else self.progressed


@runtime_checkable
class Workload(Protocol):
    """Anything the Gateway can co-schedule.

    name:      stable identifier (used in shares, traces, reports).
    warmup():  pay one-time costs (compile, prefill, plan preloads)
               before the first round, so rounds measure steady state.
    ready():   True while the workload has pending work.
    step(q):   run up to `q` work items, return a StepReport.
    metrics(): workload-specific counters for the gateway report.
    """

    name: str

    def warmup(self) -> None: ...

    def ready(self) -> bool: ...

    def step(self, quantum: int) -> StepReport: ...

    def metrics(self) -> dict: ...


@dataclass(frozen=True)
class Share:
    """Per-workload scheduling share.

    quantum:  work items granted per turn (units are workload-defined:
              decode steps for the LM, query tickets for the graph).
    weight:   turns granted per round — the fair-share knob; a workload
              with weight 2 gets two `step()` calls for every one of a
              weight-1 peer.
    priority: higher-priority workloads take their turns earlier within
              a round (latency preference, not extra capacity).
    """

    quantum: int = 1
    weight: int = 1
    priority: int = 0


@dataclass(frozen=True)
class Turn:
    """One `step()` grant, as recorded in the schedule trace."""

    round: int
    name: str
    items: int
    seconds: float
    contended: bool              # another workload was ready this round


@dataclass
class ScheduleTrace:
    turns: list[Turn] = field(default_factory=list)
    rounds: int = 0

    def interleaving(self) -> list[str]:
        """The turn order as a name sequence (the fairness invariant)."""
        return [t.name for t in self.turns]

    def items_of(self, name: str) -> int:
        return sum(t.items for t in self.turns if t.name == name)


class RoundScheduler:
    """Deterministic weighted round-robin over cooperative workloads.

    Every round: sort registered workloads by (-priority, registration
    order); each ready one receives `weight` consecutive `step(quantum)`
    calls.  A workload that goes idle mid-round simply stops receiving
    turns; the loop ends when no workload is ready (or `max_rounds`).
    """

    def __init__(self, shares: dict[str, Share] | None = None,
                 *, default: Share = Share()):
        self.shares = dict(shares or {})
        self.default = default

    def share_of(self, name: str) -> Share:
        return self.shares.get(name, self.default)

    def run(self, workloads: list[Workload],
            *, max_rounds: int | None = None,
            metrics=None) -> ScheduleTrace:
        """Drive rounds until no workload is ready (or `max_rounds`).

        With a `MetricsRegistry` passed as `metrics`, every productive
        turn also lands in `scheduler.turn_item_ms{workload=,phase=}`
        histograms (phase solo|contended) — the same split the Gateway
        report derives from the trace, but windowed/resettable.
        """
        trace = ScheduleTrace()
        while max_rounds is None or trace.rounds < max_rounds:
            out = self.run_round(workloads, trace, metrics=metrics)
            if out is None:
                break
            _, progressed = out
            if not progressed:
                # every ready workload declined to make progress — a
                # buggy tenant must not spin the gateway forever
                break
        return trace

    def run_round(self, workloads: list[Workload], trace: ScheduleTrace,
                  *, metrics=None) -> tuple[int, bool] | None:
        """Drive exactly ONE round (the unit the async RPC front door
        interleaves with socket traffic).  Returns ``None`` when no
        workload is ready, else ``(items, progressed)`` — `progressed`
        aggregates :attr:`StepReport.made_progress` so a preempted query
        quantum (zero tickets resolved, real kernels dispatched) still
        counts as forward motion."""
        tr = get_tracer()
        order = sorted(
            range(len(workloads)),
            key=lambda i: (-self.share_of(workloads[i].name).priority, i),
        )
        ready = [i for i in order if workloads[i].ready()]
        if not ready:
            return None
        rnd = trace.rounds
        contended = len(ready) > 1
        round_items = 0
        round_progress = False
        with tr.span("scheduler.round", round=rnd,
                     ready=len(ready)) as rsp:
            for i in ready:
                w = workloads[i]
                share = self.share_of(w.name)
                for _ in range(max(share.weight, 1)):
                    if not w.ready():
                        break
                    with tr.span("scheduler.turn", workload=w.name,
                                 round=rnd,
                                 contended=contended) as tsp, \
                            timer() as t:
                        rep = w.step(max(share.quantum, 1))
                        tsp.set(items=rep.items)
                    dt = t.seconds
                    round_items += rep.items
                    round_progress = round_progress or rep.made_progress
                    seconds = rep.seconds if rep.seconds > 0 else dt
                    trace.turns.append(Turn(
                        round=rnd, name=w.name, items=rep.items,
                        seconds=seconds, contended=contended,
                    ))
                    if metrics is not None and rep.items > 0:
                        metrics.histogram(
                            "scheduler.turn_item_ms", workload=w.name,
                            phase="contended" if contended else "solo",
                        ).observe(seconds / rep.items * 1e3)
            rsp.set(items=round_items)
        trace.rounds += 1
        return round_items, round_progress
