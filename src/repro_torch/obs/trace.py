"""Tracer — nested structured spans with Perfetto export.

One process-wide span timeline (DESIGN.md §7): every subsystem opens
spans through the module-level tracer —

    from repro_torch.obs import get_tracer
    with get_tracer().span("engine.round", tickets=4) as sp:
        ...
        sp.set(coalesced=2)

and a launcher that wants a trace swaps in an enabled tracer
(`set_tracer(Tracer(enabled=True))`, or the `--trace` flag on the
serving CLIs) and exports `trace.json` at exit.  Span names are
dot-namespaced `subsystem.what` (taxonomy table in DESIGN.md §7); the
part before the first dot becomes the Chrome/Perfetto category.

Design constraints, in order:

  * NEAR-ZERO COST WHEN DISABLED.  `span()` on a disabled tracer
    returns one shared no-op context manager — no Span allocation, no
    clock read, no lock (< 1µs per call, asserted in tests/test_obs.py)
    — so instrumentation stays compiled into the hot paths permanently.
  * THREAD-SAFE NESTING.  The current-span stack is thread-local (each
    thread gets its own parent chain; spans never parent across
    threads) and finished spans append to one lock-guarded list.
  * FRAMEWORK-FREE.  Everything here is stdlib; the executor imports it
    without pulling in anything else.

The exporter writes the Chrome trace-event format (`ph: "X"` complete
events with microsecond timestamps) wrapped as {"traceEvents": [...]},
which both `chrome://tracing` and https://ui.perfetto.dev load
directly.  The reference package's `obs summarize` command reads the
same file and prints the self-time breakdown.

ONE CLOCK WITH THE PROFILER.  Durations are read on the monotonic
`perf_counter_ns`; span starts (`t0_ns` in the records, `ts` in the
export) are put on the clock `torch.profiler` stamps its host events
with, the wall clock's nanoseconds since the Unix epoch, through one
pair of readings taken when the tracer is made.  A span and a
`record_function` range opened together start at the same instant in
both traces: `prof.export_chrome_trace()` writes its `ts` relative to
its `baseTimeNanoseconds`, so add that base (in µs) to its events to
lay them beside a `--trace` export on one Perfetto timeline.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

__all__ = [
    "Span",
    "Timer",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "timer",
]


class Timer:
    """Sanctioned monotonic stopwatch for serving-path counters.

    The repo lint (`no-raw-timing`) forbids raw ``time.perf_counter()``
    in `serve/` and `query/`: durations that feed *metrics* must come
    from here (or from a span), so there is exactly one clock and one
    place to audit.  Usage::

        with timer() as t:
            work()
        stats.seconds += t.seconds
    """

    __slots__ = ("seconds", "_t0")

    def __enter__(self) -> "Timer":
        self.seconds = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        return False


def timer() -> Timer:
    return Timer()


class _NopSpan:
    """Shared do-nothing span: the entire disabled-tracer cost."""

    __slots__ = ()

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NopSpan":
        return self


_NOP = _NopSpan()


class Span:
    """One live span.  Use as a context manager; `set()` attaches
    attributes discovered mid-span (they export under `args`)."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id",
                 "tid", "t0_ns", "dur_ns")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = 0
        self.parent_id = None
        self.tid = 0
        self.t0_ns = 0
        self.dur_ns = 0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        return self.dur_ns / 1e9

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self.span_id = next(tr._ids)
        self.parent_id = stack[-1].span_id if stack else None
        self.tid = threading.get_ident()
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_ns = time.perf_counter_ns() - self.t0_ns
        stack = self._tracer._stack()
        # tolerate exotic exits (a span leaked past its parent's exit):
        # unwind to self so one bad caller can't corrupt the whole stack
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        self._tracer._finish(self)
        return False


class Tracer:
    """Span collector.  `enabled=False` (the default process tracer) is
    the production mode: every `span()` call returns the shared no-op.

    `sync` requests device-fenced per-level executor spans (the
    `--trace-sync` flag): the executor inserts device-synchronize
    fences so span durations are real device time — strictly opt-in
    because fencing serializes the dispatch pipeline.

    `max_spans` bounds memory on long serving runs; once full, new
    spans are counted in `dropped` instead of recorded.
    """

    def __init__(self, *, enabled: bool = True, sync: bool = False,
                 max_spans: int = 1_000_000):
        self.enabled = enabled
        self.sync = sync
        self.max_spans = max_spans
        self.dropped = 0
        # perf_counter_ns() - epoch_ns is the profiler's clock (wall ns):
        # one pair of readings, the monotonic one at the wall read's
        # midpoint
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        self.epoch_ns = (p0 + time.perf_counter_ns()) // 2 - wall
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: list[dict] = []

    # ------------------------------------------------------------ recording
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs):
        """Open a span (context manager).  Keyword arguments become
        structured attributes; add more later with `.set(...)`."""
        if not self.enabled:
            return _NOP
        return Span(self, name, attrs)

    def _finish(self, span: Span) -> None:
        rec = {
            "name": span.name,
            "id": span.span_id,
            "parent": span.parent_id,
            "tid": span.tid,
            "t0_ns": span.t0_ns - self.epoch_ns,
            "dur_ns": span.dur_ns,
            "attrs": span.attrs,
        }
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
            else:
                self._spans.append(rec)

    # ------------------------------------------------------------ reading
    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # ------------------------------------------------------------ export
    def chrome_events(self) -> list[dict]:
        """Spans as Chrome trace-event dicts (`ph: "X"` complete events,
        microsecond floats, span ids threaded through `args`)."""
        pid = os.getpid()
        out = []
        for s in self.spans():
            out.append({
                "name": s["name"],
                "cat": s["name"].split(".", 1)[0],
                "ph": "X",
                "ts": s["t0_ns"] / 1e3,
                "dur": s["dur_ns"] / 1e3,
                "pid": pid,
                "tid": s["tid"],
                "args": {"id": s["id"], "parent": s["parent"],
                         **s["attrs"]},
            })
        return out

    def export_chrome(self, path: str) -> int:
        """Write a Perfetto/chrome://tracing-loadable trace.json;
        returns the number of events written."""
        events = self.chrome_events()
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if self.dropped:
            doc["otherData"] = {"dropped_spans": self.dropped}
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return len(events)


def _from_env() -> Tracer:
    # REPRO_TRACE=1 pre-enables tracing before any code runs (the
    # benchmark harness path); REPRO_TRACE_SYNC=1 adds device fencing.
    on = os.environ.get("REPRO_TRACE", "") not in ("", "0")
    sync = os.environ.get("REPRO_TRACE_SYNC", "") not in ("", "0")
    return Tracer(enabled=on, sync=sync)


_tracer = _from_env()


def get_tracer() -> Tracer:
    """The process tracer.  Instrumented code calls this at span-open
    time (never caches it), so launchers/tests can swap tracers at any
    point with `set_tracer`."""
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    global _tracer
    _tracer = tracer
    return tracer
