"""MetricsRegistry — one snapshot for every subsystem's counters.

Before this layer each subsystem kept its own stats object with its own
reporting convention: `CacheStats` (query/cache.py), `StoreStats`
(query/store.py), the engine's latency list, the gateway's hand-rolled
percentile dicts.  The registry unifies the *reporting* plane without
disturbing the storage plane: dataclass stats objects keep their fields
(they're part of each subsystem's API), and a registered collector
merges them into the snapshot at read time.

Naming convention (DESIGN.md §7): keys are
``subsystem.metric{label=value,...}`` — e.g.

    cache.hits
    engine.query_latency_ms{...percentile summary...}
    scheduler.turn_item_ms{phase=contended,workload=graph}

Live engines (query/engine.py with a delta overlay) contribute a
``live.*`` family: ``live.epoch`` / ``live.stats_epoch`` (current edge
and stats epochs), ``live.overlay_edges``, ``live.compactions``,
``live.mutations_applied``, ``live.pending_mutations``,
``live.matcher_rebinds`` / ``live.matcher_rebuilds`` (epoch swaps that
reused vs recompiled the resident matchers), and the maintainer's
counters (``live.memo_hits``, ``live.incremental_hits``,
``live.full_recounts``, ``live.memo_invalidations``,
``live.spans_reused``, ``live.spans_recomputed``).

Histograms are deterministic bounded reservoirs: when full, the
reservoir thins by doubling its sampling stride (keep every 2nd, then
every 4th, ...) instead of random eviction — the scheduler path is
linted against nondeterminism, so no RNG anywhere here.  Percentiles
use linear interpolation (numpy's default), so snapshots are drop-in
replacements for the np.percentile dicts they retire.

Everything is stdlib: serve/scheduler.py imports this and must stay
Framework- and numpy-free.
"""
from __future__ import annotations

import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "latency_summary",
]


def _key(name: str, labels: dict | None) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolation percentile over pre-sorted values, matching
    np.percentile(..., q) so retired numpy call sites keep their
    numbers bit-for-bit on identical samples."""
    n = len(sorted_vals)
    if n == 0:
        raise ValueError("percentile of empty sample")
    if n == 1:
        return sorted_vals[0]
    pos = (q / 100.0) * (n - 1)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return sorted_vals[lo]
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class Counter:
    """Monotonic (well — resettable-window) float/int counter."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0


class Gauge:
    """Last-write-wins scalar (frontier size, capacity, queue depth)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Bounded-reservoir histogram with deterministic decimation.

    Records every observation until `max_samples`, then halves the
    reservoir by keeping every other retained sample and doubles the
    sampling stride for future observations.  Total count and sum are
    exact regardless; percentiles are computed over the reservoir.
    No randomness — identical observation sequences yield identical
    snapshots (the scheduler path is linted deterministic).
    """

    __slots__ = ("max_samples", "count", "total", "_samples", "_stride",
                 "_phase", "_lock")

    def __init__(self, max_samples: int = 4096):
        if max_samples < 2:
            raise ValueError("max_samples must be >= 2")
        self.max_samples = max_samples
        self.count = 0
        self.total = 0.0
        self._samples: list[float] = []
        self._stride = 1
        self._phase = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.total += value
            self._phase += 1
            if self._phase >= self._stride:
                self._phase = 0
                self._samples.append(value)
                if len(self._samples) >= self.max_samples:
                    self._samples = self._samples[::2]
                    self._stride *= 2

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total = 0.0
            self._samples = []
            self._stride = 1
            self._phase = 0

    def summary(self) -> dict:
        """The unified latency dict: n / p50 / p95 / p99 / mean, in the
        same unit the observations were recorded in."""
        with self._lock:
            n = self.count
            total = self.total
            samples = sorted(self._samples)
        if n == 0 or not samples:
            return {"n": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                    "mean": 0.0}
        return {
            "n": n,
            "p50": percentile(samples, 50),
            "p95": percentile(samples, 95),
            "p99": percentile(samples, 99),
            "mean": total / n,
        }


def latency_summary(hist: Histogram) -> dict:
    """Millisecond-keyed summary of a Histogram that observed ms values
    — the one percentile dict shape shared by engine, gateway, and the
    benchmarks (retires `engine.latency_percentiles` and the gateway's
    `_pcts`, whose key sets had drifted apart)."""
    s = hist.summary()
    return {
        "n": s["n"],
        "p50_ms": s["p50"],
        "p95_ms": s["p95"],
        "p99_ms": s["p99"],
        "mean_ms": s["mean"],
    }


class MetricsRegistry:
    """Namespace of counters/gauges/histograms plus read-time collectors.

    Instruments get-or-create by (name, labels); `snapshot()` returns a
    flat dict keyed `subsystem.metric{labels}`.  Subsystems whose stats
    already live in dataclasses (CacheStats, StoreStats) register a
    collector — a zero-arg callable returning {metric_name: value} —
    merged into every snapshot, so the registry is the single pane of
    glass without duplicating counter storage.

    Registries are per-engine/per-gateway, not process-global:
    benchmarks/run.py executes several benchmark mains in one process
    and each must see a clean window.  Launchers that want one pane
    share a single instance explicitly.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._collectors: list = []

    # ---------------------------------------------------------- instruments
    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        with self._lock:
            c = self._counters.get(k)
            if c is None:
                c = self._counters[k] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        with self._lock:
            g = self._gauges.get(k)
            if g is None:
                g = self._gauges[k] = Gauge()
        return g

    def histogram(self, name: str, max_samples: int = 4096,
                  **labels) -> Histogram:
        k = _key(name, labels)
        with self._lock:
            h = self._histograms.get(k)
            if h is None:
                h = self._histograms[k] = Histogram(max_samples)
        return h

    def register_collector(self, fn) -> None:
        """fn() -> {metric_name: scalar} merged into each snapshot."""
        with self._lock:
            self._collectors.append(fn)

    # ------------------------------------------------------------- reading
    def snapshot(self) -> dict:
        """Flat {key: value} view: counters/gauges as scalars,
        histograms as their summary dicts, collectors merged last."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
            collectors = list(self._collectors)
        out: dict = {}
        for k, c in counters.items():
            out[k] = c.value
        for k, g in gauges.items():
            out[k] = g.value
        for k, h in hists.items():
            out[k] = h.summary()
        for fn in collectors:
            out.update(fn())
        return out

    def reset_window(self) -> None:
        """Zero every counter and histogram (gauges keep last value —
        they describe current state, not a window).  Both the engine and
        the gateway expose this so benchmark phases (warmup vs measured)
        reset the same window the same way."""
        with self._lock:
            counters = list(self._counters.values())
            hists = list(self._histograms.values())
        for c in counters:
            c.reset()
        for h in hists:
            h.reset()
