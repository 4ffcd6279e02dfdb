"""repro_torch.obs — tracing and metrics for the whole serving stack.

Two planes (DESIGN.md §7):

  * spans   — `get_tracer().span("engine.plan", pattern=key)` nest into
              a timeline exportable as Perfetto `trace.json`;
  * metrics — `MetricsRegistry` counters/gauges/histograms keyed
              `subsystem.metric{labels}`, one `snapshot()` per engine
              or gateway, `latency_summary()` as the single percentile
              dict shape.

Stdlib-only by contract: serve/scheduler.py imports this and the lint
keeps that module free of torch (and this one free of numpy).
"""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    latency_summary,
)
from repro_torch.obs.trace import (
    Span,
    Timer,
    Tracer,
    get_tracer,
    set_tracer,
    timer,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Timer",
    "Tracer",
    "get_tracer",
    "latency_summary",
    "set_tracer",
    "timer",
]
