"""Shared `--trace` wiring for the port's CLIs (`launch/mine.py`).

    --trace OUT.json     enable the tracer, export a Perfetto-loadable
                         trace on exit (https://ui.perfetto.dev)
    --trace-sync         also fence per-level executor spans with
                         torch.cuda.synchronize (real device time per
                         level; serializes the dispatch pipeline — opt-in)
    --metrics OUT.json   dump a MetricsRegistry snapshot on exit

`add_trace_args` registers them; `start_tracing` installs the tracer
(also honouring REPRO_TRACE already set in the environment);
`finish_tracing` exports the artifacts and prints one status line each.
"""
from __future__ import annotations

import json

from repro_torch.obs.trace import Tracer, get_tracer, set_tracer

__all__ = ["add_trace_args", "start_tracing", "finish_tracing"]


def add_trace_args(ap) -> None:
    g = ap.add_argument_group("observability")
    g.add_argument("--trace", default="", metavar="OUT.json",
                   help="export a Chrome/Perfetto trace of this run")
    g.add_argument("--trace-sync", action="store_true",
                   help="with --trace: fence per-level executor spans "
                        "(device synchronize) so span durations are real "
                        "device time — serializes the hot path")
    g.add_argument("--metrics", default="", metavar="OUT.json",
                   help="dump the metrics-registry snapshot as JSON")


def start_tracing(args) -> Tracer:
    """Install the process tracer per the CLI flags.  Without `--trace`
    the env-configured tracer (REPRO_TRACE) stays as-is, so the flags
    only ever widen observability."""
    if args.trace:
        return set_tracer(Tracer(enabled=True, sync=args.trace_sync))
    return get_tracer()


def finish_tracing(args, *, registry=None, tag: str = "obs") -> None:
    """Export `--trace` / `--metrics` artifacts (no-op without flags)."""
    if args.trace:
        n = get_tracer().export_chrome(args.trace)
        print(f"[{tag}] trace: {n} spans -> {args.trace}")
    if args.metrics and registry is not None:
        with open(args.metrics, "w") as f:
            json.dump(registry.snapshot(), f, indent=1, default=str,
                      sort_keys=True)
        print(f"[{tag}] metrics snapshot -> {args.metrics}")
