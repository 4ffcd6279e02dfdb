"""Self-time breakdown of a Chrome/Perfetto trace.json.

    python -m repro_torch.obs summarize trace.json [--top N] [--min-coverage X]

A copy of `repro/obs/summarize.py` (pure Python), run on the traces the
port's tracer exports (`obs/trace.py`, `--trace` on every launcher).

Rebuilds the span tree from the `args.id`/`args.parent` links our
exporter threads through each event, computes per-name self time
(span duration minus the duration of its direct children), and prints
a table sorted by total self time.  Exits nonzero when the trace is
missing, malformed, or empty — scripts use that as their trace
sanity gate — and, with `--min-coverage`, when leaf spans attribute
less than the given fraction of wall time (the acceptance bar for the
instrumentation being dense enough to localize a slow query).
"""
from __future__ import annotations

import json
import sys

__all__ = ["summarize", "main"]


def summarize(doc: dict) -> dict:
    """Reduce a chrome-trace doc to the summary the CLI prints.

    Returns {"events", "wall_us", "leaf_us", "leaf_coverage", "rows"}
    where rows is [{name, count, total_us, self_us, leaf}] sorted by
    self_us descending.  Raises ValueError on malformed input.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a chrome trace: missing 'traceEvents'")
    events = [e for e in doc["traceEvents"]
              if isinstance(e, dict) and e.get("ph") == "X"]
    if not events:
        raise ValueError("trace contains no complete ('X') span events")

    child_dur: dict[int, float] = {}
    for e in events:
        try:
            dur = float(e["dur"])
            args = e.get("args") or {}
            parent = args.get("parent")
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"malformed event {e!r}: {exc}") from exc
        if parent is not None:
            child_dur[parent] = child_dur.get(parent, 0.0) + dur

    per_name: dict[str, dict] = {}
    wall_us = 0.0   # duration of root spans only (no double counting)
    leaf_us = 0.0
    for e in events:
        dur = float(e["dur"])
        args = e.get("args") or {}
        sid = args.get("id")
        self_us = dur - child_dur.get(sid, 0.0)
        is_leaf = sid not in child_dur
        if args.get("parent") is None:
            wall_us += dur
        if is_leaf:
            leaf_us += dur
        row = per_name.setdefault(
            e.get("name", "?"),
            {"count": 0, "total_us": 0.0, "self_us": 0.0, "leaf": is_leaf})
        row["count"] += 1
        row["total_us"] += dur
        row["self_us"] += max(self_us, 0.0)
        row["leaf"] = row["leaf"] and is_leaf

    rows = [{"name": k, **v} for k, v in per_name.items()]
    rows.sort(key=lambda r: -r["self_us"])
    coverage = (leaf_us / wall_us) if wall_us > 0 else 0.0
    return {"events": len(events), "wall_us": wall_us, "leaf_us": leaf_us,
            "leaf_coverage": coverage, "rows": rows}


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.2f}ms"
    return f"{us:.0f}us"


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs summarize",
        description="Self-time breakdown of an obs trace.json")
    ap.add_argument("trace", help="path to a Chrome/Perfetto trace.json")
    ap.add_argument("--top", type=int, default=20,
                    help="rows to print (default 20)")
    ap.add_argument("--min-coverage", type=float, default=None,
                    help="fail unless leaf spans cover at least this "
                         "fraction of root wall time (e.g. 0.95)")
    args = ap.parse_args(argv)

    try:
        with open(args.trace) as f:
            doc = json.load(f)
        summ = summarize(doc)
    except (OSError, json.JSONDecodeError, ValueError) as exc:
        print(f"summarize: bad trace {args.trace}: {exc}", file=sys.stderr)
        return 1

    total_self = sum(r["self_us"] for r in summ["rows"]) or 1.0
    print(f"trace: {args.trace}")
    print(f"  events={summ['events']}  wall={_fmt_us(summ['wall_us'])}  "
          f"leaf_coverage={summ['leaf_coverage']:.1%}")
    print(f"  {'span':<28} {'n':>6} {'total':>10} {'self':>10} {'self%':>7}")
    for r in summ["rows"][:args.top]:
        mark = "*" if r["leaf"] else " "
        print(f"  {r['name']:<27}{mark} {r['count']:>6} "
              f"{_fmt_us(r['total_us']):>10} {_fmt_us(r['self_us']):>10} "
              f"{r['self_us'] / total_self:>6.1%}")
    if len(summ["rows"]) > args.top:
        print(f"  ... {len(summ['rows']) - args.top} more span names")
    print("  (* = leaf span)")

    if args.min_coverage is not None and \
            summ["leaf_coverage"] < args.min_coverage:
        print(f"summarize: leaf coverage {summ['leaf_coverage']:.1%} "
              f"< required {args.min_coverage:.1%}", file=sys.stderr)
        return 2
    return 0
