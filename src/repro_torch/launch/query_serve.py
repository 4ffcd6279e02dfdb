"""Pattern-query serving driver on one device.

    PYTHONPATH=src python -m repro_torch.launch.query_serve --dataset tiny-er
    PYTHONPATH=src python -m repro_torch.launch.query_serve --dataset tiny-er \
        --workload mixed --verify --expect-min-hits 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.query_serve \
        --dataset small-rmat --requests reqs.jsonl

Port of `repro/launch/query_serve.py`: `--device` (default cuda, which
raises without a card) replaces `--model-axis` / `--single-device`.
Loads the dataset ONCE into a `QueryEngine` (CSR resident on the
device) and streams a workload of pattern-count requests through the
`PlanCache`.  Requests come from a JSON-lines file —

    {"pattern": "P1"}
    {"pattern": "P2", "use_iep": true, "verify": true}
    {"pattern": {"n": 3, "edges": [[0, 1], [1, 2], [0, 2]]}}

— or from a synthetic workload: `mixed` serves three distinct patterns
plus isomorphic relabelings of each (cache hits), `smoke` is the
2-pattern CI variant.  Per-query latency, p50/p99, and the cache
counters (hits never re-search or re-warm) are reported at the end.

Since the Gateway landed this CLI is a thin client of it: requests are
enqueued as tickets on a `GraphQueryWorkload` and drained by the round
scheduler (`--round-quantum` tickets per round; same-class duplicates
within a round coalesce into one execution).  Counts are bit-identical
to the direct engine path — only the scheduling differs.  Mixed
graph + LM traffic lives in `launch/gateway.py`.

With `--cache-dir` the plan cache persists across restarts (searched
configurations and plans, query/store.py): a restarted replica replays
a prior workload with zero configuration searches.  `--warm-from-disk`
preloads every compatible persisted plan before the first request.
`python -m repro_torch.launch.plan_warmup` populates a store offline
(P1–P6 × modes).
"""
from __future__ import annotations

import argparse
import json
import sys


def build_requests(args, get_pattern):
    from ..core.pattern import Pattern
    from ..query import QueryRequest, relabeled_variant

    if args.requests:
        reqs = []
        with open(args.requests) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                spec = json.loads(line)
                pat = spec["pattern"]
                if isinstance(pat, str):
                    pattern = get_pattern(pat)
                else:
                    pattern = Pattern(
                        int(pat["n"]),
                        tuple((int(u), int(v)) for u, v in pat["edges"]),
                        name=pat.get("name", "inline"),
                    )
                reqs.append(QueryRequest(
                    pattern,
                    use_iep=bool(spec.get("use_iep", args.use_iep)),
                    verify=bool(spec.get("verify", args.verify)),
                    mode=spec.get("mode", "graphpi"),
                ))
        return reqs

    names = {"mixed": ["P1", "P2", "P4"], "smoke": ["P1", "P2"]}[args.workload]
    reqs = []
    for rep in range(max(args.repeat, 1)):
        for i, name in enumerate(names):
            p = get_pattern(name)
            # original first, then an isomorphic relabeling — the relabeled
            # re-query MUST be a plan-cache hit
            reqs.append(QueryRequest(p, use_iep=args.use_iep,
                                     verify=args.verify))
            reqs.append(QueryRequest(
                relabeled_variant(p, seed=args.seed + 7 * rep + i),
                use_iep=args.use_iep, verify=args.verify))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="tiny-er")
    ap.add_argument("--requests", default="",
                    help="JSON-lines request file (overrides --workload)")
    ap.add_argument("--workload", default="mixed",
                    choices=["mixed", "smoke"])
    ap.add_argument("--repeat", type=int, default=1,
                    help="synthetic workload rounds")
    ap.add_argument("--use-iep", action="store_true")
    ap.add_argument("--verify", action="store_true",
                    help="check every count against the oracle (small graphs)")
    ap.add_argument("--capacity", type=int, default=1 << 15)
    ap.add_argument("--chunk", type=int, default=0,
                    help="outer-loop vertex chunk (0 = executor default)")
    ap.add_argument("--max-entries", type=int, default=256,
                    help="plan-cache LRU bound (0 = unbounded)")
    ap.add_argument("--cache-dir", default="",
                    help="persistent plan store directory: searched "
                         "configurations and plans survive restarts")
    ap.add_argument("--warm-from-disk", action="store_true",
                    help="preload every compatible persisted plan before "
                         "serving (requires --cache-dir)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--expect-min-hits", type=int, default=-1,
                    help="fail unless the cache records >= this many hits")
    ap.add_argument("--round-quantum", type=int, default=1,
                    help="tickets per scheduler round; >1 coalesces "
                         "same-class duplicates within a round into one "
                         "execution")
    from ..obs.cli import add_trace_args, finish_tracing, start_tracing

    add_trace_args(ap)
    args = ap.parse_args(argv)

    from ..configs.graphpi import get_dataset, get_pattern
    from ..core.executor import ExecutorConfig
    from ..obs import MetricsRegistry
    from ..query import PlanCache, PlanStore, QueryEngine, canonical_key
    from ..serve.gateway import Gateway, GraphQueryWorkload, Share

    start_tracing(args)

    if args.warm_from_disk and not args.cache_dir:
        print("[serve] --warm-from-disk requires --cache-dir")
        return 2

    graph = get_dataset(args.dataset)
    store = PlanStore(args.cache_dir) if args.cache_dir else None
    # one registry shared by engine and gateway (one snapshot per run)
    metrics = MetricsRegistry()
    engine = QueryEngine(
        graph,
        cfg=ExecutorConfig(capacity=args.capacity),
        chunk=args.chunk or None,
        device=args.device,
        cache=PlanCache(max_entries=args.max_entries or None, store=store),
        metrics=metrics,
    )
    print(f"[serve] graph={graph.name} (|V|={graph.n}, |E|={graph.m}) "
          f"resident on {engine.device}; "
          f"stats in {engine.stats_seconds:.2f}s (tri_cnt="
          f"{engine.stats.tri_cnt})")
    if store is not None:
        print(f"[serve] plan store at {store.vdir} ({len(store)} entries)")
    if args.warm_from_disk:
        n = engine.warm_from_disk()
        print(f"[serve] warm-from-disk: {n} plan(s) preloaded "
              f"({engine.cache.stats.n_compiles} matcher warmups)")

    requests = build_requests(args, get_pattern)
    distinct = len({canonical_key(r.pattern) for r in requests})
    print(f"[serve] {len(requests)} requests "
          f"({distinct} distinct isomorphism classes)")

    gw = Gateway(device=engine.device, metrics=metrics)
    workload = gw.add(GraphQueryWorkload(engine, requests),
                      Share(quantum=max(args.round_quantum, 1)))
    gw.run()
    results = workload.results()
    for r in results:
        print("[serve]", r.line())

    s = engine.summary()
    lat, cache = s["latency"], s["cache"]
    print(f"[serve] latency: n={lat['n']} p50={lat['p50_ms']:.1f}ms "
          f"p99={lat['p99_ms']:.1f}ms mean={lat['mean_ms']:.1f}ms")
    print(f"[serve] rounds: {gw.report()['rounds']} "
          f"({s['requests_resolved']} requests, {s['executions']} "
          f"executions, {s['coalesced']} coalesced)")
    print(f"[serve] cache: {cache['hits']} hits / {cache['misses']} misses "
          f"({s['cache_entries']} entries); {cache['n_searches']} config "
          f"searches ({cache['search_seconds']:.3f}s), {cache['n_compiles']} "
          f"compiles ({cache['compile_seconds']:.3f}s)")
    if "store" in s:
        print(f"[serve] store: {cache['persist_hits']} persist hits, "
              f"{cache['preloads']} preloads, "
              f"{s['store']['saves']} saves, "
              f"rejects={s['store']['rejects']}")

    finish_tracing(args, registry=metrics, tag="serve")

    rc = 0
    bad = [r for r in results if r.verified is False]
    if bad:
        print(f"[serve] VERIFY FAILED for {[r.pattern_name for r in bad]}")
        rc = 1
    over = [r for r in results if r.overflowed]
    if over:
        # frontier exceeded MAX_CAPACITY: those counts are undercounts
        print(f"[serve] OVERFLOWED (truncated counts) for "
              f"{[r.pattern_name for r in over]}")
        rc = rc or 3
    if args.expect_min_hits >= 0 and cache["hits"] < args.expect_min_hits:
        print(f"[serve] EXPECTED >= {args.expect_min_hits} cache hits, "
              f"got {cache['hits']}")
        rc = rc or 2
    return rc


if __name__ == "__main__":
    sys.exit(main())
