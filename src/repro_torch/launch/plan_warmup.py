"""Offline plan-store warmup: search patterns × modes into a persistent
cache dir so serving replicas start warm.

    PYTHONPATH=src python -m repro_torch.launch.plan_warmup --cache-dir ./plans
    PYTHONPATH=src python -m repro_torch.launch.plan_warmup --cache-dir ./plans \
        --dataset small-rmat --patterns P1,P2 --modes graphpi --no-iep

Port of `scripts/plan_warmup.py` (`--device`, default cuda, added).  For
every (pattern, mode[, use_iep]) combination the tool runs the full
cold pipeline — configuration search → plan build → matcher warmup →
one count — through the same `PlanCache` code path serving uses, writing
each result behind into the store.  A replica started with
`python -m repro_torch.launch.query_serve --cache-dir <dir>
--warm-from-disk` (same graph, executor config, and layout) then serves
its first query with zero configuration searches.

Combinations already persisted are skipped (load-through hits), so the
tool is idempotent and cheap to re-run after adding patterns.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache-dir", required=True,
                    help="plan store directory to populate")
    ap.add_argument("--dataset", default="tiny-er")
    ap.add_argument("--patterns", default="P1,P2,P3,P4,P5,P6",
                    help="comma-separated pattern names")
    ap.add_argument("--modes", default="graphpi,graphzero",
                    help="comma-separated subset of graphpi,graphzero,naive")
    ap.add_argument("--no-iep", action="store_true",
                    help="skip the use_iep=True variants")
    ap.add_argument("--capacity", type=int, default=1 << 15)
    ap.add_argument("--chunk", type=int, default=0,
                    help="outer-loop vertex chunk (0 = executor default); "
                         "must match the serving replica's --chunk")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from ..configs.graphpi import get_dataset, get_pattern
    from ..core.executor import ExecutorConfig
    from ..query import PlanStore, QueryEngine, QueryRequest

    graph = get_dataset(args.dataset)
    store = PlanStore(args.cache_dir)
    engine = QueryEngine(
        graph, cfg=ExecutorConfig(capacity=args.capacity),
        chunk=args.chunk or None, store=store, device=args.device,
    )
    print(f"[warmup] graph={graph.name} (|V|={graph.n}, |E|={graph.m}); "
          f"store at {store.vdir} ({len(store)} entries)")

    combos = []
    for name in args.patterns.split(","):
        for mode in args.modes.split(","):
            iep_variants = [False] if (args.no_iep or mode == "naive") \
                else [False, True]
            for use_iep in iep_variants:
                combos.append((name.strip(), mode.strip(), use_iep))

    t0 = time.perf_counter()
    for name, mode, use_iep in combos:
        ticket = engine.enqueue(QueryRequest(
            get_pattern(name), mode=mode, use_iep=use_iep))
        engine.run_pending()
        res = ticket.result
        how = ("warm" if res.cache_hit else
               "persisted" if res.search_seconds == 0.0 else "compiled")
        print(f"[warmup] {name:<6} mode={mode:<10} iep={int(use_iep)} "
              f"{how:<9} count={res.count} "
              f"(search {res.search_seconds:.3f}s, "
              f"compile {res.compile_seconds:.3f}s)")
        if res.overflowed:
            print(f"[warmup] OVERFLOW on {name} — raise --capacity")
            return 1

    s = engine.cache.stats
    print(f"[warmup] done in {time.perf_counter() - t0:.1f}s: "
          f"{s.n_searches} searches, {s.n_compiles} warmups, "
          f"{s.persist_hits} already persisted; "
          f"store now has {len(store)} entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
