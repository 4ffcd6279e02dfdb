"""End-to-end pattern-counting driver (the paper's workload).

    PYTHONPATH=src python -m repro_torch.launch.mine --pattern P1 --dataset tiny-er --verify
    PYTHONPATH=src python -m repro_torch.launch.mine --pattern P2 --dataset small-rmat \
        --use-iep --verify --device cpu
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.mine --pattern P1 --dataset wiki-vote-syn

Pipeline (paper Fig. 3): the graph is uploaded once and its triangle
count bootstraps the performance model; restriction generation (Alg. 1)
→ 2-phase schedule generation → performance-model configuration
selection over the pattern's canonical form → `build_plan` → counting
through the chunked `Matcher` loop, whose levels run the CUDA kernel K1
on a card.  `--mode graphzero` runs the baseline (single restriction
set, degree-heuristic schedule); `--mode naive` drops the restrictions
and divides by |Aut|.

As in the reference (`repro/launch/mine.py`), this CLI is a one-request
client of the `PlanCache` / `QueryEngine` request path.  Under torchrun
(world size > 1) the count is sharded over the ranks, one process per
GPU (`ShardedMatcher`; `launch/mesh.py` picks the backend), unless
`--single-device` is passed; rank 0 alone prints, with one line per
rank (its wall before the reduction and its K1 launches) and the
balance, max over mean rank wall; every rank exits with the same code.
With `--cache-dir` the engine persists its plans in a `PlanStore`
there, so a repeat invocation loads the plan instead of searching
again (the `config:` line then says "persisted plan"); under torchrun
rank 0 alone writes it.
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass

from .mesh import leaves_group


@dataclass
class MineResult:
    graph: object
    config: object
    plan: object
    result: object            # QueryResult of the one request
    engine: object            # the QueryEngine that served it
    dispatches: int
    search_seconds: float
    compile_seconds: float
    wall_seconds: float       # the count alone, after warmup
    launches: dict            # K1 launches per mode, the count alone
    metrics: object           # MetricsRegistry (the --metrics snapshot)
    expected: int | None = None
    verified: bool | None = None
    group: object = None      # the process group of a sharded run
    ranks: list | None = None  # per rank: wall (s), passes, K1 launches


def parse_args(argv=None):
    from ..obs.cli import add_trace_args

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.mine")
    ap.add_argument("--pattern", default="P1")
    ap.add_argument("--dataset", default="tiny-er")
    ap.add_argument("--mode", default="graphpi",
                    choices=["graphpi", "graphzero", "naive"])
    ap.add_argument("--use-iep", action="store_true")
    ap.add_argument("--verify", action="store_true",
                    help="check against the pure-python oracle (small graphs)")
    ap.add_argument("--capacity", type=int, default=1 << 15)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--single-device", action="store_true",
                    help="count on this process's device even under "
                         "torchrun")
    ap.add_argument("--cache-dir", default="",
                    help="persistent plan store: repeat invocations skip "
                         "the configuration search (query/store.py)")
    add_trace_args(ap)
    return ap.parse_args(argv)


def run(args, *, log=print) -> MineResult:
    """One counting request as `args` (from :func:`parse_args`) describe
    it, through a `QueryEngine`; `log` receives the reference's `[mine]`
    lines."""
    from ..configs.graphpi import get_dataset, get_pattern
    from ..core.executor import ExecutorConfig
    from ..kernels import ops
    from ..query import PlanStore, QueryEngine, QueryRequest

    pattern = get_pattern(args.pattern)
    graph = get_dataset(args.dataset)
    log(f"[mine] pattern={pattern.name} (n={pattern.n}, m={pattern.m}, "
        f"|Aut|={pattern.aut_count()})  graph={graph.name} "
        f"(|V|={graph.n}, |E|={graph.m}, max_deg={graph.max_degree})")

    from .mesh import launched_sharded, shared_group

    group, device = None, args.device
    if launched_sharded(args.single_device):
        group, device = shared_group(args.device, log=log)
    store = PlanStore(args.cache_dir) if args.cache_dir else None
    engine = QueryEngine(graph, cfg=ExecutorConfig(capacity=args.capacity),
                         device=device, group=group, store=store)
    log(f"[mine] stats: tri_cnt={engine.stats.tri_cnt} "
        f"({engine.stats_seconds:.2f}s)")

    ticket = engine.enqueue(QueryRequest(
        pattern, use_iep=args.use_iep, verify=args.verify, mode=args.mode))
    before = dict(ops.launches)
    engine.run_pending()
    launches = {k: ops.launches[k] - before[k] for k in ops.K1_MODES}
    res = ticket.result
    entry = next(e for e in engine.cache.entries()
                 if e.canon_key == res.canon_key and e.mode == args.mode)
    how = ("cache hit" if res.cache_hit else "persisted plan"
           if engine.cache.stats.persist_hits else "cache miss")
    log(f"[mine] config: schedule={res.order} restrictions={res.res_set} "
        f"iep_k={res.iep_k} (search {res.search_seconds:.3f}s, "
        f"compile {res.compile_seconds:.3f}s, {how})")
    exec_s = res.latency_s - res.search_seconds - res.compile_seconds
    dispatches = engine.last_round_dispatches
    log(f"[mine] count={res.count}  wall={exec_s:.3f}s  "
        f"(query latency {res.latency_s:.3f}s incl. search+compile; "
        f"dispatches: {dispatches}; max frontier rows used: "
        f"{res.max_needed}{', OVERFLOWED' if res.overflowed else ''})")
    ranks = None
    if group is not None:
        from .mesh import rank_lines

        ranks, lines = rank_lines(
            group, "[mine]", wall=entry.matcher.local_seconds,
            passes=entry.matcher.passes, launches=launches)
        for line in lines:
            log(line)

    metrics = engine.metrics
    metrics.counter("executor.dispatches").inc(dispatches)
    metrics.gauge("executor.max_needed").set(res.max_needed)
    for name, sec in (("search", res.search_seconds),
                      ("compile", res.compile_seconds), ("count", exec_s)):
        metrics.histogram(f"mine.{name}_ms").observe(sec * 1e3)
    for mode, n in launches.items():
        metrics.counter("kernel.level_expand.launches", mode=mode).inc(n)
    if args.verify:
        log(f"[mine] oracle={res.expected}  "
            f"{'OK' if res.verified else 'MISMATCH'}")
    return MineResult(
        graph=graph, config=entry.config, plan=entry.plan, result=res,
        engine=engine, dispatches=dispatches,
        search_seconds=res.search_seconds,
        compile_seconds=res.compile_seconds, wall_seconds=exec_s,
        launches=launches, metrics=metrics, expected=res.expected,
        verified=res.verified, group=group, ranks=ranks)


@leaves_group
def main(argv=None) -> int:
    from ..obs.cli import finish_tracing, start_tracing

    args = parse_args(argv)
    start_tracing(args)
    quiet = int(os.environ.get("RANK", "0")) != 0
    res = run(args, log=(lambda line: None) if quiet else print)
    finish_tracing(args, registry=res.metrics, tag="mine")
    rc = 1 if args.verify and not res.verified else 0
    if res.group is not None:
        from .mesh import agreed_exit

        rc = agreed_exit(res.group, rc)
    return rc


if __name__ == "__main__":
    sys.exit(main())
