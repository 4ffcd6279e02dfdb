"""End-to-end pattern-counting driver on one device (the paper's workload).

    PYTHONPATH=src python -m repro_torch.launch.mine --pattern P1 --dataset tiny-er --verify
    PYTHONPATH=src python -m repro_torch.launch.mine --pattern P2 --dataset small-rmat \
        --use-iep --verify --device cpu

Pipeline (paper Fig. 3): the graph is uploaded once and its triangle
count bootstraps the performance model; restriction generation (Alg. 1)
→ 2-phase schedule generation → performance-model configuration
selection over the pattern's canonical form → `build_plan` → counting
through the chunked `Matcher` loop, whose levels run the CUDA kernel K1
on a card.  `--mode graphzero` runs the baseline (single restriction
set, degree-heuristic schedule); `--mode naive` drops the restrictions
and divides by |Aut|.

This composes the steps the reference's `PlanCache.get_or_build` runs
for one request directly; the query engine and its plan store are not
part of this package yet.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, replace

from ..obs import timer


@dataclass
class MineResult:
    graph: object
    config: object
    plan: object
    result: object            # CountResult (naive mode: divided by |Aut|)
    dispatches: int
    search_seconds: float
    compile_seconds: float
    wall_seconds: float       # the count alone, after warmup
    launches: dict            # K1 launches per mode, the count alone
    metrics: object           # MetricsRegistry (the --metrics snapshot)
    expected: int | None = None
    verified: bool | None = None


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
    add_trace_args(ap)
    return ap.parse_args(argv)


def plan_for(pattern, stats, *, mode: str = "graphpi",
             use_iep: bool = False):
    """(config, plan) for one request — the search and `build_plan`
    that the reference's `PlanCache.get_or_build` runs on a miss
    (`query/cache.py:236-253`), over the pattern's canonical form.
    Naive plans carry no restrictions: their raw count is |Aut| times
    the answer."""
    from ..core.config_search import (graphzero_configuration,
                                      search_configuration)
    from ..core.plan import build_plan
    from ..query.canon import canonical_form

    canon = canonical_form(pattern)
    if mode == "graphpi":
        config = search_configuration(canon, stats, use_iep=use_iep).best
    elif mode == "graphzero":
        config = graphzero_configuration(canon, stats, use_iep=use_iep)
    elif mode == "naive":
        config = search_configuration(canon, stats, use_iep=False).best
    else:
        raise ValueError(f"unknown mode {mode!r}")
    res_set = () if mode == "naive" else config.res_set
    return config, build_plan(canon, config.order, res_set,
                              iep_k=config.iep_k)


def run(args, *, log=print) -> MineResult:
    """One counting request as `args` (from :func:`parse_args`) describe
    it; `log` receives the reference's `[mine]` lines."""
    from ..configs.graphpi import get_dataset, get_pattern
    from ..core.executor import (ExecutorConfig, Matcher, compute_stats,
                                 device_graph)
    from ..kernels import ops
    from ..obs import MetricsRegistry, get_tracer

    pattern = get_pattern(args.pattern)
    graph = get_dataset(args.dataset)
    log(f"[mine] pattern={pattern.name} (n={pattern.n}, m={pattern.m}, "
        f"|Aut|={pattern.aut_count()})  graph={graph.name} "
        f"(|V|={graph.n}, |E|={graph.m}, max_deg={graph.max_degree})")

    cfg = ExecutorConfig(capacity=args.capacity)
    arrays = device_graph(graph, args.device)      # ONE resident upload
    with timer() as t:
        stats = compute_stats(graph, cfg, device=args.device, arrays=arrays)
    log(f"[mine] stats: tri_cnt={stats.tri_cnt} ({t.seconds:.2f}s)")

    with get_tracer().span("cache.search", mode=args.mode), timer() as t:
        config, plan = plan_for(pattern, stats, mode=args.mode,
                                use_iep=args.use_iep)
    search_s = t.seconds

    matcher = Matcher(graph, plan, cfg, arrays=arrays, device=args.device)
    with get_tracer().span("cache.compile", mode=args.mode), timer() as t:
        matcher.warmup()
    compile_s = t.seconds
    log(f"[mine] config: schedule={config.order} restrictions={plan.res_set} "
        f"iep_k={config.iep_k} (search {search_s:.3f}s, "
        f"compile {compile_s:.3f}s)")

    before = dict(ops.launches)
    with timer() as t:
        state, out = matcher.count_partial()
    launches = {k: n - before[k] for k, n in ops.launches.items()}
    if args.mode == "naive":
        out = replace(out, count=out.count // plan.pattern.aut_count())
    log(f"[mine] count={out.count}  wall={t.seconds:.3f}s  "
        f"(dispatches: {state.dispatches}; "
        f"max frontier rows used: {out.max_needed}"
        f"{', OVERFLOWED' if out.overflowed else ''})")
    metrics = MetricsRegistry()
    metrics.counter("executor.dispatches").inc(state.dispatches)
    metrics.gauge("executor.max_needed").set(out.max_needed)
    for name, sec in (("search", search_s), ("compile", compile_s),
                      ("count", t.seconds)):
        metrics.histogram(f"mine.{name}_ms").observe(sec * 1e3)
    for mode, n in launches.items():
        metrics.counter("kernel.level_expand.launches", mode=mode).inc(n)
    res = MineResult(
        graph=graph, config=config, plan=plan, result=out,
        dispatches=state.dispatches, search_seconds=search_s,
        compile_seconds=compile_s, wall_seconds=t.seconds,
        launches=launches, metrics=metrics)

    if args.verify:
        from ..core.oracle import count_embeddings_oracle

        res.expected = count_embeddings_oracle(
            graph.n, graph.edge_array(), pattern, labels=graph.labels)
        res.verified = res.expected == out.count
        log(f"[mine] oracle={res.expected}  "
            f"{'OK' if res.verified else 'MISMATCH'}")
    return res


def main(argv=None) -> int:
    from ..obs.cli import finish_tracing, start_tracing

    args = parse_args(argv)
    start_tracing(args)
    res = run(args)
    finish_tracing(args, registry=res.metrics, tag="mine")
    if args.verify and not res.verified:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
