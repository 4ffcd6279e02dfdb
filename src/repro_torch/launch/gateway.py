"""The unified serving front door: graph queries + LM decode, one device.

    PYTHONPATH=src python -m repro_torch.launch.gateway --dataset tiny-er \
        --workload smoke --arch qwen3-1.7b --gen 8 --batch 2 \
        --prompt-len 16 --graph-quantum 4 --lm-quantum 2 --device cpu

Port of `repro/launch/gateway.py`: `--device` (default cuda, which
raises without a card) names this process's device, and
the LM tenant is the port's `LMSession` for any `--arch` of
`repro_torch.configs.ARCHS` (`--full-lm`: the full config, prefill
attention through kernel K4 on a card).  Builds ONE Gateway
that owns the process's device and co-schedules two tenants on it: a `GraphQueryWorkload` (the pattern-query engine's
ticket queue — same request format and synthetic workloads as
`launch/query_serve.py`, and bit-identical counts: only the scheduling
differs) and an `LMDecodeWorkload` (`LMSession`, resumable).  The round
scheduler interleaves them under the per-workload Share policy
(quantum/weight/priority); same-isomorphism-class graph queries that
land in one round coalesce into a single plan execution.

`--no-lm` serves graph traffic only (the trace-identity configuration:
a request file replayed here and through `launch/query_serve.py` must
produce identical counts per query).  `--model-buckets` sizes the
executor's degree buckets from the perf model's predicted frontier
occupancy instead of the legacy 4×-margin heuristic.

`--listen PORT` turns the process into the multi-tenant RPC front door
(serve/rpc.py): instead of draining a fixed workload and exiting, the
gateway stays resident and N client processes submit/poll/cancel
tickets over length-prefixed JSON frames (`python -m
repro_torch.serve.rpc --connect HOST:PORT --requests trace.jsonl`).  PORT 0 binds an
ephemeral port; `--port-file` writes "host port" once bound so scripts
can rendezvous.  `--preempt-dispatches` bounds kernel dispatches per
round (huge queries checkpoint and resume), `--tenant-depth` bounds
each tenant's queue (admission control), `--live` serves a mutable
graph (the `mutate` RPC verb).

Under torchrun (world size > 1, without `--single-device`) the graph
tenant is sharded over the ranks, one process per GPU
(`serve/spmd.py`): rank 0 owns the scheduler and the RPC server and
broadcasts each round to the other ranks, which replay it on their own
`QueryEngine(group=)`.  The LM tenant spans the ranks as a data ×
model grid (`--model-axis M`, any divisor of the world; the layout
and tensor parallelism as in `launch.serve`): every rank holds its
shard of the session and makes the calls rank 0's scheduler makes,
which rank 0 broadcasts before each.  Rank 0 alone prints, with one
line per rank (its counting wall and K1 launches), and every rank
exits with the same code.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.gateway --no-lm --listen 0 --port-file F

`run(parse_args(argv))` does what `main` does and returns the pieces it
built (engine, gateway, results, LM session, RPC server) beside the exit
code, for callers that check them.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

from .mesh import leaves_group


@dataclass
class GatewayRun:
    rc: int
    engine: object            # the QueryEngine of the graph tenant
    gateway: object           # the Gateway
    results: list             # resolved graph QueryResults, admission order
    session: object = None    # the LMSession, without --no-lm
    server: object = None     # the GatewayRPCServer, with --listen
    follower: object = None   # a non-zero rank's Follower, sharded


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.gateway")
    # ---- graph-query tenant
    ap.add_argument("--dataset", default="tiny-er")
    ap.add_argument("--requests", default="",
                    help="JSON-lines request file (overrides --workload)")
    ap.add_argument("--workload", default="mixed",
                    choices=["mixed", "smoke"])
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--use-iep", action="store_true")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--capacity", type=int, default=1 << 15)
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--max-entries", type=int, default=256)
    ap.add_argument("--cache-dir", default="",
                    help="persistent plan store (query/store.py)")
    ap.add_argument("--warm-from-disk", action="store_true")
    ap.add_argument("--model-buckets", action="store_true",
                    help="size degree buckets from the perf model's "
                         "predicted frontier occupancy (default: legacy "
                         "4x-margin heuristic)")
    ap.add_argument("--graph-quantum", type=int, default=4,
                    help="graph tickets per scheduler turn (duplicates "
                         "within a turn coalesce)")
    ap.add_argument("--expect-min-hits", type=int, default=-1)
    ap.add_argument("--expect-coalesced", type=int, default=-1,
                    help="fail unless >= this many tickets coalesced")
    # ---- LM tenant
    ap.add_argument("--no-lm", action="store_true",
                    help="graph-only (trace-identity mode)")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--full-lm", action="store_true",
                    help="full config instead of the CPU smoke variant")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--lm-quantum", type=int, default=2,
                    help="decode steps per scheduler turn")
    ap.add_argument("--lm-weight", type=int, default=1,
                    help="LM turns per round (fair-share weight)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="tensor-parallel ranks per LM replica under "
                         "torchrun (must divide the world)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    # ---- RPC front door / multi-tenancy
    ap.add_argument("--listen", type=int, default=-1, metavar="PORT",
                    help="serve tickets over a socket instead of draining "
                         "a fixed workload (0 = ephemeral port)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port-file", default="",
                    help="write 'host port' here once the socket is bound")
    ap.add_argument("--preempt-dispatches", type=int, default=0,
                    help="kernel-dispatch budget per engine round (0 = "
                         "run every class to completion)")
    ap.add_argument("--tenant-depth", type=int, default=0,
                    help="max queued tickets per tenant (0 = unbounded)")
    ap.add_argument("--live", action="store_true",
                    help="serve over a MUTABLE graph: accept mutate RPC "
                         "verbs (insert_edges/delete_edges/compact), "
                         "applied at round boundaries via the delta "
                         "overlay (src/repro_torch/live/)")
    # ---- shared
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--single-device", action="store_true",
                    help="serve on this process's device even under "
                         "torchrun")
    ap.add_argument("--seed", type=int, default=0)
    from ..obs.cli import add_trace_args

    add_trace_args(ap)
    return ap.parse_args(argv)


@leaves_group
def main(argv=None) -> int:
    return run(parse_args(argv)).rc


def _quiet(*_a, **_kw) -> None:
    pass


def _sharded_exit(group, engine, before: dict, rc: int, log) -> int:
    """Every rank's tail of a sharded run (collectives): the per-rank
    counting walls and K1 launches, which rank 0 prints, then the
    exit code agreed over the ranks."""
    from ..kernels import ops
    from .mesh import agreed_exit, rank_lines

    launches = {k: ops.launches[k] - before[k] for k in ops.K1_MODES}
    matchers = [e.matcher for e in engine.cache.entries()]
    _, lines = rank_lines(
        group, "[gateway]", wall=sum(m.local_seconds for m in matchers),
        passes=sum(m.passes for m in matchers), launches=launches)
    for line in lines:
        log(line)
    return agreed_exit(group, rc)


def _result_rc(results, log) -> int:
    rc = 0
    bad = [r for r in results if r.verified is False]
    if bad:
        log(f"[gateway] VERIFY FAILED for {[r.pattern_name for r in bad]}")
        rc = 1
    over = [r for r in results if r.overflowed]
    if over:
        log(f"[gateway] OVERFLOWED (truncated counts) for "
            f"{[r.pattern_name for r in over]}")
        rc = rc or 3
    return rc


def run(args, *, log=print) -> GatewayRun:
    """Serve as `args` (from :func:`parse_args`) describe; `log` receives
    the `[gateway]` lines."""
    from ..configs.graphpi import get_dataset, get_pattern
    from ..core.executor import ExecutorConfig, auto_buckets, compute_stats
    from ..kernels import ops
    from ..launch.query_serve import build_requests
    from ..obs.cli import finish_tracing, start_tracing
    from ..obs import MetricsRegistry
    from ..query import PlanCache, PlanStore, QueryEngine, canonical_key
    from ..serve.gateway import (
        Gateway, GraphQueryWorkload, LMDecodeWorkload, Share,
    )
    from ..serve.session import LMSession
    from ..serve.spmd import Follower, LeaderEngine, LeaderSession
    from .mesh import launched_sharded, shared_group

    start_tracing(args)

    if args.warm_from_disk and not args.cache_dir:
        log("[gateway] --warm-from-disk requires --cache-dir")
        return GatewayRun(2, None, None, [])
    if args.resume and not args.ckpt_dir:
        log("[gateway] --resume requires --ckpt-dir")
        return GatewayRun(2, None, None, [])

    # under torchrun every rank serves the graph tenant sharded: rank 0
    # leads (scheduler, RPC server, LM tenant, all the printing), the
    # other ranks follow its rounds (serve/spmd.py)
    group, device = None, args.device
    if launched_sharded(args.single_device):
        group, device = shared_group(args.device, log=log)
        if group.rank() != 0:
            log = _quiet
    elif args.model_axis != 1:
        raise ValueError(f"--model-axis {args.model_axis} needs a world of "
                         f"ranks it divides (torchrun --nproc-per-node)")
    leads = group is None or group.rank() == 0
    graph = get_dataset(args.dataset)
    cfg = ExecutorConfig(capacity=args.capacity)
    stats = None
    if args.model_buckets:
        stats = compute_stats(graph, cfg, device=device)
        from dataclasses import replace

        cfg = replace(cfg, degree_buckets=auto_buckets(graph, stats=stats))
    store = PlanStore(args.cache_dir) if args.cache_dir else None
    # ONE registry for the whole front door: the engine's query-latency
    # histogram and the scheduler's per-share turn histograms land in
    # the same snapshot (and reset_window resets both at once)
    metrics = MetricsRegistry()
    kw = dict(
        cfg=cfg, chunk=args.chunk or None, device=device,
        cache=PlanCache(max_entries=args.max_entries or None, store=store),
        stats=stats, metrics=metrics,
        preempt_dispatches=args.preempt_dispatches or None,
        live=args.live or None,
    )
    depth = args.tenant_depth or None
    listen = args.listen >= 0
    if group is None:
        engine = QueryEngine(graph, tenant_depth=depth, **kw)
    elif leads:
        # the LM tenant's calls go through the followers' loop too, so
        # they stop only once the gateway has run both tenants
        engine = LeaderEngine(graph, group=group, tenant_depth=depth,
                              stop_when_drained=not listen and args.no_lm,
                              **kw)
    else:
        # admission is rank 0's alone: a follower replays its decisions
        engine = QueryEngine(graph, group=group, **kw)
    where = (str(engine.device) if group is None else
             f"{engine.summary()['devices']} ranks (rank 0 on "
             f"{engine.device})")
    log(f"[gateway] graph={graph.name} (|V|={graph.n}, |E|={graph.m}) "
        f"resident on {where}"
        f"{'; LIVE (mutable, delta overlay)' if args.live else ''}"
        f"{'; model buckets ' + repr(cfg.degree_buckets) if args.model_buckets else ''}")
    if args.warm_from_disk:
        n = engine.warm_from_disk()
        log(f"[gateway] warm-from-disk: {n} plan(s) preloaded")
    before = dict(ops.launches)

    def lm_session():
        return LMSession(
            args.arch, smoke=not args.full_lm, batch=args.batch,
            prompt_len=args.prompt_len, gen=args.gen, device=engine.device,
            seed=args.seed, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, metrics=metrics, group=group,
            model_axis=args.model_axis)

    if not leads:
        session = None if args.no_lm else lm_session()
        follower = Follower(engine, session=session).run()
        results = follower.results()
        rc = _sharded_exit(group, engine, before,
                           _result_rc(results, log), log)
        return GatewayRun(rc, engine, None, results, session,
                          follower=follower)

    # a listening server starts with an empty queue unless a trace file
    # pre-seeds it — clients are the request source
    requests = [] if (listen and not args.requests) \
        else build_requests(args, get_pattern)
    distinct = len({canonical_key(r.pattern) for r in requests})
    log(f"[gateway] {len(requests)} graph requests "
        f"({distinct} distinct isomorphism classes)")

    gw = Gateway(device=engine.device, metrics=metrics)
    graph_wl = gw.add(GraphQueryWorkload(engine, requests),
                      Share(quantum=max(args.graph_quantum, 1)))
    session = None
    if not args.no_lm:
        session = lm_session()
        lm = session if group is None else LeaderSession(session, engine)
        gw.add(LMDecodeWorkload(lm, resume=args.resume),
               Share(quantum=max(args.lm_quantum, 1),
                     weight=max(args.lm_weight, 1)))
        log(f"[gateway] lm={args.arch} "
            f"({'smoke' if not args.full_lm else 'full'}): "
            f"{args.batch}x{args.prompt_len} prompt, {args.gen} steps")

    if listen:
        from ..serve.rpc import GatewayRPCServer

        server = GatewayRPCServer(
            gw, graph_wl, host=args.host, port=args.listen,
            get_pattern=get_pattern,
            keepalive=None if group is None else engine.keepalive)

        def on_ready(host, port):
            log(f"[gateway] listening on {host}:{port}")
            sys.stdout.flush()
            if args.port_file:
                import os
                tmp = args.port_file + ".tmp"
                with open(tmp, "w") as f:
                    f.write(f"{host} {port}\n")
                os.replace(tmp, args.port_file)

        server.serve_forever(on_ready=on_ready)
        if group is not None:
            engine.stop()
        s = engine.summary()
        log(f"[gateway] served {server.rounds} rounds over "
            f"{server.connections} connection(s): "
            f"{s['requests_resolved']} requests, "
            f"{s['executions']} executions, {s['coalesced']} coalesced, "
            f"{s['preemptions']} preemptions, "
            f"{s['rejections']} rejected")
        if args.live:
            lv = s["live"]
            log(f"[gateway] live: edge_epoch={lv['edge_epoch']} "
                f"mutations={lv['mutations_applied']} "
                f"compactions={lv['compactions']} "
                f"rebinds={lv['matcher_rebinds']} "
                f"incremental={lv['incremental_hits']} "
                f"memo_hits={lv['memo_hits']}")
        rc = 0
        if group is not None:
            rc = _sharded_exit(group, engine, before, rc, log)
        finish_tracing(args, registry=metrics, tag="gateway")
        return GatewayRun(rc, engine, gw, graph_wl.results(), session,
                          server)

    gw.run()
    if group is not None:
        engine.stop()

    results = graph_wl.results()
    for r in results:
        log(f"[gateway] {r.line()}")

    rep = gw.report()
    names = [t.name for t in gw.trace.turns]
    log(f"[gateway] {rep['rounds']} rounds, interleaving: "
        f"{' '.join(names[:24])}{' ...' if len(names) > 24 else ''}")
    s = engine.summary()
    log(f"[gateway] graph: {s['requests_resolved']} requests, "
        f"{s['executions']} executions, {s['coalesced']} coalesced; "
        f"p50={s['latency']['p50_ms']:.1f}ms "
        f"p99={s['latency']['p99_ms']:.1f}ms; "
        f"cache {s['cache']['hits']} hits / {s['cache']['misses']} misses")
    # interference evidence: per-item turn latency split solo vs
    # contended, for every workload that has either bin (a tenant the
    # other side outlasts is 100% contended — still worth printing; the
    # solo baseline then comes from benchmarks/gateway_mix.py's
    # dedicated solo phase)
    for name, wr in rep["workloads"].items():
        tm = wr["turn_item_ms"]
        parts = [f"{bin_} {tm[bin_]['p50_ms']:.1f}ms (n={tm[bin_]['n']})"
                 for bin_ in ("solo", "contended") if tm[bin_]["n"]]
        if not parts:
            continue
        x = (f"; contended/solo = {wr['interference_x']:.2f}x"
             if "interference_x" in wr else "")
        log(f"[gateway] {name} per-item turn p50: "
            f"{', '.join(parts)}{x}")
    if not args.no_lm:
        m = rep["workloads"]["lm"]["metrics"]
        how = (f"resumed from step {m['resumed_from']}"
               if m["resumed_from"] is not None
               else f"prefill {m['prefill_seconds']:.3f}s")
        log(f"[gateway] lm: {m['steps_done']}/{m['steps_total']} steps "
            f"({how}, {m['decode_tok_s']:.1f} tok/s, "
            f"{m['ms_per_step']:.1f} ms/step)")
        log(f"[gateway] lm sample tokens[0,:16] = "
            f"{session.tokens_out()[0, :16].tolist()}")

    finish_tracing(args, registry=metrics, tag="gateway")

    rc = _result_rc(results, log)
    if args.expect_min_hits >= 0 and s["cache"]["hits"] < args.expect_min_hits:
        log(f"[gateway] EXPECTED >= {args.expect_min_hits} cache hits, "
            f"got {s['cache']['hits']}")
        rc = rc or 2
    if args.expect_coalesced >= 0 and s["coalesced"] < args.expect_coalesced:
        log(f"[gateway] EXPECTED >= {args.expect_coalesced} coalesced "
            f"tickets, got {s['coalesced']}")
        rc = rc or 2
    if group is not None:
        rc = _sharded_exit(group, engine, before, rc, log)
    return GatewayRun(rc, engine, gw, results, session)


if __name__ == "__main__":
    sys.exit(main())
