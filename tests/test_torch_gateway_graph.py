"""Port parity, the graph tenant of the serving Gateway:
`repro_torch.serve.gateway.GraphQueryWorkload` over the port's
`QueryEngine` on the CPU, against the reference's gateway and engine.

The graph cases of `tests/test_gateway.py`: coalescing (N iso-variant
tickets, one execution), the gateway's round, distinct classes in one
round, `plan()` never executing, the deprecated submit/serve shims, and
the report fields.  Gateway counts must equal both the port's direct
engine rounds and the reference gateway's, on the portable and the
kernel path (K1's plain versions on CPU tensors).
"""
import pytest
import torch

pytest.importorskip("jax")

from repro.configs.graphpi import get_pattern as rpattern  # noqa: E402
from repro.core import executor as rx                     # noqa: E402
from repro.graph.datasets import erdos_renyi               # noqa: E402
from repro.query import QueryEngine as RQueryEngine        # noqa: E402
from repro.query import QueryRequest as RQueryRequest      # noqa: E402
from repro.query import relabeled_variant as r_relabel     # noqa: E402
from repro.serve import gateway as rgw                     # noqa: E402

from repro_torch.configs.graphpi import get_pattern        # noqa: E402
from repro_torch.convert import graph_from_arrays          # noqa: E402
from repro_torch.core import executor as tx                # noqa: E402
from repro_torch.query import (                            # noqa: E402
    QueryEngine, QueryRequest, relabeled_variant,
)
from repro_torch.serve.gateway import (                    # noqa: E402
    Gateway, GraphQueryWorkload, Share,
)

torch.set_num_threads(1)

CAP = 1 << 12
R_GRAPH = erdos_renyi(64, 256, seed=7, name="er64")
GRAPH = graph_from_arrays(R_GRAPH.indptr, R_GRAPH.indices, R_GRAPH.degrees,
                          name=R_GRAPH.name)


@pytest.fixture(scope="module")
def stats():
    return tx.compute_stats(GRAPH, tx.ExecutorConfig(capacity=CAP),
                            device="cpu")


def _engine(stats, path="kernel", **kw):
    cfg = tx.ExecutorConfig(capacity=CAP, use_kernel=path == "kernel")
    return QueryEngine(GRAPH, cfg=cfg, stats=stats, device="cpu", **kw)


# (pattern name, relabel seed or None, request options)
MIX = [("triangle", None, {}), ("P1", None, {}), ("P1", 3, {}),
       ("triangle", 5, {}), ("P2", None, dict(use_iep=True)),
       ("P4", None, dict(mode="naive")), ("P1", 9, {}),
       ("rectangle", None, dict(use_iep=True, tenant="b")),
       ("rectangle", 2, dict(use_iep=True, tenant="b"))]


def _requests(pattern, relabel, request):
    out = []
    for name, seed, kw in MIX:
        p = pattern(name)
        if seed is not None:
            p = relabel(p, seed=seed)
        out.append(request(p, **kw))
    return out


def _report_shape(rep):
    """The report with its times replaced by their counts."""
    out = {"rounds": rep["rounds"], "workloads": {}}
    for name, w in rep["workloads"].items():
        m = dict(w["metrics"])
        m["latency"] = m["latency"]["n"]
        m["tenants"] = {t: (v["resolved"], v["rejected"], v["pending"],
                            v["share"], v["latency"]["n"])
                        for t, v in m["tenants"].items()}
        out["workloads"][name] = dict(
            items=w["items"], turns=w["turns"],
            solo=w["turn_item_ms"]["solo"]["n"],
            contended=w["turn_item_ms"]["contended"]["n"], metrics=m)
    return out


@pytest.mark.parametrize("path,quantum", [("portable", 3), ("kernel", 1),
                                          ("kernel", 9)])
def test_gateway_matches_reference_gateway_and_direct_engine(stats, path,
                                                             quantum):
    """The same ticket mix through the port's gateway, the reference's
    gateway and the port's engine driven round by round: equal counts,
    cache flags, coalescing and report fields (times aside)."""
    ref_engine = RQueryEngine(R_GRAPH, cfg=rx.ExecutorConfig(capacity=CAP))
    rg = rgw.Gateway()
    rwl = rg.add(rgw.GraphQueryWorkload(
        ref_engine, _requests(rpattern, r_relabel, RQueryRequest)),
        rgw.Share(quantum=quantum))
    rg.run()

    engine = _engine(stats, path)
    gw = Gateway()
    wl = gw.add(GraphQueryWorkload(
        engine, _requests(get_pattern, relabeled_variant, QueryRequest)),
        Share(quantum=quantum))
    gw.run()

    direct = _engine(stats, path)
    tickets = [direct.enqueue(r) for r in
               _requests(get_pattern, relabeled_variant, QueryRequest)]
    while direct.pending():
        direct.run_pending(limit=quantum)

    def rows(results):
        return [(r.pattern_name, r.count, r.cache_hit, r.coalesced,
                 r.canon_key, r.mode, r.use_iep) for r in results]

    got = rows(wl.results())
    assert got == rows(rwl.results())
    assert got == rows([t.result for t in tickets])
    assert len(got) == len(MIX)
    assert _report_shape(gw.report()) == _report_shape(rg.report())
    assert wl.metrics()["coalesced"] == direct.coalesced
    assert gw.trace.interleaving() == rg.trace.interleaving()


def test_coalescing_one_execution_many_tickets(stats):
    engine = _engine(stats)
    p = get_pattern("P1")
    tickets = [engine.enqueue(QueryRequest(relabeled_variant(p, seed=s)))
               for s in range(4)]
    assert engine.run_pending() == tickets
    assert len({t.result.count for t in tickets}) == 1
    assert len(engine.cache) == 1
    assert engine.executions == 1 and engine.coalesced == 3
    assert engine.cache.entries()[0].executions == 1
    assert [t.result.cache_hit for t in tickets] == [False, True, True, True]
    assert [t.result.coalesced for t in tickets] == [False, True, True, True]
    assert engine.cache.stats.hits == 3
    assert engine.cache.stats.n_searches == 1
    assert engine.cache.stats.n_compiles == 1


def test_gateway_graph_workload_round(stats):
    engine = _engine(stats)
    p = get_pattern("triangle")
    reqs = [QueryRequest(relabeled_variant(p, seed=s)) for s in range(3)]
    gw = Gateway()
    wl = gw.add(GraphQueryWorkload(engine, reqs), Share(quantum=len(reqs)))
    gw.run()
    results = wl.results()
    assert len(results) == 3 and len({r.count for r in results}) == 1
    assert engine.executions == 1 and engine.pending() == 0
    assert wl.metrics()["coalesced"] == 2
    rep = gw.report()
    assert set(rep["workloads"]["graph"]) == {"items", "turns",
                                             "turn_item_ms", "metrics"}
    assert set(wl.metrics()) == {
        "requests", "executions", "coalesced", "pending", "inflight",
        "preemptions", "rejections", "latency", "tenants", "cache_hits",
        "cache_misses"}


def test_prewarm_plans_every_class_without_counting(stats):
    engine = _engine(stats)
    reqs = [QueryRequest(get_pattern("triangle")),
            QueryRequest(relabeled_variant(get_pattern("triangle"), 4)),
            QueryRequest(get_pattern("P1"))]
    gw = Gateway()
    wl = gw.add(GraphQueryWorkload(engine, reqs, prewarm=True))
    gw.warmup()
    assert len(engine.cache) == 2 and engine.executions == 0
    gw.run(warmup=False)
    assert [r.cache_hit for r in wl.results()] == [True, True, True]
    assert engine.cache.stats.n_searches == 2


def test_distinct_classes_micro_batch_in_one_round(stats):
    engine = _engine(stats)
    for r in (QueryRequest(get_pattern("triangle")),
              QueryRequest(get_pattern("rectangle")),
              QueryRequest(relabeled_variant(get_pattern("triangle"), 5))):
        engine.enqueue(r)
    assert len(engine.run_pending()) == 3
    assert engine.executions == 2 and engine.coalesced == 1
    assert len(engine.cache) == 2


def test_plan_never_executes(stats):
    engine = _engine(stats)
    planned = engine.plan(QueryRequest(get_pattern("triangle")))
    assert not planned.cache_hit
    assert engine.executions == 0 and planned.entry.executions == 0
    assert engine.plan(QueryRequest(get_pattern("triangle"))).cache_hit


def test_unresolved_ticket_raises(stats):
    t = _engine(stats).enqueue(QueryRequest(get_pattern("triangle")))
    assert not t.done
    with pytest.raises(RuntimeError, match="Gateway"):
        _ = t.result


@pytest.mark.parametrize("name", ["P1", "P2", "P3", "P4", "P5", "P6"])
def test_plan_enqueue_parity_with_submit(stats, name):
    engine = _engine(stats)
    p = get_pattern(name)
    with pytest.deprecated_call():
        old = engine.submit(QueryRequest(p))
    ticket = engine.enqueue(QueryRequest(relabeled_variant(p, seed=11)))
    engine.run_pending()
    new = ticket.result
    assert new.count == old.count and new.canon_key == old.canon_key
    assert new.cache_hit
    assert not old.overflowed and not new.overflowed


def test_serve_shim_deprecated_and_sequential(stats):
    engine = _engine(stats)
    p = get_pattern("triangle")
    with pytest.deprecated_call():
        results = engine.serve(
            [QueryRequest(p), QueryRequest(relabeled_variant(p, 3))])
    assert [r.cache_hit for r in results] == [False, True]
    assert [r.coalesced for r in results] == [False, False]
    assert engine.executions == 2


def test_submit_drains_fifo_tickets_ahead_of_it(stats):
    engine = _engine(stats)
    early = engine.enqueue(QueryRequest(get_pattern("triangle")))
    with pytest.deprecated_call():
        res = engine.submit(QueryRequest(get_pattern("rectangle")))
    assert early.done and res.pattern_name == "rectangle"
    assert engine.executions == 2


def test_mutation_only_rounds_keep_the_gateway_going(stats):
    """A live engine whose queue holds only a mutation is still ready,
    and the round that applies it counts as progress."""
    engine = QueryEngine(GRAPH, cfg=tx.ExecutorConfig(capacity=CAP),
                         live=True, device="cpu")
    gw = Gateway()
    wl = gw.add(GraphQueryWorkload(engine))
    absent = next((0, v) for v in range(1, GRAPH.n)
                  if not GRAPH.has_edge(0, v))
    engine.request_mutation("insert_edges", [absent])
    assert wl.ready()
    trace = gw.run()
    assert trace.rounds == 1 and engine.mutations_pending() == 0
    assert engine.live.edge_epoch == 1 and not wl.ready()
