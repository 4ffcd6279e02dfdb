"""Port parity, live graph: `repro_torch.live` (DeltaOverlay, EpochStamp,
CountMaintainer) and the live half of the port's `QueryEngine` on the
CPU, against the reference's `repro.live` and its oracle.

Port of `tests/test_live.py`.  After randomized churn the counts at
every epoch equal the reference oracle on the rebuilt graph, on the
portable and the kernel path (K1's plain versions on CPU tensors),
before and after compaction; `edge_delta_digest`, `to_record()` and
`dirty_roots_since` equal the reference overlay's on the same mutation
sequence; epoch swaps are `Matcher.rebind`s, never rebuilds.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core.oracle import count_embeddings_oracle     # noqa: E402
from repro.graph.csr import GraphCSR as RGraphCSR          # noqa: E402
from repro.graph.datasets import erdos_renyi               # noqa: E402
from repro.live import DeltaOverlay as RDeltaOverlay       # noqa: E402
from repro.live import edge_delta_digest as r_digest       # noqa: E402

from repro_torch.configs.graphpi import get_pattern        # noqa: E402
from repro_torch.convert import graph_from_arrays          # noqa: E402
from repro_torch.core import executor as tx                # noqa: E402
from repro_torch.graph.csr import GraphCSR, GraphView      # noqa: E402
from repro_torch.live import (                             # noqa: E402
    MUTATION_VERBS, DeltaOverlay, EpochStamp, edge_delta_digest,
)
from repro_torch.query import PlanStore, QueryEngine, QueryRequest  # noqa: E402

torch.set_num_threads(1)

CAP = 1 << 12
PATHS = ["portable", "kernel"]
R_GRAPH = erdos_renyi(64, 256, seed=7, name="er64")
GRAPH = graph_from_arrays(R_GRAPH.indptr, R_GRAPH.indices, R_GRAPH.degrees,
                          name=R_GRAPH.name)


def _cfg(path="kernel"):
    return tx.ExecutorConfig(capacity=CAP, use_kernel=path == "kernel")


def _engine(graph=GRAPH, path="kernel", **kw):
    return QueryEngine(graph, cfg=_cfg(path), device="cpu", **kw)


def _churn_batches(graph, seed, rounds, n_ins=8, n_del=4):
    """tests/test_live.py's deterministic (insert, delete) batches."""
    rng = np.random.default_rng(seed)
    edges = set(map(tuple, graph.edge_array().tolist()))
    out = []
    for _ in range(rounds):
        ins = []
        while len(ins) < n_ins:
            u, v = sorted(int(x) for x in rng.integers(0, graph.n, 2))
            if u != v and (u, v) not in edges and (u, v) not in ins:
                ins.append((u, v))
        edges |= set(ins)
        pool = sorted(edges)
        dels = [pool[i] for i in
                rng.choice(len(pool), size=n_del, replace=False)]
        edges -= set(dels)
        out.append((ins, dels))
    return out, edges


def _absent_edge(graph, k=0):
    seen = 0
    for u in range(graph.n):
        for v in range(u + 1, graph.n):
            if not graph.has_edge(u, v):
                if seen == k:
                    return (u, v)
                seen += 1
    raise AssertionError("graph is complete")


def _drain(engine, request):
    t = engine.enqueue(request)
    while not t.done:
        engine.run_pending()
    return t.result.count


# ------------------------------------------- overlay parity (unit level)
def test_overlay_matches_reference_through_churn():
    """The same mutation sequence on both packages' overlays: the edge
    key, the store record, the view's rows and the dirty roots since
    every earlier epoch are equal at every step, through an overflow
    compaction and an explicit one."""
    ref = RDeltaOverlay(R_GRAPH, patch_capacity=R_GRAPH.max_degree + 9)
    port = DeltaOverlay(GRAPH, patch_capacity=GRAPH.max_degree + 9)
    assert port.edge_key == ref.edge_key
    batches, _ = _churn_batches(R_GRAPH, seed=11, rounds=4, n_ins=12,
                                n_del=2)
    keys = [ref.edge_key]
    for i, (ins, dels) in enumerate(batches):
        for verb, batch in (("insert_edges", ins), ("delete_edges", dels)):
            assert port.apply(verb, batch) == ref.apply(verb, batch)
            keys.append(ref.edge_key)
        if i == 2:
            port.apply("compact")
            ref.apply("compact")
        assert port.edge_key == ref.edge_key
        assert port.to_record() == ref.to_record()
        assert (port.edge_epoch, port.compactions, port.resizes,
                port.window, port.flat_capacity) == (
            ref.edge_epoch, ref.compactions, ref.resizes, ref.window,
            ref.flat_capacity)
        pv, rv = port.view, ref.view
        assert isinstance(pv, GraphView)
        assert (pv.n, pv.m, pv.window, pv.fingerprint, pv.max_degree) == (
            rv.n, rv.m, rv.window, rv.fingerprint, rv.max_degree)
        for a in ("indptr", "indices", "degrees"):
            np.testing.assert_array_equal(getattr(pv, a), getattr(rv, a))
        np.testing.assert_array_equal(port.materialize_edges(),
                                      ref.materialize_edges())
        for depth in (2, 3, 5):
            for k in keys + ["unknown-epoch"]:
                assert (port.dirty_roots_since(k, depth)
                        == ref.dirty_roots_since(k, depth))
    assert ref.compactions >= 2


def test_edge_delta_digest_equal_reference():
    ins = {(0, 63), (2, 5)}
    dels = {(1, 3)}
    for args in (("fp", set(), set()), ("fp", ins, dels),
                 (GRAPH.fingerprint, dels, ins)):
        assert edge_delta_digest(*args) == r_digest(*args)


def test_view_matches_rebuilt_csr_per_vertex():
    live = DeltaOverlay(GRAPH)
    batches, final_edges = _churn_batches(GRAPH, seed=3, rounds=3)
    for ins, dels in batches:
        live.apply("insert_edges", ins)
        live.apply("delete_edges", dels)
    ref = GraphCSR.from_edges(GRAPH.n, np.asarray(sorted(final_edges)))
    view = live.view
    assert view.m == ref.m
    for v in range(GRAPH.n):
        assert view.neighbors(v).tolist() == ref.neighbors(v).tolist(), v
    live.compact()
    assert live.overlay_edges() == 0
    for v in range(GRAPH.n):
        assert live.view.neighbors(v).tolist() == \
            ref.neighbors(v).tolist(), v


def test_noop_mutations_do_not_bump_epoch():
    live = DeltaOverlay(GRAPH)
    present = tuple(int(x) for x in GRAPH.edge_array()[0])
    absent = _absent_edge(GRAPH)
    assert live.apply("insert_edges", [present]) == 0
    assert live.apply("delete_edges", [absent]) == 0
    assert live.edge_epoch == 0
    assert live.apply("insert_edges", [absent]) == 1
    assert live.edge_epoch == 1


def test_epoch_stamp_levels():
    live = DeltaOverlay(GRAPH)
    stats = tx.compute_stats(live.view, _cfg(), device="cpu")
    s0 = EpochStamp.for_live(live, stats)
    live.apply("insert_edges", [_absent_edge(GRAPH)])
    s1 = EpochStamp.for_live(live, stats)
    assert s1.plan_key == s0.plan_key
    assert s1.edge_key != s0.edge_key
    live.stats_epoch += 1
    assert EpochStamp.for_live(live, stats).plan_key != s1.plan_key
    legacy = EpochStamp.legacy(GRAPH, stats)
    from repro_torch.query.cache import graph_fingerprint
    assert legacy.plan_key == graph_fingerprint(GRAPH, stats)


# ------------------------------------------------------ device tensors
def test_device_graph_accepts_a_view_and_rebinds():
    """A view's rows are (start, len) pairs into a fixed-capacity flat
    array; `device_graph` appends the sentinels after it, epochs keep
    every tensor's shape, and a matcher swaps them by `rebind`."""
    live = DeltaOverlay(GRAPH)
    a0 = tx.device_graph(live.view, "cpu")
    assert a0.flat.shape[0] == live.flat_capacity + \
        tx.ops.flat_gather_pad()
    assert a0.indptr.shape[0] == GRAPH.n + 1
    live.apply("insert_edges", [(0, 63), (1, 62)])
    view = live.view
    a1 = tx.device_graph(view, "cpu")
    assert [t.shape for t in a1[:3]] == [t.shape for t in a0[:3]]
    for v in range(GRAPH.n):
        s, d = int(a1.indptr[v]), int(a1.degrees[v])
        assert a1.flat[s:s + d].tolist() == view.neighbors(v).tolist()
    plan = tx.triangle_plan()
    m = tx.Matcher(live.view, plan, _cfg(), arrays=a1, device="cpu")
    before = m.count().count
    live.apply("delete_edges", [(0, 63)])
    m.rebind(tx.device_graph(live.view, "cpu"), graph=live.view)
    rebuilt = GraphCSR.from_edges(GRAPH.n, live.materialize_edges())
    assert m.count().count == tx.count_embeddings(
        rebuilt, plan, _cfg(), device="cpu").count
    assert before >= m.count().count
    with pytest.raises(ValueError, match="identical array shapes"):
        m.rebind(tx.device_graph(GRAPH, "cpu"))


# ------------------------------------------------ oracle-exact churn
@pytest.mark.parametrize("path", PATHS)
def test_churn_counts_oracle_exact(path):
    """Randomized insert/delete batches with queries between each, with a
    compaction in the middle: every count equals the reference oracle on
    the rebuilt graph; epoch swaps are rebinds."""
    eng = _engine(path=path, live=True)
    patterns = [get_pattern("triangle"), get_pattern("P1")]
    batches, _ = _churn_batches(GRAPH, seed=5, rounds=4)
    for i, (ins, dels) in enumerate(batches):
        eng.request_mutation("insert_edges", ins)
        eng.request_mutation("delete_edges", dels)
        if i == 2:
            eng.request_mutation("compact")
        for p in patterns:
            got = _drain(eng, QueryRequest(p))
            cur = eng.live.materialize_edges()
            want = count_embeddings_oracle(GRAPH.n, cur, p)
            assert got == want, (i, p.name, got, want)
            rebuilt = RGraphCSR.from_edges(GRAPH.n, cur)
            assert count_embeddings_oracle(
                rebuilt.n, rebuilt.edge_array(), p) == want
    assert eng.live.compactions >= 1
    s = eng.summary()["live"]
    assert s["matcher_rebinds"] >= 4 and s["matcher_rebuilds"] == 0
    assert eng.cache.stats.n_searches == 2


def test_churn_counts_equal_reference_engine():
    """The reference's live engine and the port's, the same churn: equal
    counts and equal maintainer decisions at every epoch."""
    from repro.configs.graphpi import get_pattern as rpattern
    from repro.core import executor as rx
    from repro.query import QueryEngine as RQueryEngine
    from repro.query import QueryRequest as RQueryRequest

    ref = RQueryEngine(R_GRAPH, cfg=rx.ExecutorConfig(capacity=CAP),
                       live=True, chunk=16)
    port = _engine(live=True, chunk=16)
    batches, _ = _churn_batches(GRAPH, seed=9, rounds=3, n_ins=2, n_del=1)
    for ins, dels in batches:
        for e in (ref, port):
            e.request_mutation("insert_edges", ins)
            e.request_mutation("delete_edges", dels)
        for name in ("triangle", "P1"):
            t = ref.enqueue(RQueryRequest(rpattern(name)))
            while not t.done:
                ref.run_pending()
            assert _drain(port, QueryRequest(get_pattern(name))) == \
                t.result.count
            assert port.last_round_dispatches == ref.last_round_dispatches
    rs, ps = ref.summary()["live"], port.summary()["live"]
    assert ps == rs


# ------------------------------------- epoch keys: replay vs invalidate
@pytest.mark.parametrize("path", PATHS)
def test_mutation_replays_plans_invalidates_memos(path):
    eng = _engine(path=path, live=True)
    tri = get_pattern("triangle")
    c0 = _drain(eng, QueryRequest(tri))
    searches = eng.cache.stats.n_searches
    compiles = eng.cache.stats.n_compiles
    eng.request_mutation("insert_edges",
                         [_absent_edge(GRAPH, k) for k in range(4)])
    c1 = _drain(eng, QueryRequest(tri))
    assert eng.cache.stats.n_searches == searches
    assert eng.cache.stats.n_compiles == compiles
    s = eng.summary()["live"]
    assert s["matcher_rebinds"] >= 1 and s["matcher_rebuilds"] == 0
    assert s["memo_invalidations"] >= 1
    want = count_embeddings_oracle(GRAPH.n, eng.live.materialize_edges(), tri)
    assert c1 == want and c1 != c0


def test_memo_hit_same_epoch_and_across_compaction():
    eng = _engine(live=True)
    tri = get_pattern("triangle")
    c0 = _drain(eng, QueryRequest(tri))
    c1 = _drain(eng, QueryRequest(tri))
    assert eng.summary()["live"]["memo_hits"] == 1
    assert eng.last_round_dispatches == 0
    eng.request_mutation("compact")
    c2 = _drain(eng, QueryRequest(tri))
    assert eng.summary()["live"]["memo_hits"] == 2
    assert c0 == c1 == c2


def test_growth_past_the_window_rebuilds_matchers():
    """A row that outgrows the fixed window forces new shapes: the engine
    rebuilds its matchers (counted) and stays exact."""
    eng = _engine(live=True)
    tri = get_pattern("triangle")
    _drain(eng, QueryRequest(tri))
    hub = int(np.argmax(GRAPH.degrees))
    ins = [(min(hub, v), max(hub, v)) for v in range(GRAPH.n)
           if v != hub and not GRAPH.has_edge(hub, v)][:12]
    eng.request_mutation("insert_edges", ins)
    got = _drain(eng, QueryRequest(tri))
    s = eng.summary()["live"]
    assert eng.live.resizes >= 1
    assert s["matcher_rebuilds"] == 1 and s["matcher_rebinds"] == 0
    assert eng.cache.stats.n_searches == 1
    want = count_embeddings_oracle(GRAPH.n, eng.live.materialize_edges(), tri)
    assert got == want


# --------------------------------------------- incremental maintenance
def test_incremental_recount_reuses_clean_spans():
    n = 512
    edges = [(i, (i + 1) % n) for i in range(n)] + \
            [(i, (i + 2) % n) for i in range(n)]
    edges = np.asarray(sorted({(min(u, v), max(u, v)) for u, v in edges}))
    g = GraphCSR.from_edges(n, edges, name="ring512")
    eng = _engine(g, live=True, chunk=64)
    tri = get_pattern("triangle")
    _drain(eng, QueryRequest(tri))
    full_dispatches = eng.last_round_dispatches
    eng.request_mutation("insert_edges", [(100, 103)])
    got = _drain(eng, QueryRequest(tri))
    s = eng.summary()["live"]
    assert s["incremental_hits"] == 1 and s["full_recounts"] == 0
    assert s["spans_reused"] >= 6
    assert eng.last_round_dispatches < full_dispatches
    want = count_embeddings_oracle(n, eng.live.materialize_edges(), tri)
    assert got == want


def test_global_churn_falls_back_to_full_recount():
    eng = _engine(live=True, chunk=8)
    tri = get_pattern("triangle")
    _drain(eng, QueryRequest(tri))
    ins = [(u, u + 3) for u in range(0, 64, 8)
           if not GRAPH.has_edge(u, u + 3)]
    eng.request_mutation("insert_edges", ins)
    got = _drain(eng, QueryRequest(tri))
    assert eng.summary()["live"]["full_recounts"] >= 1
    want = count_embeddings_oracle(GRAPH.n, eng.live.materialize_edges(), tri)
    assert got == want


# ------------------------------------ round-boundary mutation semantics
def test_preempted_whale_across_mutation():
    eng = _engine(live=True, chunk=8, preempt_dispatches=1)
    p3 = get_pattern("P3")
    t = eng.enqueue(QueryRequest(p3))
    eng.run_pending()
    assert not t.done and eng.inflight() == 1
    eng.request_mutation("insert_edges",
                         [_absent_edge(GRAPH, k) for k in range(4)])
    while not t.done:
        eng.run_pending()
    assert eng.preemptions >= 1
    want = count_embeddings_oracle(GRAPH.n, eng.live.materialize_edges(), p3)
    assert t.result.count == want


def test_submit_racing_mutate_is_round_deterministic():
    eng = _engine(live=True)
    tri = get_pattern("triangle")
    t_before = eng.enqueue(QueryRequest(tri))
    eng.request_mutation("insert_edges",
                         [_absent_edge(GRAPH, k) for k in range(4)])
    t_after = eng.enqueue(QueryRequest(tri))
    eng.run_pending()
    assert t_before.done and t_after.done
    want = count_embeddings_oracle(GRAPH.n, eng.live.materialize_edges(), tri)
    assert t_before.result.count == t_after.result.count == want


def test_request_mutation_validates():
    eng = _engine(live=True)
    with pytest.raises(ValueError):
        eng.request_mutation("explode", [(0, 1)])
    frozen = _engine()
    with pytest.raises(RuntimeError):
        frozen.request_mutation("insert_edges", [(0, 1)])
    assert frozen.mutations_pending() == 0
    ack = eng.request_mutation("insert_edges", [(0, 63)])
    assert set(ack) == {"verb", "queued_edges", "pending_batches",
                        "edge_epoch"}
    assert eng.mutations_pending() == 1
    assert "compact" in MUTATION_VERBS
    with pytest.raises(TypeError):
        _engine(live="yes")


# --------------------------------------------------- overlay persistence
def test_overlay_record_roundtrip_and_fsck(tmp_path):
    import json

    store = PlanStore(str(tmp_path / "plans"))
    eng = _engine(live=True, store=store)
    tri = get_pattern("triangle")
    eng.request_mutation("insert_edges", [(0, 63), (1, 62)])
    eng.request_mutation("delete_edges",
                         [tuple(int(x) for x in GRAPH.edge_array()[0])])
    c = _drain(eng, QueryRequest(tri))
    rec = store.load_overlay(eng.live.base0_fingerprint)
    assert rec is not None
    resumed = DeltaOverlay.from_record(GRAPH, rec)
    assert resumed.edge_key == eng.live.edge_key
    eng2 = _engine(live=resumed)
    assert _drain(eng2, QueryRequest(tri)) == c
    report = store.fsck()
    assert report["overlays_checked"] == 1 and report["quarantined"] == 0
    path = store._overlay_path(eng.live.base0_fingerprint)
    with open(path, "w") as f:
        json.dump(dict(rec, inserts=[[63, 0]]), f)
    report = store.fsck()
    assert report["quarantined"] == 1
    assert store.load_overlay(eng.live.base0_fingerprint) is None


def test_save_overlay_rejects_malformed(tmp_path):
    store = PlanStore(str(tmp_path / "plans"))
    rec = DeltaOverlay(GRAPH).to_record()
    assert store.save_overlay(rec)
    assert not store.save_overlay(dict(rec, edge_epoch=-1))
    assert not store.save_overlay(dict(rec, inserts=[[2, 2]]))
    assert not store.save_overlay(dict(rec, inserts=[[0, 5]],
                                       deletes=[[0, 5]]))
    assert len(store) == 0


def test_live_metrics_have_the_reference_keys():
    from repro.core import executor as rx
    from repro.query import QueryEngine as RQueryEngine

    ref = RQueryEngine(R_GRAPH, cfg=rx.ExecutorConfig(capacity=CAP),
                       live=True)
    port = _engine(live=True)
    rk = {k for k in ref.metrics.snapshot() if k.startswith("live.")}
    pk = {k for k in port.metrics.snapshot() if k.startswith("live.")}
    assert pk == rk and pk
    assert set(port.summary()["live"]) == set(ref.summary()["live"])
