"""Port parity, plan store: `repro_torch.query.store` (PlanStore,
StoreStats, key_digest) and the store half of the port's `PlanCache` /
`QueryEngine` on the CPU, against the reference's `repro.query.store`.

Port of `tests/test_store.py`.  Record bodies (key, mode, flags,
pattern, config, plan, stats and overlay records) must be field-equal
to the reference store's for the same plan; `key_digest` equal on equal
keys.  Headers differ by design: the port writes torch / cuda /
repro_torch_fingerprint where the reference writes jax / jaxlib /
repro_fingerprint / backend, so each package's reader rejects (counts,
never raises) the other's records.  The port stores no executables.
"""
import json
import os

import pytest
import torch

pytest.importorskip("jax")

from repro.configs.graphpi import get_pattern as rpattern  # noqa: E402
from repro.core import executor as rx                     # noqa: E402
from repro.core.config_search import (                    # noqa: E402
    config_to_dict, search_configuration,
)
from repro.core.plan import build_plan, plan_to_dict      # noqa: E402
from repro.graph.datasets import erdos_renyi, named_dataset  # noqa: E402
from repro.query import PlanCache as RPlanCache           # noqa: E402
from repro.query import PlanStore as RPlanStore           # noqa: E402
from repro.query import QueryEngine as RQueryEngine       # noqa: E402
from repro.query import QueryRequest as RQueryRequest     # noqa: E402
from repro.query import store as rstore                   # noqa: E402
from repro.query.cache import graph_fingerprint as rgfp   # noqa: E402
from repro.query.canon import canonical_form as rcanon    # noqa: E402

from repro_torch.configs.graphpi import get_pattern       # noqa: E402
from repro_torch.convert import graph_from_arrays         # noqa: E402
from repro_torch.core import executor as tx               # noqa: E402
from repro_torch.core.config_search import (              # noqa: E402
    search_configuration as t_search,
)
from repro_torch.core.perf_model import GraphStats        # noqa: E402
from repro_torch.core.plan import build_plan as t_build   # noqa: E402
from repro_torch.query import (                           # noqa: E402
    PlanCache, PlanStore, QueryEngine, QueryRequest, relabeled_variant,
)
from repro_torch.query import store as tstore             # noqa: E402
from repro_torch.query.cache import graph_fingerprint     # noqa: E402
from repro_torch.query.canon import canonical_form        # noqa: E402

torch.set_num_threads(1)

CAP = 1 << 12
CFG = tx.ExecutorConfig(capacity=CAP)
R_CFG = rx.ExecutorConfig(capacity=CAP)
R_GRAPH = erdos_renyi(64, 256, seed=7, name="er64")
T_GRAPH = graph_from_arrays(R_GRAPH.indptr, R_GRAPH.indices,
                            R_GRAPH.degrees, name=R_GRAPH.name)


def _port(g):
    return graph_from_arrays(g.indptr, g.indices, g.degrees, g.labels,
                             name=g.name)


@pytest.fixture(scope="module")
def stats():
    return tx.compute_stats(T_GRAPH, CFG, device="cpu")


@pytest.fixture(scope="module")
def labeled():
    r = named_dataset("tiny-labeled")
    t = _port(r)
    return r, t, tx.compute_stats(t, CFG, device="cpu")


def _engine(graph=T_GRAPH, **kw):
    kw.setdefault("cfg", CFG)
    return QueryEngine(graph, device="cpu", **kw)


def _searched(pattern, stats, *, use_iep=False):
    """(canonical pattern, config, plan) the way the cache persists them."""
    canon = canonical_form(pattern)
    config = t_search(canon, stats, use_iep=use_iep).best
    plan = t_build(canon, config.order, config.res_set, iep_k=config.iep_k)
    return canon, config, plan


def workload():
    return [QueryRequest(get_pattern("P1")),
            QueryRequest(get_pattern("triangle")),
            QueryRequest(get_pattern("rectangle"), use_iep=True)]


def _serve(engine, requests):
    out = []
    for r in requests:
        t = engine.enqueue(r)
        while not t.done:
            engine.run_pending()
        out.append(t.result)
    return out


@pytest.fixture(scope="module")
def warm_store(tmp_path_factory, stats):
    """A store populated by one cold serving pass (write-behind)."""
    root = str(tmp_path_factory.mktemp("plan-store"))
    engine = _engine(store=PlanStore(root), stats=stats)
    results = _serve(engine, workload())
    assert engine.cache.stats.n_searches == len(workload())
    return root, [r.count for r in results]


# ----------------------------------------------- parity with the reference
def _rec(store, digest, version=2):
    with open(os.path.join(store.root, f"v{version}", digest + ".json")) as f:
        return json.load(f)


BODY = ("schema_version", "mode", "use_iep", "sharded", "pattern", "config",
        "plan", "has_executable")


@pytest.mark.parametrize("name,use_iep,labels", [
    ("triangle", False, None), ("P1", False, None), ("P2", True, None),
    ("rectangle", True, None), ("P4", False, None),
    ("rectangle", False, (0, 1, 0, None))])
def test_record_bodies_equal_reference(tmp_path, labeled, name, use_iep,
                                       labels):
    """The same request searched by each package on the same graph, saved
    by each package's store under each package's cache key: every field
    of the record body is equal, and the keys differ only where the
    executor fingerprint names the kernel path."""
    r_graph, t_graph, t_stats = labeled
    r_stats = rx.compute_stats(r_graph, R_CFG)
    rp, tp = rpattern(name), get_pattern(name)
    if labels is not None:
        rp, tp = rp.with_labels(labels), tp.with_labels(labels)
    rc = rcanon(rp)
    r_config = search_configuration(rc, r_stats, use_iep=use_iep).best
    r_plan = build_plan(rc, r_config.order, r_config.res_set,
                        iep_k=r_config.iep_k)
    canon, config, plan = _searched(tp, t_stats, use_iep=use_iep)
    r_key = RPlanCache.entry_key(rc, rgfp(r_graph, r_stats), R_CFG,
                                 use_iep=use_iep)
    # the reference resolves its Pallas path off on the CPU: the port's
    # portable path has the same fingerprint facet
    t_key = PlanCache.entry_key(canon, graph_fingerprint(t_graph, t_stats),
                                tx.ExecutorConfig(capacity=CAP,
                                                  use_kernel=False),
                                use_iep=use_iep)
    rs = RPlanStore(str(tmp_path / "ref"))
    ts = PlanStore(str(tmp_path / "port"))
    rd = rs.save(r_key, pattern=rc, config=r_config, plan=r_plan)
    td = ts.save(t_key, pattern=canon, config=config, plan=plan)
    want, got = _rec(rs, rd), _rec(ts, td)
    for field in BODY:
        assert got[field] == want[field], field
    assert got["config"] == config_to_dict(r_config)
    assert got["plan"] == plan_to_dict(r_plan)
    assert got["key"][:2] == want["key"][:2]
    assert got["key"][3:] == want["key"][3:]
    assert got["key"][2] == want["key"][2].replace("pallas=", "kernel=")
    assert set(got) - set(want) == {"torch", "cuda",
                                    "repro_torch_fingerprint"}
    assert set(want) - set(got) == {"jax", "jaxlib", "repro_fingerprint",
                                    "backend"}
    assert not any(f.endswith(".exec")
                   for f in os.listdir(tmp_path / "port" / "v2"))


@pytest.mark.parametrize("key", [
    ("abc", ("fp", 64, 256, 12), "cap=4096,dyn=1,kernel=1,buckets=none",
     "graphpi", False, ("single", 4096)),
    ("x", ("live", "fp", 3, 64, 250, 9), "s", "naive", True, ("single", 8)),
    ((1, 2, (3, (4, "é"))),), [], ("a", None, 1.5, True)])
def test_key_digest_equal_reference(key):
    assert tstore.key_digest(key) == rstore.key_digest(key)
    assert tstore.key_digest(key) == tstore.key_digest(
        json.loads(json.dumps(key)))


def test_stats_and_overlay_records_equal_reference(tmp_path):
    from repro.core.perf_model import GraphStats as RGraphStats
    from repro.live import DeltaOverlay as RDeltaOverlay

    from repro_torch.live import DeltaOverlay

    rs = RPlanStore(str(tmp_path / "ref"))
    ts = PlanStore(str(tmp_path / "port"))
    assert rs.save_graph_stats("fp", RGraphStats(64, 256, 17))
    assert ts.save_graph_stats("fp", GraphStats(64, 256, 17))
    rl, tl = RDeltaOverlay(R_GRAPH), DeltaOverlay(T_GRAPH)
    for live in (rl, tl):
        live.apply("insert_edges", [(0, 63), (1, 62)])
        live.apply("delete_edges", [tuple(int(x)
                                          for x in R_GRAPH.edge_array()[0])])
    assert rs.save_overlay(rl.to_record()) and ts.save_overlay(tl.to_record())
    for name in ("stats-fp.json", f"live-{R_GRAPH.fingerprint}.json"):
        want = json.load(open(tmp_path / "ref" / "v2" / name))
        got = json.load(open(tmp_path / "port" / "v2" / name))
        want.pop("created_at"), got.pop("created_at")
        assert got == want, name
    # each package reads the other's stats and overlay records (no
    # code-version header on them)
    assert ts.load_graph_stats("fp") == GraphStats(64, 256, 17)
    assert PlanStore(rs.root).load_overlay(R_GRAPH.fingerprint) is not None
    assert RPlanStore(ts.root).load_overlay(R_GRAPH.fingerprint) is not None


def test_each_package_rejects_the_others_plan_records(tmp_path, stats):
    """One cache dir written by both packages: each reader counts the
    other's records as stale (a header mismatch), never raises and never
    serves them."""
    root = str(tmp_path)
    r_eng = RQueryEngine(R_GRAPH, cfg=R_CFG, store=RPlanStore(root))
    t_eng = _engine(store=PlanStore(root), stats=stats)
    _serve(t_eng, [QueryRequest(get_pattern("triangle"))])
    t = r_eng.enqueue(RQueryRequest(rpattern("P1")))
    r_eng.run_pending()
    assert not t.result.cache_hit
    port = PlanStore(root)
    assert [r.pattern.name for r in port.records()] == ["clique3"]
    assert port.stats.rejects == {"torch_version": 1}
    ref = RPlanStore(root)
    assert len(list(ref.records())) == 1
    assert ref.stats.rejects == {"jax_version": 1}
    # the reference's engine warms nothing of the port's, and vice versa
    fresh = _engine(store=PlanStore(root), stats=stats)
    assert fresh.warm_from_disk() == 1                  # its own triangle


# ------------------------------------------------------------- store I/O
def test_store_save_load_round_trip(tmp_path, stats):
    store = PlanStore(str(tmp_path))
    canon, config, plan = _searched(get_pattern("P4"), stats)
    key = PlanCache.entry_key(canon, graph_fingerprint(T_GRAPH, stats), CFG)
    digest = store.save(key, pattern=canon, config=config, plan=plan,
                        search_seconds=0.25)
    assert digest == tstore.key_digest(key)
    assert len(store) == 1
    rec = store.load(key)
    assert rec is not None
    assert rec.config == config and rec.plan == plan
    assert rec.pattern == canon
    assert rec.mode == "graphpi" and rec.use_iep is False
    assert rec.search_seconds == 0.25
    assert rec.header["has_executable"] is False
    other = PlanCache.entry_key(get_pattern("P2"),
                                graph_fingerprint(T_GRAPH, stats), CFG)
    assert store.load(other) is None
    assert store.stats.misses == 1
    assert store.stats.as_dict() == dict(
        loads=1, misses=1, saves=1, exec_drops=0, save_fails=0,
        verify_fails=0, rejects={})


def _tamper(store, digest, **patch):
    path = os.path.join(store.vdir, digest + ".json")
    rec = json.load(open(path))
    rec.update(patch)
    with open(path, "w") as f:
        json.dump(rec, f)


def test_store_rejects_mismatched_headers(tmp_path, stats):
    store = PlanStore(str(tmp_path))
    canon, config, plan = _searched(get_pattern("triangle"), stats)
    key = PlanCache.entry_key(canon, graph_fingerprint(T_GRAPH, stats), CFG)
    digest = store.save(key, pattern=canon, config=config, plan=plan)

    _tamper(store, digest, schema_version=tstore.SCHEMA_VERSION + 1)
    assert store.load(key) is None
    assert store.stats.rejects.get("schema_version") == 1

    _tamper(store, digest, schema_version=tstore.SCHEMA_VERSION,
            torch="0.0.1")
    assert store.load(key) is None
    assert store.stats.rejects.get("torch_version") == 1

    _tamper(store, digest, torch=torch.__version__, cuda="0.0")
    assert store.load(key) is None
    assert store.stats.rejects.get("torch_version") == 2

    _tamper(store, digest, cuda=torch.version.cuda,
            repro_torch_fingerprint="stale-code-fingerprint")
    assert store.load(key) is None
    assert store.stats.rejects.get("repro_torch_fingerprint") == 1

    with open(os.path.join(store.vdir, digest + ".json"), "w") as f:
        f.write("{not json")
    assert store.load(key) is None
    assert store.stats.rejects.get("corrupt") == 1


def test_torn_writes_leave_no_record_and_never_raise(tmp_path, stats,
                                                     monkeypatch):
    store = PlanStore(str(tmp_path))
    canon, config, plan = _searched(get_pattern("triangle"), stats)
    key = PlanCache.entry_key(canon, graph_fingerprint(T_GRAPH, stats), CFG)

    def crash(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(tstore.os, "replace", crash)
    assert store.save(key, pattern=canon, config=config, plan=plan) is None
    assert not store.save_graph_stats("fp", GraphStats(1, 0, 0))
    assert store.stats.save_fails == 2
    monkeypatch.undo()
    assert os.listdir(store.vdir) == []         # the tmp file went too
    # a writer killed mid-write leaves at most a stray tmp file (never
    # read) — or, written without the rename, a truncated record
    with open(os.path.join(store.vdir, "junk.tmp"), "w") as f:
        f.write('{"schema')
    digest = tstore.key_digest(key)
    with open(os.path.join(store.vdir, digest + ".json"), "w") as f:
        f.write('{"schema_version": 2, "pat')
    assert len(store) == 1
    assert store.load(key) is None
    assert store.stats.rejects == {"corrupt": 1}
    assert store.save(key, pattern=canon, config=config, plan=plan) == digest
    assert store.load(key) is not None


def test_fsck_quarantines_unsound_records(tmp_path, stats):
    store = PlanStore(str(tmp_path))
    gfp = graph_fingerprint(T_GRAPH, stats)
    good = []
    for name in ("triangle", "P1"):
        canon, config, plan = _searched(get_pattern(name), stats)
        key = PlanCache.entry_key(canon, gfp, CFG)
        good.append(store.save(key, pattern=canon, config=config,
                               plan=plan))
    # drop a restriction: the plan no longer counts each subgraph once
    rec = _rec(store, good[1])
    assert rec["plan"]["res_set"]
    _tamper(store, good[1], plan=dict(rec["plan"],
                                      res_set=rec["plan"]["res_set"][1:]))
    assert store.save_graph_stats("fp", GraphStats(64, 256, 17))
    with open(os.path.join(store.vdir, "stats-bad.json"), "w") as f:
        f.write("{")
    report = store.fsck()
    assert (report["checked"], report["stats_checked"],
            report["quarantined"]) == (2, 2, 2)
    assert set(report["findings"]) == {good[1], "stats-bad"}
    assert os.path.exists(os.path.join(store.vdir, "quarantine",
                                       good[1] + ".json"))
    assert [r.digest for r in PlanStore(store.root).records()] == [good[0]]


def test_graph_stats_records(tmp_path):
    store = PlanStore(str(tmp_path))
    assert store.load_graph_stats("fp") is None
    assert store.stats.misses == 1
    assert store.save_graph_stats("fp", GraphStats(64, 256, 17))
    assert store.load_graph_stats("fp") == GraphStats(64, 256, 17)
    path = os.path.join(store.vdir, "stats-fp.json")
    rec = json.load(open(path))
    with open(path, "w") as f:
        json.dump(dict(rec, graph_fingerprint="other"), f)
    assert store.load_graph_stats("fp") is None
    with open(path, "w") as f:
        json.dump(dict(rec, tri_cnt=-1), f)
    assert store.load_graph_stats("fp") is None
    assert store.stats.rejects == {"stats_mismatch": 1, "stats_corrupt": 1}
    assert len(store) == 0                      # never counted as a plan


def test_engine_reads_and_writes_graph_stats(tmp_path):
    store = PlanStore(str(tmp_path))
    e1 = _engine(store=store)
    assert store.load_graph_stats(T_GRAPH.fingerprint) == e1.stats
    e2 = _engine(store=PlanStore(store.root))
    assert e2.stats == e1.stats
    assert e2.cache.store.stats.loads == 1 and e2.cache.store.stats.saves == 0


# ------------------------------------------- restart: zero searches
def test_fresh_engine_replays_with_zero_searches(warm_store, stats):
    root, cold = warm_store
    engine = _engine(store=PlanStore(root), stats=stats)
    results = _serve(engine, workload())
    s = engine.cache.stats
    assert [r.count for r in results] == cold
    assert s.n_searches == 0, s.as_dict()
    assert s.persist_hits == len(workload())
    assert s.n_compiles == len(workload())       # matcher warmups
    assert (s.aot_loads, s.aot_load_fails, s.export_fails) == (0, 0, 0)
    assert all(r.search_seconds == 0.0 for r in results)
    # the same counts as the reference's engine
    ref = RQueryEngine(R_GRAPH, cfg=R_CFG)
    want = []
    for r in (RQueryRequest(rpattern("P1")),
              RQueryRequest(rpattern("triangle")),
              RQueryRequest(rpattern("rectangle"), use_iep=True)):
        t = ref.enqueue(r)
        ref.run_pending()
        want.append(t.result.count)
    assert cold == want


def test_warm_from_disk_preloads_then_serves_pure_hits(warm_store, stats):
    root, cold = warm_store
    engine = _engine(store=PlanStore(root), stats=stats)
    assert engine.warm_from_disk() == len(workload())
    reqs = workload() + [
        QueryRequest(relabeled_variant(get_pattern("P1"), seed=5))]
    results = _serve(engine, reqs)
    s = engine.cache.stats
    assert [r.count for r in results[:3]] == cold
    assert results[3].count == cold[0]
    assert s.hits == len(reqs) and s.misses == 0
    assert s.n_searches == 0
    assert s.preloads == len(workload()) and s.persist_hits == 0
    assert engine.warm_from_disk() == 0           # already installed


def test_preload_skips_incompatible_layouts(warm_store, stats):
    root, _ = warm_store
    engine = _engine(cfg=tx.ExecutorConfig(capacity=1 << 11),
                     store=PlanStore(root), stats=stats)
    assert engine.warm_from_disk() == 0
    engine = _engine(chunk=16, store=PlanStore(root), stats=stats)
    assert engine.warm_from_disk() == 0


def test_store_does_not_leak_across_graphs(warm_store):
    root, _ = warm_store
    other = _port(erdos_renyi(64, 256, seed=8, name="er64b"))
    engine = _engine(other, store=PlanStore(root))
    assert engine.warm_from_disk() == 0
    (res,) = _serve(engine, [QueryRequest(get_pattern("P1"))])
    assert not res.cache_hit
    assert engine.cache.stats.persist_hits == 0
    assert engine.cache.stats.n_searches == 1


# ----------------------------------- schema v2: labels + v1 migration
def test_labeled_and_skeleton_never_share_entry_or_record(tmp_path,
                                                          labeled):
    _, graph, stats = labeled
    gfp = graph_fingerprint(graph, stats)
    tri = get_pattern("triangle")
    variants = [tri, tri.with_labels((0, 1, 1)), tri.with_labels((0, 0, 1))]
    keys = [PlanCache.entry_key(p, gfp, CFG) for p in variants]
    assert len({k[0] for k in keys}) == 3
    assert len({tstore.key_digest(k) for k in keys}) == 3
    store = PlanStore(str(tmp_path / "store"))
    cache = PlanCache(store=store)
    for p in variants:
        cache.get_or_build(p, graph, stats, cfg=CFG, device="cpu",
                           warm=False)
    assert len(cache) == 3 and len(store) == 3
    for p in variants:
        _, hit = cache.get_or_build(p, graph, stats, cfg=CFG, device="cpu",
                                    warm=False)
        assert hit
    assert cache.stats.n_searches == 3


def test_labeled_record_round_trips_with_vlabels(tmp_path, labeled):
    _, graph, stats = labeled
    store = PlanStore(str(tmp_path))
    canon, config, plan = _searched(
        get_pattern("rectangle").with_labels((0, 1, 0, None)), stats)
    assert plan.vlabels is not None
    key = PlanCache.entry_key(canon, graph_fingerprint(graph, stats), CFG)
    store.save(key, pattern=canon, config=config, plan=plan)
    rec = PlanStore(store.root).load(key)
    assert rec is not None
    assert rec.pattern == canon and rec.pattern.labels == canon.labels
    assert rec.plan == plan and rec.plan.vlabels == plan.vlabels


def test_v1_unlabeled_records_still_load(tmp_path, stats):
    store = PlanStore(str(tmp_path))
    canon, config, plan = _searched(get_pattern("triangle"), stats)
    key = PlanCache.entry_key(canon, ("gfp", 64, 256, 1), CFG)
    digest = store.save(key, pattern=canon, config=config, plan=plan,
                        schema_version=1)
    assert os.path.exists(os.path.join(store.root, "v1", digest + ".json"))
    assert len(store) == 1
    rec = PlanStore(store.root).load(key)
    assert rec is not None and rec.header["schema_version"] == 1
    store.save(key, pattern=canon, config=config, plan=plan)
    rec2 = PlanStore(store.root).load(key)
    assert rec2.header["schema_version"] == tstore.SCHEMA_VERSION
    digs = [r.digest for r in PlanStore(store.root).records()]
    assert digs.count(digest) == 1


def test_labeled_patterns_refuse_v1_downgrade(tmp_path, stats):
    store = PlanStore(str(tmp_path))
    canon, config, plan = _searched(
        get_pattern("triangle").with_labels((0, 1, 1)), stats)
    key = PlanCache.entry_key(canon, ("gfp", 64, 256, 1), CFG)
    with pytest.raises(ValueError, match="labels are a v2 field"):
        store.save(key, pattern=canon, config=config, plan=plan,
                   schema_version=1)
    with pytest.raises(ValueError, match="unknown schema version"):
        store.save(key, pattern=canon, config=config, plan=plan,
                   schema_version=7)


def test_forged_v1_labeled_record_rejected(tmp_path, stats):
    store = PlanStore(str(tmp_path))
    canon, config, plan = _searched(get_pattern("triangle"), stats)
    key = PlanCache.entry_key(canon, ("gfp", 64, 256, 1), CFG)
    digest = store.save(key, pattern=canon, config=config, plan=plan,
                        schema_version=1)
    path = os.path.join(store.root, "v1", digest + ".json")
    rec = json.load(open(path))
    rec["pattern"]["labels"] = [0, 1, 1]
    with open(path, "w") as f:
        json.dump(rec, f)
    fresh = PlanStore(store.root)
    assert fresh.load(key) is None
    assert fresh.stats.rejects.get("v1-labeled") == 1
    report = PlanStore(store.root).fsck()
    assert any(f.rule == "record-version-labeled"
               for f in report["findings"][digest])
    assert report["quarantined"] == 1
    assert os.path.exists(
        os.path.join(store.root, "v1", "quarantine", digest + ".json"))


def test_labeled_engine_round_trip_through_store(tmp_path, labeled):
    _, graph, stats = labeled
    tri = get_pattern("triangle").with_labels((0, 1, 1))
    root = str(tmp_path / "plan-store")
    e1 = _engine(graph, store=PlanStore(root), stats=stats)
    (r1,) = _serve(e1, [QueryRequest(tri, verify=True)])
    assert r1.verified and not r1.cache_hit
    e2 = _engine(graph, store=PlanStore(root), stats=stats)
    (r2,) = _serve(e2, [QueryRequest(tri)])
    assert r2.count == r1.count
    assert e2.cache.stats.n_searches == 0
    assert e2.cache.stats.persist_hits == 1


def test_metrics_have_store_counters(warm_store, stats):
    root, _ = warm_store
    engine = _engine(store=PlanStore(root), stats=stats)
    engine.warm_from_disk()
    snap = engine.metrics.snapshot()
    flat = json.dumps(snap)
    for k in ("store.loads", "store.rejects", "cache.preloads",
              "cache.persist_hits"):
        assert k in flat
    summary = engine.summary()
    assert summary["store"] == engine.cache.store.stats.as_dict()
    assert summary["cache"]["preloads"] == len(workload())
