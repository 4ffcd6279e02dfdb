"""Port parity, query path: `repro_torch.query` (PlanCache, QueryEngine)
and the engine-backed `mine` on the CPU, against the reference's
`repro.query` on the same graph and the same scripted workloads.

Ports of `tests/test_query.py`, the engine half of `tests/test_preempt.py`
(preempted counts resumed bit-identically, mouse/whale rotation,
weighted round-robin, admission, cancel) and the mine cases of
`tests/test_launchers.py` that need no plan store; and the 54 labeled
questions of `benchmarks/questions.py` answered through the port's
engine on both paths, as `tests/test_questions.py` asks of the
reference.  The port runs on both of its paths: the portable one and the
kernel one (K1's plain version on CPU tensors).  Counts are exact int64;
cache flags, coalescing, executions, dispatches, rejections and
canonical keys must be equal — only wall times may differ.
"""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from benchmarks.questions import (                        # noqa: E402
    DATASET, inventory, oracle_answers,
)
from repro import query as rquery                         # noqa: E402
from repro.configs.graphpi import EXTRA_PATTERNS, PATTERNS  # noqa: E402
from repro.configs.graphpi import get_pattern as rpattern  # noqa: E402
from repro.core import executor as rx                     # noqa: E402
from repro.core.pattern import cycle                      # noqa: E402
from repro.graph.datasets import erdos_renyi, named_dataset  # noqa: E402
from repro.query import cache as rcache                   # noqa: E402

from repro_torch import query as tquery                   # noqa: E402
from repro_torch.configs.graphpi import get_pattern as tpattern  # noqa: E402
from repro_torch.convert import graph_from_arrays         # noqa: E402
from repro_torch.core import executor as tx               # noqa: E402
from repro_torch.core.pattern import Pattern as TPattern  # noqa: E402
from repro_torch.query import cache as tcache             # noqa: E402

torch.set_num_threads(1)

CAP = 1 << 12
PATHS = ["portable", "kernel"]
R_CFG = rx.ExecutorConfig(capacity=CAP)


def _port(g):
    return graph_from_arrays(g.indptr, g.indices, g.degrees, g.labels,
                             name=g.name)


# tests/test_query.py:18-20 and tests/test_preempt.py:25-27
R_GRAPH = erdos_renyi(64, 256, seed=7, name="er64")
T_GRAPH = _port(R_GRAPH)


def _pkg(side, path=None):
    """The two packages behind one surface, so each scenario below is
    written once and run on both."""
    if side == "ref":
        return SimpleNamespace(
            q=rquery, pattern=rpattern,
            engine=lambda **kw: rquery.QueryEngine(R_GRAPH, cfg=R_CFG, **kw))
    cfg = tx.ExecutorConfig(capacity=CAP, use_kernel=path == "kernel")
    return SimpleNamespace(
        q=tquery, pattern=tpattern,
        engine=lambda **kw: tquery.QueryEngine(T_GRAPH, cfg=cfg,
                                               device="cpu", **kw))


def _res(t):
    """Everything a resolved ticket reports except wall times."""
    r = t.result
    return (t.seq, r.pattern_name, r.canon_key, int(r.count), r.cache_hit,
            r.coalesced, r.mode, r.use_iep, tuple(r.order),
            tuple(r.res_set), r.iep_k, r.overflowed, r.max_needed,
            r.expected, r.verified, r.search_seconds == 0.0,
            r.compile_seconds == 0.0)


def _eng(e):
    """An engine's counters, tenant report and cache stats, minus times."""
    cs = e.cache.stats
    return dict(
        resolved=e.requests_resolved, executions=e.executions,
        coalesced=e.coalesced, preemptions=e.preemptions,
        last_round_dispatches=e.last_round_dispatches,
        rejections=dict(e.rejections), pending=e.pending(),
        inflight=e.inflight(), entries=len(e.cache),
        cache=(cs.hits, cs.misses, cs.n_searches, cs.n_compiles,
               cs.evictions),
        entry_executions=sorted((x.canon_key, x.mode, x.executions, x.hits)
                                for x in e.cache.entries()),
        tenants={t: (v["resolved"], v["rejected"], v["pending"],
                     v["share"], v["latency"]["n"])
                 for t, v in e.tenant_report().items()})


# ----------------------------------------------------------- scenarios --
def sc_sequential(p):
    """tests/test_query.py's engine cases, one request per round."""
    e = p.engine()
    out = []
    script = [("P1", {}), ("P1@11", {}), ("P2", dict(use_iep=True)),
              ("triangle", {}), ("rectangle", dict(use_iep=True)),
              ("P1", {}), ("P4", dict(mode="graphpi")),
              ("P4", dict(mode="graphzero")), ("P4", dict(mode="naive")),
              ("P4", dict(mode="naive", use_iep=True))]
    for name, kw in script:
        base, _, seed = name.partition("@")
        pat = p.pattern(base)
        if seed:
            pat = p.q.relabeled_variant(pat, seed=int(seed))
        t = e.enqueue(p.q.QueryRequest(pat, verify=True, **kw))
        resolved = e.run_pending(limit=1)
        out.append(([x.seq for x in resolved], _res(t), _eng(e)))
    return out


def sc_coalesce(p):
    """Duplicates of one class in one round resolve in one execution."""
    e = p.engine()
    q = p.q
    tri = p.pattern("triangle")
    reqs = [q.QueryRequest(p.pattern("P1")),
            q.QueryRequest(q.relabeled_variant(p.pattern("P1"), seed=3)),
            q.QueryRequest(tri),
            q.QueryRequest(q.relabeled_variant(p.pattern("P1"), seed=5)),
            q.QueryRequest(tri, verify=True),
            q.QueryRequest(p.pattern("P2"), use_iep=True),
            q.QueryRequest(p.pattern("P2"))]
    tickets = [e.enqueue(r) for r in reqs]
    first = [x.seq for x in e.run_pending()]
    again = e.enqueue(q.QueryRequest(p.pattern("P1")))
    second = [x.seq for x in e.run_pending()]
    return (first, second, [_res(t) for t in tickets + [again]], _eng(e))


def sc_uninterrupted(p):
    """tests/test_preempt.py's reference counts: chunk 8, no budget."""
    e = p.engine(chunk=8)
    out = {}
    for name in ("triangle", "P1", "P3"):
        t = e.enqueue(p.q.QueryRequest(p.pattern(name)))
        e.run_pending()
        out[name] = (int(t.result.count), e.last_round_dispatches)
    return out


def sc_preempted(p):
    """Budget 1: one dispatch per round until P3 completes."""
    e = p.engine(chunk=8, preempt_dispatches=1)
    t = e.enqueue(p.q.QueryRequest(p.pattern("P3")))
    rounds = []
    while not t.done:
        resolved = e.run_pending()
        rounds.append((len(resolved), e.inflight(), e.last_round_dispatches))
        assert len(rounds) <= 500
    return rounds, _res(t), _eng(e)


def sc_mouse_whale(p):
    """tests/test_preempt.py: a naive-P3 whale suspended at budget 8
    rotates behind a triangle mouse enqueued after it."""
    e = p.engine(chunk=8, preempt_dispatches=8)
    q = p.q
    whale = e.enqueue(q.QueryRequest(p.pattern("P3"), mode="naive",
                                     tenant="whale"))
    rounds = [[x.seq for x in e.run_pending()]]
    mouse = e.enqueue(q.QueryRequest(p.pattern("triangle"), tenant="mouse"))
    while not whale.done:
        rounds.append(([x.seq for x in e.run_pending()], mouse.done,
                       e.inflight()))
        assert len(rounds) <= 60
    return rounds, _res(whale), _res(mouse), _eng(e)


def sc_wrr(p):
    """Weighted round-robin keeps a small tenant ahead of a flood."""
    out = []
    for shares, limit in ((None, 2), ({"whale": 3}, 4)):
        e = p.engine(tenant_shares=shares)
        q = p.q
        ts = [e.enqueue(q.QueryRequest(p.pattern("triangle"),
                                       tenant="whale")) for _ in range(6)]
        ts.append(e.enqueue(q.QueryRequest(p.pattern("P1"),
                                           tenant="mouse")))
        resolved = [x.seq for x in e.run_pending(limit=limit)]
        out.append((resolved, [t.done for t in ts], e.pending("whale"),
                    e.pending("mouse"), _eng(e)))
    return out


def sc_admission(p):
    """tenant_depth=2: deterministic, counted rejections."""
    e = p.engine(tenant_depth=2)
    q = p.q
    tri = p.pattern("triangle")
    outs = []
    for tenant in ("A", "A", "A", "A", "B"):
        r = e.try_enqueue(q.QueryRequest(tri, tenant=tenant))
        outs.append((r.tenant, r.reason, r.depth, r.limit)
                    if isinstance(r, q.Rejection) else ("ticket", r.seq))
    with pytest.raises(q.AdmissionRejected) as ei:
        e.enqueue(q.QueryRequest(tri, tenant="A"))
    rej = ei.value.rejection
    snap = e.metrics.snapshot()
    before = (snap["engine.admission_rejected"],
              snap["engine.admission_rejected{tenant=A}"])
    e.run_pending()
    reopened = not isinstance(e.try_enqueue(q.QueryRequest(tri, tenant="A")),
                              q.Rejection)
    return outs, (rej.tenant, rej.depth, rej.limit), before, reopened, _eng(e)


def sc_cancel(p):
    e = p.engine()
    a = e.enqueue(p.q.QueryRequest(p.pattern("triangle")))
    b = e.enqueue(p.q.QueryRequest(p.pattern("triangle")))
    flags = [e.cancel(a), a.cancelled, a.done, e.cancel(a)]
    resolved = [t.seq for t in e.run_pending()]
    flags.append(e.cancel(b))
    return flags, resolved, _res(b), _eng(e)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_sequential, sc_coalesce, sc_uninterrupted, sc_preempted,
    sc_mouse_whale, sc_wrr, sc_admission, sc_cancel)}
_ref_runs: dict = {}


def _reference(name):
    if name not in _ref_runs:
        _ref_runs[name] = SCENARIOS[name](_pkg("ref"))
    return _ref_runs[name]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_reference(name, path):
    """The same scripted workload through both engines: equal counts,
    hit/miss/coalesced flags, executions, dispatches per round, rejections
    and canonical keys."""
    assert SCENARIOS[name](_pkg("port", path)) == _reference(name)


@pytest.mark.parametrize("path", PATHS)
def test_preempted_counts_resume_to_the_uninterrupted_ones(path):
    """Within the port: budgets of 1 and 8 dispatches per round give the
    uninterrupted counts, bit-identical, in as many dispatches."""
    p = _pkg("port", path)
    want = sc_uninterrupted(p)
    rounds, res, eng = sc_preempted(p)
    assert res[3] == want["P3"][0]
    assert len(rounds) == want["P3"][1] == sum(r[2] for r in rounds)
    assert eng["preemptions"] == len(rounds) - 1 and eng["executions"] == 1
    _, whale, mouse, _ = sc_mouse_whale(p)
    assert whale[3] == want["P3"][0] and mouse[3] == want["triangle"][0]


# ------------------------------------------------------ cache and keys --
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_canonical_keys_equal_reference(name):
    for seed in range(4):
        assert tquery.canonical_key(tquery.relabeled_variant(
            tpattern(name), seed=seed)) == rquery.canonical_key(
                rquery.relabeled_variant(rpattern(name), seed=seed))
    assert tquery.canonical_key(tpattern(name)) == \
        rquery.canonical_key(rpattern(name))


def test_cache_keys_equal_reference():
    """Entry keys equal the reference's facet for facet: canonical key,
    graph fingerprint, mode, use_iep (naive ignores it) and layout are
    byte-equal; the executor fingerprint differs only in naming its
    kernel facet `kernel=` where the reference has `pallas=`."""
    r_stats = rx.compute_stats(R_GRAPH, R_CFG)
    t_cfg = tx.ExecutorConfig(capacity=CAP, use_kernel=False)
    t_stats = tx.compute_stats(T_GRAPH, t_cfg, device="cpu")
    assert vars(t_stats) == vars(r_stats)
    r_fp = rcache.graph_fingerprint(R_GRAPH, r_stats)
    t_fp = tcache.graph_fingerprint(T_GRAPH, t_stats)
    assert t_fp == r_fp
    for name in ("P1", "P2", "triangle", "clique4"):
        for kw in (dict(), dict(use_iep=True), dict(mode="naive"),
                   dict(mode="naive", use_iep=True), dict(mode="graphzero")):
            for chunk in (None, CAP, 512):
                r = rquery.PlanCache.entry_key(
                    rpattern(name), r_fp, R_CFG,
                    layout_fp=rcache.layout_fingerprint(None, "data", chunk,
                                                        R_CFG), **kw)
                t = tquery.PlanCache.entry_key(
                    tpattern(name), t_fp, t_cfg,
                    layout_fp=tcache.layout_fingerprint(chunk, t_cfg), **kw)
                assert t[:2] == r[:2] and t[3:] == r[3:]
                assert t[2] == r[2].replace("pallas=", "kernel=")
    base = tquery.PlanCache.entry_key(tpattern("P2"), t_fp, t_cfg)
    assert tquery.PlanCache.entry_key(tquery.relabeled_variant(
        tpattern("P2"), 3), t_fp, t_cfg) == base
    assert tquery.PlanCache.entry_key(tpattern("P2"), t_fp,
                                      tx.ExecutorConfig(capacity=CAP)) != base


def test_canonical_key_is_stable_across_processes():
    assert tquery.canonical_key(TPattern.from_dict(cycle(4).to_dict())) == \
        "09936e89b622b79de515caad45084940c92ed6845cd3c709570a28e22cf7ac72"
    for name in sorted(EXTRA_PATTERNS):
        assert tquery.canonical_key(tpattern(name)) == \
            rquery.canonical_key(rpattern(name))


def test_cache_lru_eviction_releases_matchers():
    cfg = tx.ExecutorConfig(capacity=CAP)
    stats = tx.compute_stats(T_GRAPH, cfg, device="cpu")
    cache = tquery.PlanCache(max_entries=2)
    entries = [cache.get_or_build(tpattern(n), T_GRAPH, stats, cfg=cfg,
                                  device="cpu", warm=False)[0]
               for n in ("triangle", "rectangle", "clique4")]
    assert len(cache) == 2 and cache.stats.evictions == 1
    with pytest.raises(RuntimeError, match="released"):
        entries[0].count()
    _, hit = cache.get_or_build(tpattern("triangle"), T_GRAPH, stats,
                                cfg=cfg, device="cpu", warm=False)
    assert not hit
    assert entries[2].count().count == entries[2].matcher.count().count


@pytest.mark.parametrize("path", PATHS)
def test_summary_and_metrics_have_the_reference_keys(path):
    rt = _pkg("ref").engine()
    pt = _pkg("port", path).engine()
    for e, p in ((rt, _pkg("ref")), (pt, _pkg("port", path))):
        e.enqueue(p.q.QueryRequest(p.pattern("triangle")))
        e.run_pending()
    r_snap, t_snap = rt.metrics.snapshot(), pt.metrics.snapshot()
    assert set(t_snap) == set(r_snap)
    assert {k: v for k, v in t_snap.items() if "_ms" not in k
            and "seconds" not in k} == {k: v for k, v in r_snap.items()
                                        if "_ms" not in k
                                        and "seconds" not in k}
    s = pt.summary()
    assert set(s) - {"device"} == set(rt.summary())
    assert s["latency"]["n"] == 1
    assert s["latency"]["p99_ms"] >= s["latency"]["p50_ms"] >= 0.0


def test_deprecated_submit_matches_enqueue_path():
    e = _pkg("port", "kernel").engine()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = e.submit(tquery.QueryRequest(tpattern("P1"), verify=True))
        again = e.serve([tquery.QueryRequest(tpattern("P1"))])
    assert res.verified and again[0].cache_hit
    assert again[0].count == res.count
    assert sum(issubclass(x.category, DeprecationWarning) for x in w) == 2


def test_engine_refuses_cuda_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tquery.QueryEngine(T_GRAPH)


# ----------------------------------------------------------- questions --
@pytest.fixture(scope="module")
def questions():
    graph = named_dataset(DATASET)
    qs = inventory()
    return graph, qs, oracle_answers(graph, qs)


@pytest.mark.parametrize("path", PATHS)
def test_all_questions_answered_through_the_engine(questions, path):
    """The 54 labeled questions through the port's engine, one round:
    every answer equals the oracle's, none overflowed."""
    graph, qs, truth = questions
    cfg = tx.ExecutorConfig(capacity=CAP, use_kernel=path == "kernel")
    e = tquery.QueryEngine(_port(graph), cfg=cfg, device="cpu")
    tickets = {q.qid: e.enqueue(tquery.QueryRequest(
        TPattern.from_dict(q.pattern.to_dict()))) for q in qs}
    e.run_pending()
    wrong = {qid: (t.result.count, truth[qid]) for qid, t in tickets.items()
             if t.result.count != truth[qid] or t.result.overflowed}
    assert len(qs) >= 50 and not wrong, wrong
    assert e.executions + e.coalesced == len(qs)


# ----------------------------------------------------------------- mine --
def test_mine_end_to_end_through_the_engine(capsys):
    """tests/test_launchers.py: P1 on tiny-er, verified, as a one-request
    engine client (a cache miss); graphzero and naive agree on P4."""
    from repro_torch.launch import mine

    assert mine.main(["--pattern", "P1", "--dataset", "tiny-er", "--verify",
                      "--capacity", str(1 << 14), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cache miss" in out and "[mine] oracle=27358  OK" in out
    res = mine.run(mine.parse_args(["--pattern", "P4", "--mode", "naive",
                                    "--verify", "--device", "cpu"]),
                   log=lambda line: None)
    assert res.verified and res.engine.executions == 1
    assert res.dispatches >= 1 and res.plan.res_set == ()
    for mode in ("graphzero", "naive"):
        assert mine.main(["--pattern", "P4", "--dataset", "tiny-er",
                          "--mode", mode, "--verify", "--device", "cpu"]) == 0
    assert np.all([line.endswith("OK") for line in capsys.readouterr().out
                   .splitlines() if line.startswith("[mine] oracle")])
