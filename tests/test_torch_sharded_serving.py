"""Multi-GPU serving on the CPU: the port's `QueryEngine(group=)` over
two gloo ranks (spawned), the live engine's sharded branch, and the
launchers under `torchrun --standalone --nproc-per-node 2`.

Every rank builds the same engine and serves the same requests:
same-class tickets coalesce into one execution, isomorphic re-queries
are cache hits, a sharded count ignores the dispatch budget (one unit,
no preemption), the store's records say ``"sharded": true`` and rank 0
alone writes them, and a restarted engine runs no configuration search.
A live engine through two epochs of seeded churn counts what the oracle
counts on the rebuilt graph at every epoch, from the memo when the
epoch is unchanged.  Record bodies and the sharded layout
fingerprint's shape are field-equal to the reference's.  `mine`,
`query_serve` and `examples/torch_distributed_match.py` exit 0 under
torchrun, with rank 0 alone printing.  Counts are exact.

The spawned ranks import this file by name, so the JAX reference is
imported inside the tests that need it.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist
from torch_ranks import init_rank, spawn_ranks

from repro_torch.configs.graphpi import get_pattern
from repro_torch.core import executor as tx
from repro_torch.core.oracle import count_embeddings_oracle
from repro_torch.graph.datasets import erdos_renyi, named_dataset
from repro_torch.query import (
    PlanStore, QueryEngine, QueryRequest, relabeled_variant,
)
from repro_torch.query.cache import layout_fingerprint

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAP = 1 << 13
CFG = tx.ExecutorConfig(capacity=CAP)
WORLD = 2
CHURN_SEED = 19


def _requests():
    p1, p2 = get_pattern("P1"), get_pattern("P2")
    return [QueryRequest(p1), QueryRequest(relabeled_variant(p1, seed=3)),
            QueryRequest(p2)]


def _serve(engine, requests):
    """Enqueue, then run rounds until every ticket resolved; returns the
    results and each round's (resolved tickets, dispatch units)."""
    tickets = [engine.enqueue(r) for r in requests]
    rounds = []
    while not all(t.done for t in tickets):
        done = engine.run_pending()
        rounds.append([len(done), engine.last_round_dispatches])
    return [t.result for t in tickets], rounds


def _result(r):
    return [r.count, r.cache_hit, r.coalesced, r.max_needed, r.overflowed]


def _churn(graph, rounds=2, n_ins=12, n_del=6):
    """Seeded (insert, delete) batches, the same on every rank."""
    rng = np.random.default_rng(CHURN_SEED)
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
        dels = [pool[i] for i in rng.choice(len(pool), n_del, replace=False)]
        edges -= set(dels)
        out.append((ins, dels))
    return out


def _serve_rank(rank, world, rdv, out_dir):
    group, dev = init_rank(rank, world, rdv)
    out = {}
    store_dir = os.path.join(out_dir, "store")
    graph = named_dataset("tiny-er")
    eng = QueryEngine(graph, cfg=CFG, device=dev, group=group,
                      store=PlanStore(store_dir), preempt_dispatches=1)
    results, rounds = _serve(eng, _requests())
    again, again_rounds = _serve(eng, [QueryRequest(
        relabeled_variant(get_pattern("P2"), seed=5))])
    out["cold"] = {
        "results": [_result(r) for r in results + again],
        "rounds": rounds + again_rounds,
        "executions": eng.executions, "coalesced": eng.coalesced,
        "preemptions": eng.preemptions, "cache": eng.cache.stats.as_dict(),
        "saves": eng.cache.store.stats.saves,
        "sharded": [e.sharded for e in eng.cache.entries()],
        "devices": eng.summary()["devices"]}
    dist.barrier(group)              # rank 0 has written every record
    out["layout"] = list(layout_fingerprint(None, CFG, group=group,
                                            device=dev))
    for how in ("load-through", "warm-from-disk"):
        eng2 = QueryEngine(graph, cfg=CFG, device=dev, group=group,
                           store=PlanStore(store_dir))
        preloaded = eng2.warm_from_disk() if how == "warm-from-disk" else 0
        res2, _ = _serve(eng2, _requests())
        out[how] = {"results": [_result(r) for r in res2],
                    "preloaded": preloaded,
                    "cache": eng2.cache.stats.as_dict(),
                    "stats_saves": eng2.cache.store.stats.saves}

    small = erdos_renyi(64, 256, seed=7, name="er64")
    live = QueryEngine(small, cfg=CFG, device=dev, group=group, live=True)
    pats = [get_pattern("triangle"), get_pattern("P1")]
    epochs = []

    def epoch():
        res, _ = _serve(live, [QueryRequest(p) for p in pats])
        view = live.live.view
        edges = view.edge_array()
        want = [count_embeddings_oracle(view.n, edges, p) for p in pats]
        epochs.append({"counts": [r.count for r in res], "oracle": want,
                       "maint": dict(live._maintainer.counters())})

    epoch()
    epoch()                          # unchanged epoch: memo hits
    for ins, dels in _churn(small):
        live.request_mutation("insert_edges", ins)
        live.request_mutation("delete_edges", dels)
        epoch()
    out["live"] = {"epochs": epochs,
                   "rebinds": live.matcher_rebinds,
                   "rebuilds": live.matcher_rebuilds,
                   "searches": live.cache.stats.n_searches}
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# the launcher runs under torchrun (started before the spawned ranks, so
# they all run at once): name -> argv after `--nproc-per-node 2`
LAUNCHES = {
    "mine": ["-m", "repro_torch.launch.mine", "--device", "cpu",
             "--verify"],
    "query_serve": ["-m", "repro_torch.launch.query_serve", "--device",
                    "cpu", "--workload", "smoke", "--verify", "--capacity",
                    str(CAP), "--chunk", "64", "--expect-min-hits", "2"],
    "query_serve_fails": ["-m", "repro_torch.launch.query_serve",
                          "--device", "cpu", "--workload", "smoke",
                          "--capacity", str(CAP), "--expect-min-hits", "99"],
    "example": [str(ROOT / "examples" / "torch_distributed_match.py"),
                "--device", "cpu"],
}


def _torchrun(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawned ranks' records, and each launch's (exit code, stdout,
    stderr)."""
    tmp = tmp_path_factory.mktemp("sharded-serving")
    procs = {name: _torchrun(argv) for name, argv in LAUNCHES.items()}
    try:
        spawn_ranks(_serve_rank, WORLD, tmp, str(tmp))
        runs = {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=240)
            runs[name] = (proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return tmp, [json.loads((tmp / f"r{r}.json").read_text())
                 for r in range(WORLD)], runs


def test_group_engine_coalesces_hits_and_ignores_the_budget(ranks):
    _, recs, _ = ranks
    for rec in recs:
        c = rec["cold"]
        res = c["results"]
        assert [r[0] for r in res] == [27_358, 27_358, 87_724, 87_724]
        # P1 and its relabeling coalesce; the relabeled P2 is a hit
        assert [r[1:3] for r in res] == [[False, False], [True, True],
                                         [False, False], [True, False]]
        assert not any(r[4] for r in res)
        # budget 1: each sharded count is one unit and completes in its
        # round, so no class is preempted
        assert c["rounds"] == [[2, 1], [1, 1], [1, 1]]
        assert c["preemptions"] == 0
        assert c["executions"] == 3 and c["coalesced"] == 1
        assert c["cache"]["n_searches"] == 2 and c["cache"]["hits"] == 2
        assert c["sharded"] == [True, True] and c["devices"] == WORLD
    assert recs[0]["cold"]["results"] == recs[1]["cold"]["results"]


def test_store_records_are_sharded_and_written_by_rank_0(ranks):
    tmp, recs, _ = ranks
    # two plan records and the graph's stats record
    assert recs[0]["cold"]["saves"] == 3 and recs[1]["cold"]["saves"] == 0
    bodies = [json.loads(p.read_text())
              for p in sorted((tmp / "store" / "v2").glob("*.json"))
              if not p.name.startswith(("stats-", "live-"))]
    assert len(bodies) == 2
    for body in bodies:
        assert body["sharded"] is True and body["has_executable"] is False
        assert body["key"][5][:4] == ["sharded", "data", CAP // 16,
                                      [["data", WORLD]]]


def test_restarted_group_engine_runs_no_search(ranks):
    _, recs, _ = ranks
    for rec in recs:
        cold = rec["cold"]["results"][:3]
        lt, wd = rec["load-through"], rec["warm-from-disk"]
        assert [r[0] for r in lt["results"]] == [r[0] for r in cold]
        assert [r[0] for r in wd["results"]] == [r[0] for r in cold]
        assert lt["cache"]["n_searches"] == wd["cache"]["n_searches"] == 0
        assert lt["cache"]["persist_hits"] == 2
        assert wd["preloaded"] == 2 and wd["cache"]["preloads"] == 2
        assert wd["cache"]["misses"] == 0
        assert lt["stats_saves"] == wd["stats_saves"] == 0


def test_live_group_engine_equals_the_oracle_every_epoch(ranks):
    _, recs, _ = ranks
    for rec in recs:
        live = rec["live"]
        eps = live["epochs"]
        assert len(eps) == 4
        for ep in eps:
            assert ep["counts"] == ep["oracle"]
        assert eps[2]["counts"] != eps[1]["counts"]      # churn moved them
        # the unchanged epoch is served from the memo; each churned
        # epoch invalidates both memos and recounts in full
        assert eps[1]["maint"]["memo_hits"] - eps[0]["maint"][
            "memo_hits"] == 2
        for a, b in zip(eps[1:], eps[2:]):
            assert b["maint"]["full_recounts"] - a["maint"][
                "full_recounts"] == 2
            assert b["maint"]["memo_invalidations"] - a["maint"][
                "memo_invalidations"] == 2
        assert live["rebinds"] == 4 and live["rebuilds"] == 0
        assert live["searches"] == 2
    assert recs[0]["live"]["epochs"] == recs[1]["live"]["epochs"]


def test_sharded_keys_and_bodies_equal_reference(ranks, tmp_path):
    """The reference's layout fingerprint over a mesh of two devices has
    the port's shape; a sharded record saved by each package's store
    has equal bodies (the reference's keys need no second device)."""
    pytest.importorskip("jax")
    from repro.core import executor as rx
    from repro.core.config_search import search_configuration
    from repro.core.plan import build_plan
    from repro.graph.datasets import named_dataset as r_named
    from repro.query import PlanStore as RPlanStore
    from repro.query.cache import PlanCache as RPlanCache
    from repro.query.cache import graph_fingerprint as rgfp
    from repro.query.cache import layout_fingerprint as r_layout
    from repro.query.canon import canonical_form as rcanon

    tmp, recs, _ = ranks
    mesh = type("Mesh", (), {"shape": {"data": WORLD},
                             "devices": np.array(["dev0", "dev1"])})
    rcfg = rx.ExecutorConfig(capacity=CAP)
    want = r_layout(mesh, "data", None, rcfg)
    got = tuple(recs[0]["layout"][:4])
    assert json.loads(json.dumps(want[:4])) == list(got)
    assert len(recs[0]["layout"]) == len(want) == 5
    assert recs[0]["layout"] == recs[1]["layout"]
    assert recs[0]["layout"][4] == ["cpu"] * WORLD

    g = r_named("tiny-er")
    stats = rx.compute_stats(g, rcfg)
    bodies = {}
    for p in sorted((tmp / "store" / "v2").glob("*.json")):
        if not p.name.startswith(("stats-", "live-")):
            body = json.loads(p.read_text())
            bodies[body["key"][0]] = body
    rs = RPlanStore(str(tmp_path / "ref"))
    for name in ("P1", "P2"):
        canon = rcanon(get_pattern_ref(name))
        config = search_configuration(canon, stats).best
        plan = build_plan(canon, config.order, config.res_set,
                          iep_k=config.iep_k)
        key = RPlanCache.entry_key(canon, rgfp(g, stats), rcfg,
                                   layout_fp=want)
        digest = rs.save(key, pattern=canon, config=config, plan=plan)
        ref = json.loads((tmp_path / "ref" / "v2" / f"{digest}.json")
                         .read_text())
        port = bodies[key[0]]
        for field in ("schema_version", "mode", "use_iep", "sharded",
                      "pattern", "config", "plan", "has_executable"):
            assert port[field] == ref[field], (name, field)
        assert port["key"][:2] == ref["key"][:2]
        assert port["key"][3:5] == ref["key"][3:5]
        assert port["key"][5][:4] == ref["key"][5][:4]


def get_pattern_ref(name):
    from repro.configs.graphpi import get_pattern as rpattern

    return rpattern(name)


def test_torchrun_mine_verifies_and_prints_once(ranks):
    rc, text, err = ranks[2]["mine"]
    assert rc == 0, text + err
    assert "still referenced" not in err     # the group was freed
    assert text.count("[mine] count=27358") == 1
    assert text.count("[mine] oracle=27358  OK") == 1
    assert text.count("[group] world=2 backend=gloo (ranks on the CPU)") == 1
    assert "[mine] rank 0:" in text and "[mine] rank 1:" in text
    assert text.count("[mine] balance: max/mean rank wall") == 1


def test_torchrun_query_serve_meets_its_hits(ranks):
    rc, text, err = ranks[2]["query_serve"]
    assert rc == 0, text + err
    assert "still referenced" not in err
    assert text.count("verify=OK") == 4
    assert text.count("[serve] cache: 2 hits / 2 misses") == 1
    assert "resident on 2 ranks" in text


def test_torchrun_query_serve_failure_exits_nonzero_on_every_rank(ranks):
    rc, text, err = ranks[2]["query_serve_fails"]
    assert rc != 0
    assert text.count("EXPECTED >= 99 cache hits") == 1


def test_torchrun_distributed_example(ranks):
    rc, text, err = ranks[2]["example"]
    assert rc == 0, text + err
    assert "still referenced" not in err
    assert "sharded       count = 87724" in text
    assert "oracle = 87724" in text
