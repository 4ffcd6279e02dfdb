"""The gateway's sharded graph tenant at W = 2 on gloo (`serve/spmd.py`,
`launch/gateway.py` under torchrun).

Two spawned ranks serve the graph cases of `tests/test_gateway.py`:
rank 0 runs the Gateway over a `LeaderEngine`, rank 1 a `Follower`
over its own `QueryEngine(group=)`.  Counts, cache flags, coalescing
and `max_needed` equal on both ranks, equal the single-device port's
gateway and the reference's `Gateway`, with a cancel replayed on the
follower.  Then both ranks run `launch.gateway --listen --live` (the
launcher's own sharded path): the port's and the reference's RPC
clients talk to rank 0's server, pipelined submits coalesce, a
mutation swaps the epoch at the same round on both ranks, and the
follower stops on shutdown.  One `torchrun` of `launch.gateway
--no-lm` exits 0 with rank 0 alone printing.

The spawned ranks import this file by name, so the JAX reference is
imported inside the tests that need it.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch
from torch_ranks import join_ranks, start_ranks

from repro_torch.configs.graphpi import get_pattern
from repro_torch.core import executor as tx
from repro_torch.graph.datasets import erdos_renyi, named_dataset
from repro_torch.query import QueryEngine, QueryRequest, relabeled_variant
from repro_torch.serve.gateway import Gateway, GraphQueryWorkload, Share

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
CAP = 1 << 12
QUANTUM = 3
CANCEL = 6                        # the MIX index rank 0 cancels
TIMEOUT = 240

# (pattern name, relabel seed or None, request options): the graph
# cases of tests/test_gateway.py, as tests/test_torch_gateway_graph.py
MIX = [("triangle", None, {}), ("P1", None, {}), ("P1", 3, {}),
       ("triangle", 5, {}), ("P2", None, dict(use_iep=True)),
       ("P4", None, dict(mode="naive")), ("P1", 9, {}),
       ("rectangle", None, dict(use_iep=True, tenant="b")),
       ("rectangle", 2, dict(use_iep=True, tenant="b"))]

# served over the socket by the launcher: one pipelined batch (the
# relabeled P1 coalesces with P1), then the live epochs
_P1_ISO = relabeled_variant(get_pattern("P1"), seed=3)
BATCH = [{"pattern": "triangle", "verify": True},
         {"pattern": "P1", "verify": True},
         {"pattern": {"n": _P1_ISO.n,
                      "edges": [list(e) for e in _P1_ISO.edges]},
          "verify": True},
         {"pattern": "rectangle", "use_iep": True, "verify": True}]
INSERT = [[0, 255], [1, 254], [2, 253]]


def _graph():
    return erdos_renyi(64, 256, seed=7, name="er64")


def _requests(pattern, relabel, request):
    out = []
    for name, seed, kw in MIX:
        p = pattern(name)
        if seed is not None:
            p = relabel(p, seed=seed)
        out.append(request(p, **kw))
    return out


def _rows(results):
    return [[r.pattern_name, int(r.count), bool(r.cache_hit),
             bool(r.coalesced), r.canon_key, r.mode, bool(r.use_iep),
             int(r.max_needed)] for r in results]


def _drained(rank, group, dev):
    """The MIX through the sharded gateway (rank 0) or its follower."""
    from repro_torch.serve.spmd import Follower, LeaderEngine

    cfg = tx.ExecutorConfig(capacity=CAP)
    if rank == 0:
        engine = LeaderEngine(_graph(), group=group, cfg=cfg, device=dev)
        gw = Gateway()
        wl = gw.add(GraphQueryWorkload(engine, _requests(
            get_pattern, relabeled_variant, QueryRequest)),
            Share(quantum=QUANTUM))
        assert engine.cancel(wl.tickets[CANCEL])
        gw.run()
        engine.stop()
        results, rounds = wl.results(), gw.report()["rounds"]
        extra = {"broadcasts": engine.broadcasts}
    else:
        engine = QueryEngine(_graph(), group=group, cfg=cfg, device=dev)
        follower = Follower(engine).run()
        results, rounds = follower.results(), follower.rounds
        extra = {"cancelled": [t.seq for t in follower.tickets
                               if t.cancelled]}
    return {"rows": _rows(results), "rounds": rounds,
            "coalesced": engine.coalesced, "executions": engine.executions,
            "hits": engine.cache.stats.hits, **extra}


def _gateway_rank(rank, world, rdv, out_dir):
    from repro_torch.launch import gateway, mesh

    torch.set_num_threads(1)
    group, dev = mesh.shared_group(
        "cpu", rank=rank, world_size=world, local_rank=rank,
        local_world=world, init_method=f"file://{rdv}", timeout=120.0,
        log=None)
    out = {"drained": _drained(rank, group, dev)}

    # the launcher's own sharded path: it finds this group
    os.environ["WORLD_SIZE"] = str(world)
    lines = []
    run = gateway.run(gateway.parse_args([
        "--device", "cpu", "--no-lm", "--dataset", "tiny-er", "--live",
        "--capacity", str(1 << 13), "--graph-quantum", "8", "--listen",
        "0", "--port-file", os.path.join(out_dir, "port")]),
        log=lines.append)
    s = run.engine.summary()
    out["listen"] = {
        "rc": run.rc, "lines": lines, "live": s["live"],
        "coalesced": s["coalesced"], "executions": s["executions"],
        "rows": _rows(run.results),
        "follower": None if run.follower is None else
        [run.follower.rounds, run.follower.heartbeats]}
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(out, f)
    del run, group
    mesh.close_group()


def _wait_port(path):
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(path):
        assert time.monotonic() < deadline, "rank 0 never listened"
        time.sleep(0.1)
    host, port = pathlib.Path(path).read_text().split()
    return host, int(port)


def _clients(host, port):
    """The port's client pipelines a batch; the reference's client (or
    the port's again without JAX) drives the live epochs and the
    shutdown."""
    from repro_torch.serve.rpc import RPCClient

    out = {}
    client = RPCClient(host, port, timeout=TIMEOUT)
    try:
        tickets = client.submit_many(BATCH)
        out["batch"] = [client.result(t) for t in tickets]
    finally:
        client.close()
    try:
        from repro.serve.rpc import RPCClient as RefClient
        out["ref_client"] = True
    except ImportError:
        RefClient, out["ref_client"] = RPCClient, False
    client = RefClient(host, port, timeout=TIMEOUT)
    try:
        epochs = []
        for verb, edges in ((None, None), ("insert_edges", INSERT),
                            ("delete_edges", INSERT[:1]),
                            ("compact", None)):
            if verb is not None:
                client.mutate(verb, edges)
            epochs.append([client.result(client.submit(
                {"pattern": n, "verify": True}))
                for n in ("triangle", "P1")])
        out["epochs"] = epochs
        out["stats"] = client.stats()["stats"]
        client.shutdown()
    finally:
        client.close()
    return out


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


GATEWAY_ARGV = ["-m", "repro_torch.launch.gateway", "--device", "cpu",
                "--no-lm", "--workload", "smoke", "--verify",
                "--capacity", str(1 << 13), "--expect-coalesced", "2"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' records, the clients' view and the torchrun launch's
    (exit code, stdout, stderr)."""
    tmp = tmp_path_factory.mktemp("gateway-sharded")
    proc = _torchrun(GATEWAY_ARGV)
    try:
        handle = start_ranks(_gateway_rank, WORLD, tmp, str(tmp),
                             timeout=TIMEOUT)
        try:
            clients = _clients(*_wait_port(str(tmp / "port")))
        finally:
            join_ranks(handle)
        out, err = proc.communicate(timeout=TIMEOUT)
        launch = (proc.returncode, out, err)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    recs = [json.loads((tmp / f"r{r}.json").read_text())
            for r in range(WORLD)]
    return recs, clients, launch


def _single_device_rows():
    engine = QueryEngine(_graph(), cfg=tx.ExecutorConfig(capacity=CAP),
                         device="cpu")
    gw = Gateway()
    wl = gw.add(GraphQueryWorkload(engine, _requests(
        get_pattern, relabeled_variant, QueryRequest)),
        Share(quantum=QUANTUM))
    assert engine.cancel(wl.tickets[CANCEL])
    gw.run()
    return _rows(wl.results()), engine, gw


def test_sharded_gateway_equals_single_device_on_every_rank(served):
    recs, _, _ = served
    want, engine, gw = _single_device_rows()
    r0, r1 = recs[0]["drained"], recs[1]["drained"]
    assert r0["rows"] == r1["rows"]
    # counts, cache flags, coalescing and classes equal the single-device
    # gateway's; the sharded frontier is each rank's stripe's
    assert [r[:7] for r in r0["rows"]] == [r[:7] for r in want]
    assert len(want) == len(MIX) - 1
    for rec in (r0, r1):
        assert rec["coalesced"] == engine.coalesced
        assert rec["executions"] == engine.executions
        assert rec["hits"] == engine.cache.stats.hits
    assert r0["rounds"] == r1["rounds"] == gw.report()["rounds"]
    # one broadcast per round, then the stop record
    assert r0["broadcasts"] == r0["rounds"] + 1
    assert r1["cancelled"] == [CANCEL]


def test_sharded_max_needed_equals_the_single_device_stripes(served):
    """`max_needed` of a sharded count is the largest over the ranks'
    stripes (MAX per pass) — the same on both ranks and never above
    the single-device count's."""
    recs, _, _ = served
    want, _, _ = _single_device_rows()
    got = [r[7] for r in recs[0]["drained"]["rows"]]
    assert got == [r[7] for r in recs[1]["drained"]["rows"]]
    assert all(0 < g <= w[7] for g, w in zip(got, want))


def test_sharded_gateway_equals_the_reference_gateway(served):
    pytest.importorskip("jax")
    from repro.configs.graphpi import get_pattern as rpattern
    from repro.core import executor as rx
    from repro.graph.datasets import erdos_renyi as r_er
    from repro.query import QueryEngine as RQueryEngine
    from repro.query import QueryRequest as RQueryRequest
    from repro.query import relabeled_variant as r_relabel
    from repro.serve import gateway as rgw

    recs, _, _ = served
    ref = RQueryEngine(r_er(64, 256, seed=7, name="er64"),
                       cfg=rx.ExecutorConfig(capacity=CAP))
    rg = rgw.Gateway()
    rwl = rg.add(rgw.GraphQueryWorkload(ref, _requests(
        rpattern, r_relabel, RQueryRequest)), rgw.Share(quantum=QUANTUM))
    assert ref.cancel(rwl.tickets[CANCEL])
    rg.run()
    want = [[r.pattern_name, int(r.count), bool(r.cache_hit),
             bool(r.coalesced), r.canon_key, r.mode, bool(r.use_iep)]
            for r in rwl.results()]
    assert [r[:7] for r in recs[0]["drained"]["rows"]] == want
    assert recs[0]["drained"]["coalesced"] == ref.coalesced
    assert recs[0]["drained"]["rounds"] == rg.report()["rounds"]


def test_rpc_batch_coalesces_and_verifies(served):
    from repro_torch.serve.rpc import request_from_spec

    _, clients, _ = served
    batch = clients["batch"]
    eng = QueryEngine(named_dataset("tiny-er"),
                      cfg=tx.ExecutorConfig(capacity=1 << 13), device="cpu")
    ts = [eng.enqueue(request_from_spec(spec)) for spec in BATCH]
    eng.run_pending()
    assert [r["count"] for r in batch] == [t.result.count for t in ts]
    assert batch[1]["count"] == 27_358
    assert all(r["verified"] is True for r in batch)
    # the pipelined relabeled P1 rode P1's execution
    assert [r["coalesced"] for r in batch] == [False, False, True, False]


def test_rpc_live_epochs_equal_the_single_device_port(served):
    from repro_torch.graph.csr import GraphCSR
    import numpy as np

    recs, clients, _ = served
    epochs = clients["epochs"]
    g = named_dataset("tiny-er")
    edges = set(map(tuple, g.edge_array().tolist()))

    def counts(es):
        rebuilt = GraphCSR.from_edges(g.n, np.asarray(sorted(es)),
                                      name="rebuilt")
        eng = QueryEngine(rebuilt, cfg=tx.ExecutorConfig(capacity=1 << 13),
                          device="cpu")
        ts = [eng.enqueue(QueryRequest(get_pattern(n)))
              for n in ("triangle", "P1")]
        eng.run_pending()
        return [t.result.count for t in ts]

    inserted = edges | {tuple(e) for e in INSERT}
    deleted = inserted - {tuple(INSERT[0])}
    want = [counts(edges), counts(inserted), counts(deleted),
            counts(deleted)]
    assert [[r["count"] for r in ep] for ep in epochs] == want
    assert all(r["verified"] is True for ep in epochs for r in ep)
    live0, live1 = recs[0]["listen"]["live"], recs[1]["listen"]["live"]
    # the epoch swapped at the same round boundaries on both ranks
    assert live0 == live1
    assert live0["edge_epoch"] >= 2 and live0["compactions"] >= 1
    assert live0["matcher_rebuilds"] == 0 and live0["matcher_rebinds"] >= 3


def test_rpc_follower_stops_on_shutdown_and_ranks_agree(served):
    recs, clients, _ = served
    r0, r1 = recs[0]["listen"], recs[1]["listen"]
    assert r0["rc"] == r1["rc"] == 0
    assert r0["follower"] is None
    rounds, heartbeats = r1["follower"]
    assert rounds >= 5 and heartbeats >= 0
    assert r0["rows"] == r1["rows"] and len(r0["rows"]) == 12
    assert r0["coalesced"] == r1["coalesced"] == 1
    assert clients["stats"]["devices"] == WORLD
    text = "\n".join(r0["lines"])
    assert "[gateway] rank 0:" in text and "[gateway] rank 1:" in text
    assert "resident on 2 ranks" in text
    assert not r1["lines"]                      # rank 0 alone prints


def test_torchrun_gateway_exits_zero_and_prints_once(served):
    _, _, (rc, text, err) = served
    assert rc == 0, text + err
    assert "still referenced" not in err
    assert text.count("[group] world=2 backend=gloo") == 1
    assert text.count("verify=OK") == 4
    assert text.count("COAL") == 2
    assert text.count("[gateway] graph: 4 requests, 2 executions, "
                      "2 coalesced") == 1
    assert text.count("[gateway] rank 0:") == 1
    assert text.count("[gateway] rank 1:") == 1
    assert text.count("[gateway] balance:") == 1
