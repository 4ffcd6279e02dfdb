"""Port parity, the ticket RPC front door: `repro_torch.serve.rpc` on the
CPU, against the reference's `repro.serve.rpc`.

Port of `tests/test_rpc.py`.  Frames are byte-equal to the reference's
encoder, so a client of either package talks to a server of either
package: a reference `RPCClient` against a port server and a port
client against a reference server give the counts of the in-process
engines.  Also admission rejection over the wire and live
mutate-then-replay.  Every server thread is joined with a timeout, and
no wait here is without one.
"""
import asyncio
import json
import struct
import threading

import pytest
import torch

pytest.importorskip("jax")

from repro.core import executor as rx                     # noqa: E402
from repro.graph.datasets import erdos_renyi               # noqa: E402
from repro.query import QueryEngine as RQueryEngine        # noqa: E402
from repro.serve import gateway as rgw                     # noqa: E402
from repro.serve import rpc as rrpc                        # noqa: E402

from repro_torch.configs.graphpi import get_pattern        # noqa: E402
from repro_torch.convert import graph_from_arrays          # noqa: E402
from repro_torch.core import executor as tx                # noqa: E402
from repro_torch.graph.csr import GraphCSR                 # noqa: E402
from repro_torch.query import QueryEngine                  # noqa: E402
from repro_torch.serve.gateway import (                    # noqa: E402
    Gateway, GraphQueryWorkload, Share,
)
from repro_torch.serve.rpc import (                        # noqa: E402
    MAX_FRAME, GatewayRPCServer, RPCClient, RPCError, encode_frame,
    read_frame, request_from_spec, result_to_wire,
)

torch.set_num_threads(1)

CAP = 1 << 12
CFG = tx.ExecutorConfig(capacity=CAP)
R_GRAPH = erdos_renyi(64, 256, seed=7, name="er64")
GRAPH = graph_from_arrays(R_GRAPH.indptr, R_GRAPH.indices, R_GRAPH.degrees,
                          name=R_GRAPH.name)
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def stats():
    return tx.compute_stats(GRAPH, CFG, device="cpu")


def _engine(stats=None, **kw):
    return QueryEngine(GRAPH, cfg=CFG, stats=stats, device="cpu", **kw)


# -------------------------------------------------------------- framing
MESSAGES = [
    {"op": "submit", "pattern": {"n": 3, "edges": [[0, 1], [1, 2]]},
     "tenant": "t0"},
    {"op": "result", "ticket": 7},
    {"op": "mutate", "verb": "insert_edges", "edges": [[0, 63], [1, 62]]},
    {"ok": True, "result": {"count": 12345678901, "line": "é ü", "order":
                            [0, 2, 1], "res_set": [[0, 1]], "x": 1.5,
                            "y": None}},
    {"ok": False, "error": "rejected", "rejection": {
        "tenant": "acme", "reason": "queue depth bound", "depth": 0,
        "limit": 0}},
    {},
]


def _read_bytes(data: bytes, reader_fn=read_frame):
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return await reader_fn(reader)
    return asyncio.run(go())


@pytest.mark.parametrize("msg", MESSAGES)
def test_frames_byte_equal_reference(msg):
    assert encode_frame(msg) == rrpc.encode_frame(msg)
    assert _read_bytes(encode_frame(msg)) == msg
    assert _read_bytes(rrpc.encode_frame(msg)) == msg
    assert _read_bytes(encode_frame(msg), rrpc.read_frame) == msg


def test_frame_eof_and_oversize():
    assert MAX_FRAME == rrpc.MAX_FRAME
    assert _read_bytes(b"") is None
    assert _read_bytes(b"\x00\x00") is None
    with pytest.raises(ValueError):
        _read_bytes(struct.pack(">I", MAX_FRAME + 1))
    with pytest.raises(ValueError):
        encode_frame({"pad": "x" * (MAX_FRAME + 16)})


def test_request_from_spec_matches_trace_format():
    req = request_from_spec({"pattern": "triangle", "tenant": "acme"})
    assert req.pattern == get_pattern("triangle")
    assert req.tenant == "acme"
    assert req.use_iep is False and req.mode == "graphpi"
    inline = request_from_spec(
        {"pattern": {"n": 3, "edges": [[2, 1], [0, 2], [1, 0]]}})
    assert inline.pattern.n == 3 and inline.pattern.name == "inline"
    assert inline.tenant == "default"
    ref = rrpc.request_from_spec({"pattern": "P2", "use_iep": True,
                                  "mode": "naive", "tenant": "x"})
    port = request_from_spec({"pattern": "P2", "use_iep": True,
                              "mode": "naive", "tenant": "x"})
    assert (port.pattern.edges, port.use_iep, port.mode, port.tenant) == (
        ref.pattern.edges, ref.use_iep, ref.mode, ref.tenant)


def test_result_to_wire_equals_reference(stats):
    from repro.query import QueryRequest as RQueryRequest
    from repro.configs.graphpi import get_pattern as rpattern

    port, ref = _engine(stats), RQueryEngine(R_GRAPH,
                                             cfg=rx.ExecutorConfig(capacity=CAP))
    t = port.enqueue(request_from_spec({"pattern": "P1", "verify": True}))
    port.run_pending()
    r = ref.enqueue(RQueryRequest(rpattern("P1"), verify=True))
    ref.run_pending()
    got, want = result_to_wire(t.result), rrpc.result_to_wire(r.result)
    times = {"latency_s", "search_seconds", "compile_seconds", "line"}
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in times} == \
        {k: v for k, v in want.items() if k not in times}
    assert json.loads(json.dumps(got)) == got


# ----------------------------------------------------------- socket path
TRACE = [
    {"pattern": "triangle"},
    {"pattern": "P1"},
    {"pattern": {"n": 3, "edges": [[2, 1], [0, 2], [1, 0]]}},
    {"pattern": "triangle"},          # duplicate: coalesces or hits
]


def _start(server_cls, gw, wl):
    """`server_cls(gw, wl)` on an ephemeral port, its event loop in a
    daemon thread; returns (server, thread, port)."""
    server = server_cls(gw, wl)
    ready = threading.Event()
    box = {}

    def on_ready(host, port):
        box["port"] = port
        ready.set()

    th = threading.Thread(target=server.serve_forever,
                          kwargs={"on_ready": on_ready}, daemon=True)
    th.start()
    assert ready.wait(timeout=TIMEOUT), "RPC server never came up"
    return server, th, box["port"]


def _port_server(engine, quantum=4):
    gw = Gateway()
    wl = gw.add(GraphQueryWorkload(engine), Share(quantum=quantum))
    return _start(GatewayRPCServer, gw, wl)


def _stop(client, th):
    try:
        client.shutdown()
    finally:
        client.close()
        th.join(timeout=TIMEOUT)
    assert not th.is_alive()


def _in_process(engine, trace):
    out = []
    for spec in trace:
        t = engine.enqueue(request_from_spec(spec))
        while not t.done:
            engine.run_pending()
        out.append(t.result.count)
    return out


@pytest.mark.parametrize("client_cls", [RPCClient, rrpc.RPCClient],
                         ids=["port-client", "reference-client"])
def test_port_server_counts_equal_in_process(stats, client_cls):
    """Counts over the socket, from either package's client, equal the
    in-process engine's for the same trace; the wire carries the
    reference's ops and shapes."""
    want = _in_process(_engine(stats), TRACE)
    engine = _engine(stats, chunk=8, preempt_dispatches=4)
    server, th, port = _port_server(engine)
    client = client_cls("127.0.0.1", port, timeout=TIMEOUT)
    try:
        tickets = [client.submit(spec) for spec in TRACE]
        results = [client.result(tk) for tk in tickets]
        assert [r["count"] for r in results] == want
        assert all("count=" in r["line"] for r in results)
        resp = client.stats()
        s = resp["stats"]
        assert s["requests_resolved"] == len(TRACE)
        assert s["cache"]["hits"] + s["coalesced"] >= 1
        assert s["cache"]["misses"] == 2
        assert resp["rounds"] >= 1
        assert client.poll(tickets[0]) == {"ok": True, "done": True,
                                           "cancelled": False}
        assert client.cancel(tickets[0]) is False
        assert client.poll(999).get("ok") is False
        with pytest.raises(Exception) as ei:
            client.result(999)
        assert type(ei.value).__name__ == "RPCError"
        assert client.call({"op": "bogus"})["ok"] is False
    finally:
        _stop(client, th)
    assert engine.preemptions >= 1


def test_port_client_against_reference_server(stats):
    """The reference's server over the reference's engine, the port's
    client: equal counts to the port's in-process engine."""
    want = _in_process(_engine(stats), TRACE)
    engine = RQueryEngine(R_GRAPH, cfg=rx.ExecutorConfig(capacity=CAP))
    gw = rgw.Gateway()
    wl = gw.add(rgw.GraphQueryWorkload(engine), rgw.Share(quantum=4))
    server, th, port = _start(rrpc.GatewayRPCServer, gw, wl)
    client = RPCClient("127.0.0.1", port, tenant="t1", timeout=TIMEOUT)
    try:
        tickets = [client.submit(spec) for spec in TRACE]
        assert [client.result(tk)["count"] for tk in tickets] == want
        assert client.stats()["stats"]["tenants"]["t1"]["resolved"] == 4
    finally:
        _stop(client, th)


def test_socket_admission_rejection(stats):
    engine = _engine(stats, tenant_depth=0)
    server, th, port = _port_server(engine)
    client = RPCClient("127.0.0.1", port, tenant="acme", timeout=TIMEOUT)
    try:
        with pytest.raises(RPCError) as ei:
            client.submit({"pattern": "triangle"})
        resp = ei.value.resp
        assert resp["error"] == "rejected"
        assert resp["rejection"] == {"tenant": "acme",
                                     "reason": "queue depth bound",
                                     "depth": 0, "limit": 0}
        assert engine.rejections == {"acme": 1}
        with pytest.raises(rrpc.RPCError):
            rc = rrpc.RPCClient("127.0.0.1", port, tenant="acme",
                                timeout=TIMEOUT)
            try:
                rc.submit({"pattern": "triangle"})
            finally:
                rc.close()
        assert engine.rejections == {"acme": 2}
    finally:
        _stop(client, th)


def test_socket_mutate_then_replay(stats):
    """Live serving over the wire: queries, insert/delete mutations, the
    same queries, a compaction, the same queries — each post-mutation
    count equals a fresh engine's on the rebuilt edge set; a mutate on a
    frozen engine is refused over the wire."""
    engine = _engine(live=True)
    ins = [e for e in ([0, 63], [1, 62], [2, 61])
           if not GRAPH.has_edge(*e)]
    dels = [[int(u), int(v)] for u, v in GRAPH.edge_array()[:2]]
    server, th, port = _port_server(engine)
    client = rrpc.RPCClient("127.0.0.1", port, timeout=TIMEOUT)
    names = ("triangle", "P1")
    try:
        before = [client.result(client.submit({"pattern": n}))["count"]
                  for n in names]
        ack = client.mutate("insert_edges", ins)
        assert ack["ok"] and ack["verb"] == "insert_edges"
        assert ack["queued_edges"] == len(ins) and ack["edge_epoch"] == 0
        client.mutate("delete_edges", dels)
        after = [client.result(client.submit({"pattern": n}))["count"]
                 for n in names]
        client.mutate("compact")
        compacted = [client.result(client.submit({"pattern": n}))["count"]
                     for n in names]
        live = client.stats()["stats"]["live"]
    finally:
        _stop(client, th)
    edges = set(map(tuple, GRAPH.edge_array().tolist()))
    edges |= {tuple(e) for e in ins}
    edges -= {tuple(e) for e in dels}
    import numpy as np
    rebuilt = GraphCSR.from_edges(GRAPH.n, np.asarray(sorted(edges)),
                                  name="rebuilt")
    ref = QueryEngine(rebuilt, cfg=CFG, device="cpu")
    want = _in_process(ref, [{"pattern": n} for n in names])
    assert after == want and compacted == want and after != before
    assert live["mutations_applied"] >= len(ins)
    assert live["matcher_rebuilds"] == 0 and live["matcher_rebinds"] >= 2

    frozen = _engine(stats)
    server, th, port = _port_server(frozen)
    client = RPCClient("127.0.0.1", port, timeout=TIMEOUT)
    try:
        with pytest.raises(RPCError, match="not live"):
            client.mutate("insert_edges", [[0, 1]])
    finally:
        _stop(client, th)


def test_rpc_cli_replays_a_trace_with_a_mutate_line(tmp_path, stats,
                                                    capsys):
    """`python -m repro_torch.serve.rpc --connect`: results print in
    submission order, a mutate line drains first, `--shutdown` stops the
    server."""
    from repro_torch.serve import rpc

    absent = next([0, v] for v in range(1, GRAPH.n)
                  if not GRAPH.has_edge(0, v))
    trace = tmp_path / "trace.jsonl"
    trace.write_text("\n".join(json.dumps(x) for x in (
        {"pattern": "triangle"}, {"pattern": "P1"},
        {"mutate": "insert_edges", "edges": [absent]},
        {"pattern": "triangle"})) + "\n# a comment\n")
    engine = _engine(stats, live=True)
    server, th, port = _port_server(engine)
    try:
        rc = rpc.main(["--connect", f"127.0.0.1:{port}", "--requests",
                       str(trace), "--tenant", "cli", "--shutdown",
                       "--timeout", str(TIMEOUT)])
    finally:
        th.join(timeout=TIMEOUT)
    assert rc == 0 and not th.is_alive()
    lines = capsys.readouterr().out.splitlines()
    counts = [int(x.split("count=")[1].split()[0]) for x in lines
              if " count=" in x]
    assert len(counts) == 3
    assert any("mutate insert_edges queued_edges=1 edge_epoch=0" in x
               for x in lines)
    assert counts[0] == stats.tri_cnt and counts[2] >= counts[0]
