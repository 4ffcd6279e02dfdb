"""The port's serving launchers on the CPU (`--device cpu`):
`repro_torch.launch.query_serve`, `launch.plan_warmup` and
`launch.gateway`, as the reference's `tests/test_launchers.py` drives
its own.  Counts are checked against the reference oracle through the
launchers' `--verify`, and the gateway's against query_serve's on the
same request file (only the scheduling differs)."""
import json
import re
import threading

import torch

from repro_torch.launch import gateway, plan_warmup, query_serve

torch.set_num_threads(1)


def _counts(text):
    return [int(m) for m in re.findall(r" count=(\d+)", text)]


def test_query_serve_mixed_verified(capsys):
    rc = query_serve.main(["--device", "cpu", "--dataset", "tiny-er",
                           "--workload", "mixed", "--verify",
                           "--expect-min-hits", "3", "--capacity", "8192"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("verify=OK") == 6
    assert "3 hits / 3 misses" in out


def test_plan_warmup_then_warm_restart_searches_nothing(tmp_path, capsys):
    store = str(tmp_path / "plans")
    argv = ["--cache-dir", store, "--dataset", "tiny-er", "--patterns",
            "P1,P2,P4", "--modes", "graphpi", "--no-iep", "--capacity",
            "8192", "--device", "cpu"]
    assert plan_warmup.main(argv) == 0
    first = capsys.readouterr().out
    assert "3 searches" in first and "store now has 3 entries" in first
    assert plan_warmup.main(argv) == 0          # idempotent: load-through
    again = capsys.readouterr().out
    assert "0 searches" in again and "3 already persisted" in again
    assert _counts(again) == _counts(first)
    rc = query_serve.main(["--device", "cpu", "--dataset", "tiny-er",
                           "--workload", "mixed", "--capacity", "8192",
                           "--cache-dir", store, "--warm-from-disk",
                           "--expect-min-hits", "6"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "warm-from-disk: 3 plan(s) preloaded" in out
    assert "0 config searches" in out
    assert "6 hits / 0 misses" in out
    assert _counts(out) == [27358, 27358, 87724, 87724, 4225, 4225]


def test_warm_from_disk_needs_a_cache_dir(capsys):
    assert query_serve.main(["--device", "cpu", "--warm-from-disk"]) == 2
    assert gateway.main(["--device", "cpu", "--no-lm",
                         "--warm-from-disk"]) == 2


def test_gateway_graph_only_matches_query_serve(tmp_path, capsys):
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps(x) for x in (
        {"pattern": "P1"}, {"pattern": "triangle", "verify": True},
        {"pattern": {"n": 3, "edges": [[0, 1], [1, 2], [0, 2]]}},
        {"pattern": "P4", "mode": "naive"})) + "\n")
    common = ["--device", "cpu", "--dataset", "tiny-er", "--requests",
              str(reqs), "--capacity", "8192"]
    assert query_serve.main(common) == 0
    want = _counts(capsys.readouterr().out)
    run = gateway.run(gateway.parse_args(
        common + ["--no-lm", "--graph-quantum", "4", "--expect-coalesced",
                  "1", "--model-buckets"]), log=print)
    out = capsys.readouterr().out
    assert run.rc == 0, out
    assert _counts(out) == want == [r.count for r in run.results]
    assert run.session is None and run.engine.coalesced == 1
    assert want[1] == want[2] == 643


def test_gateway_graph_and_lm_tokens_equal_serve(capsys):
    from repro_torch.launch import serve

    run = gateway.run(gateway.parse_args([
        "--device", "cpu", "--dataset", "tiny-er", "--workload", "smoke",
        "--arch", "qwen3-1.7b", "--batch", "2", "--prompt-len", "16",
        "--gen", "4", "--capacity", "8192"]), log=print)
    out = capsys.readouterr().out
    assert run.rc == 0, out
    assert "lm per-item turn p50" in out and "4/4 steps" in out
    assert _counts(out) == [27358, 27358, 87724, 87724]
    rep = run.gateway.report()
    assert set(rep["workloads"]) == {"graph", "lm"}
    mixed = run.session.tokens_out()

    from repro_torch.serve.session import LMSession
    seen = []
    real = LMSession.tokens_out

    def spy(self):
        seen.append(self)
        return real(self)

    LMSession.tokens_out = spy
    try:
        assert serve.main(["--arch", "qwen3-1.7b", "--smoke", "--batch", "2",
                           "--prompt-len", "16", "--gen", "4",
                           "--device", "cpu"]) == 0
    finally:
        LMSession.tokens_out = real
    assert (seen[0].tokens_out() == mixed).all()


def test_gateway_listens_and_shuts_down(tmp_path):
    from repro_torch.serve.rpc import RPCClient

    port_file = tmp_path / "port"
    box = {}

    def serve():
        box["run"] = gateway.run(gateway.parse_args([
            "--device", "cpu", "--dataset", "tiny-er", "--no-lm", "--live",
            "--listen", "0", "--port-file", str(port_file)]),
            log=lambda line: None)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    for _ in range(600):
        if port_file.exists() or not th.is_alive():
            break
        th.join(timeout=0.1)
    host, port = port_file.read_text().split()
    client = RPCClient(host, int(port), timeout=120.0)
    try:
        res = client.result(client.submit({"pattern": "triangle"}))
        assert res["count"] == 643
        assert client.mutate("compact")["ok"]
        # the next round applies the compaction before it counts
        assert client.result(client.submit({"pattern": "triangle"}))[
            "count"] == 643
    finally:
        client.shutdown()
        client.close()
        th.join(timeout=120)
    assert not th.is_alive()
    run = box["run"]
    assert run.rc == 0 and run.server.connections == 1
    assert run.engine.summary()["live"]["compactions"] == 1
