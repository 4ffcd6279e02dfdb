"""Port parity, executor side: `repro_torch.core.executor` on the CPU —
the portable path and the kernel path (which runs K1's plain version on
CPU tensors) — gives the reference executor's `count` and `max_needed`
and the brute-force oracle's count, on the reference tests' own small
graphs: P1–P6 in enum and IEP, degree buckets, a labeled plan, forced
overflow (bisection, then capacity escalation) and a preempted count
resumed to completion.  Also the `mine` CLI on the CPU.

Graphs and plans go to the port through `repro_torch.convert`, so both
packages count the very same arrays.  No tolerance: counts are exact.
"""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.configs.graphpi import EXTRA_PATTERNS, PATTERNS
from repro.core import executor as rx
from repro.core.oracle import count_embeddings_oracle
from repro.core.pattern import clique, rectangle, star
from repro.core.plan import best_iep_k, build_plan, plan_to_dict
from repro.core.restrictions import generate_restriction_sets
from repro.core.schedule import generate_schedules
from repro.graph.datasets import erdos_renyi, named_dataset, rmat

from repro_torch.convert import graph_from_arrays, plan_from_reference
from repro_torch.core import executor as tx
from repro_torch.obs import Tracer, get_tracer, set_tracer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUCKETS = ((8, 1.0), (10**9, 0.5))
PATHS = ["portable", "kernel"]

# The reference tests' fixtures: tests/test_level_expand.py:134-141 and
# tests/test_executor.py:35,40.
GRAPHS = {
    "er48": lambda: erdos_renyi(48, 220, seed=5),
    "rmat7": lambda: rmat(7, 5, seed=9, name="rmat7"),
    "er64": lambda: erdos_renyi(64, 420, seed=3),
    "rmat8": lambda: rmat(8, 6, seed=11),
    "tiny-labeled": lambda: named_dataset("tiny-labeled"),
}
_graphs, _ref_counts, _oracle = {}, {}, {}


def _graph(name):
    if name not in _graphs:
        g = GRAPHS[name]()
        _graphs[name] = (g, graph_from_arrays(
            g.indptr, g.indices, g.degrees, g.labels, name=g.name))
    return _graphs[name]


def _plan(pattern, iep):
    order = generate_schedules(pattern)[0]
    rs = generate_restriction_sets(pattern, max_sets=1)[0]
    k = best_iep_k(pattern, order, rs) if iep else 0
    if iep and k < 1:
        return None
    return build_plan(pattern, order, rs, iep_k=k)


def _reference(gname, plan, capacity, buckets):
    """The reference executor's (count, max_needed, overflowed), cached
    so both port paths compare against one reference run."""
    key = (gname, repr(plan_to_dict(plan)), capacity, buckets)
    if key not in _ref_counts:
        g, _ = _graph(gname)
        r = rx.count_embeddings(g, plan, rx.ExecutorConfig(
            capacity=capacity, use_pallas=False, degree_buckets=buckets))
        _ref_counts[key] = (r.count, r.max_needed, r.overflowed)
    return _ref_counts[key]


def _oracle_count(gname, pattern):
    key = (gname, repr(pattern.to_dict()))
    if key not in _oracle:
        g, _ = _graph(gname)
        _oracle[key] = count_embeddings_oracle(g.n, g.edge_array(), pattern,
                                               labels=g.labels)
    return _oracle[key]


def _port(gname, plan, path, capacity, buckets, **kw):
    _, tg = _graph(gname)
    cfg = tx.ExecutorConfig(capacity=capacity, degree_buckets=buckets,
                            use_kernel=path == "kernel")
    return tx.Matcher(tg, plan_from_reference(plan_to_dict(plan)), cfg,
                      device="cpu", **kw)


def _check(gname, plan, path, *, capacity=1 << 10, buckets=None):
    want = _reference(gname, plan, capacity, buckets)
    got = _port(gname, plan, path, capacity, buckets).count()
    assert (got.count, got.max_needed, got.overflowed) == want
    assert got.count == _oracle_count(gname, plan.pattern)
    return got


# P1–P6 enum, and IEP wherever the first configuration folds a tail
CASES = [(p, iep) for p in sorted(PATTERNS) for iep in (False, True)
         if _plan(PATTERNS[p], iep) is not None]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("pname,iep", CASES,
                         ids=[f"{p}-{'iep' if i else 'enum'}"
                              for p, i in CASES])
def test_counts_match_reference_er48(pname, iep, path):
    _check("er48", _plan(PATTERNS[pname], iep), path)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("gname,pname", [("er64", "P1"), ("er64", "P4"),
                                         ("rmat8", "triangle")])
def test_counts_match_reference_test_executor_graphs(gname, pname, path):
    _check(gname, _plan(PATTERNS.get(pname) or EXTRA_PATTERNS[pname], False),
           path)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("pattern,iep", [
    (clique(4), False), (rectangle(), False), (star(4), True)],
    ids=["clique4", "rectangle", "star4-iep"])
def test_bucketed_counts_match_reference_rmat7(pattern, iep, path):
    _check("rmat7", _plan(pattern, iep), path, buckets=BUCKETS)


@pytest.mark.parametrize("path", PATHS)
def test_labeled_plan_matches_reference(path):
    """House with labels on the rectangle: windows gather from per-label
    CSR segments on both packages."""
    pattern = PATTERNS["P1"].with_labels((0, 1, 0, 1, None))
    _check("tiny-labeled", _plan(pattern, False), path)


@pytest.mark.parametrize("path", PATHS)
def test_forced_overflow_bisects_then_escalates(path):
    """Capacity 128 on er48: the chunk loop bisects overflowing spans and
    escalates single roots; count, max_needed and the overflow flag stay
    equal to the reference's."""
    plan = _plan(PATTERNS["P1"], False)
    got = _check("er48", plan, path, capacity=128)
    assert got.max_needed > 128 and not got.overflowed
    m = _port("er48", plan, path, 128, None)
    m.count()
    assert m._capacity > 128              # a single root escalated


@pytest.mark.parametrize("path", PATHS)
def test_preempted_count_resumes_to_the_same_result(path):
    plan = _plan(PATTERNS["P1"], False)
    whole = _port("er48", plan, path, 128, None).count()
    m = _port("er48", plan, path, 128, None)
    state, out = m.count_partial(max_dispatches=1)
    assert out is None and state.dispatches == 1
    steps = 1
    while out is None:
        state, out = m.count_partial(state, max_dispatches=1)
        steps += 1
    assert steps == state.dispatches > 1
    assert (out.count, out.max_needed, out.overflowed) == (
        whole.count, whole.max_needed, whole.overflowed)
    assert out.count == _oracle_count("er48", plan.pattern)


def test_compute_stats_matches_reference():
    g = named_dataset("tiny-er")
    tg = graph_from_arrays(g.indptr, g.indices, g.degrees, name=g.name)
    cfg = tx.ExecutorConfig(capacity=1 << 10)
    st = tx.compute_stats(tg, cfg, device="cpu")
    want = rx.compute_stats(g, rx.ExecutorConfig(capacity=1 << 10))
    assert (st.n_vertices, st.n_edges, st.tri_cnt) == (
        want.n_vertices, want.n_edges, want.tri_cnt) == (256, 1991, 643)


def test_auto_buckets_match_reference():
    for name in ("small-rmat", "tiny-er"):
        g = named_dataset(name)
        assert tx.auto_buckets(g) == rx.auto_buckets(g)


def test_config_fingerprint_names_the_kernel_facet():
    cfg = tx.ExecutorConfig(capacity=64, degree_buckets=BUCKETS)
    assert cfg.fingerprint() == (
        "cap=64,dyn=1,kernel=1,buckets=8:1;1000000000:0.5")
    assert "kernel=0" in tx.ExecutorConfig(use_kernel=False).fingerprint()


def test_trace_sync_emits_level_spans():
    plan = _plan(PATTERNS["P1"], False)
    old = get_tracer()
    tr = set_tracer(Tracer(enabled=True, sync=True))
    try:
        got = _port("er48", plan, "kernel", 1 << 10, None).count()
    finally:
        set_tracer(old)
    assert got.count == _oracle_count("er48", plan.pattern)
    names = [s["name"] for s in tr.spans()]
    dispatches = names.count("executor.dispatch")
    assert names.count("executor.level") == (plan.depth - 1) * dispatches
    assert "executor.dispatch" in names and "executor.count" in names


def test_release_and_rebind():
    plan = _plan(PATTERNS["P1"], False)
    m = _port("er48", plan, "portable", 1 << 10, None)
    _, tg = _graph("er48")
    m.rebind(tx.device_graph(tg, "cpu"), graph=tg)
    assert m.count().count == _oracle_count("er48", plan.pattern)
    _, other = _graph("er64")
    with pytest.raises(ValueError):
        m.rebind(tx.device_graph(other, "cpu"))
    m.release()
    with pytest.raises(RuntimeError):
        m.count()


def test_entry_points_refuse_cuda_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = _graph("er48")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx.Matcher(tg, plan_from_reference(plan_to_dict(
            _plan(PATTERNS["P1"], False))))
    from repro_torch.launch import mine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        mine.main(["--pattern", "triangle"])


@pytest.mark.parametrize("mode", ["graphpi", "graphzero", "naive"])
def test_mine_modes_match_oracle(mode, capsys):
    from repro_torch.launch import mine

    assert mine.main(["--pattern", "P4", "--mode", mode, "--use-iep",
                      "--verify", "--device", "cpu",
                      "--capacity", "1024"]) == 0
    out = capsys.readouterr().out
    assert "[mine] count=4225" in out and "oracle=4225  OK" in out


def test_mine_cli_verifies_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--device", "cpu",
         "--verify"], env=env, capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[mine] oracle=27358  OK" in out.stdout


def test_mine_trace_and_metrics_flags(tmp_path, capsys):
    import json

    from repro_torch.launch import mine

    old = get_tracer()
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    try:
        assert mine.main(["--pattern", "triangle", "--device", "cpu",
                          "--capacity", "1024", "--trace", str(trace),
                          "--trace-sync", "--metrics", str(metrics)]) == 0
    finally:
        set_tracer(old)
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"executor.count", "executor.dispatch", "executor.level",
            "cache.search"} <= names
    snap = json.loads(metrics.read_text())
    assert snap["executor.dispatches"] >= 1
    # CPU tensors take K1's plain version, which launches nothing
    assert [snap[f"kernel.level_expand.launches{{mode={m}}}"]
            for m in ("mask", "count", "signed")] == [0, 0, 0]
    assert "[mine] count=643" in capsys.readouterr().out
