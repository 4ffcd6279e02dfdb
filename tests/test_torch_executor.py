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


@pytest.mark.parametrize("sync", [True, False])
def test_trace_sync_emits_level_spans(sync):
    """Levels always have spans; only `--trace-sync` fences them and
    notes each level's `needed` and surviving `frontier`."""
    plan = _plan(PATTERNS["P1"], False)
    old = get_tracer()
    tr = set_tracer(Tracer(enabled=True, sync=sync))
    try:
        got = _port("er48", plan, "kernel", 1 << 10, None).count()
    finally:
        set_tracer(old)
    assert got.count == _oracle_count("er48", plan.pattern)
    names = [s["name"] for s in tr.spans()]
    dispatches = names.count("executor.dispatch")
    assert names.count("executor.level") == (plan.depth - 1) * dispatches
    assert "executor.dispatch" in names and "executor.count" in names
    levels = [s["attrs"] for s in tr.spans() if s["name"] == "executor.level"]
    if sync:
        assert all("needed" in a for a in levels)
        assert sum("frontier" in a for a in levels) == (
            plan.depth - 2) * dispatches
    else:
        assert not any({"needed", "frontier"} & set(a) for a in levels)


def _dispatch_of(spans):
    """{span id: id of the `executor.dispatch` span it lies in, or None}
    by the records' parent links."""
    by_id = {s["id"]: s for s in spans}

    def up(s):
        while s is not None and s["name"] != "executor.dispatch":
            s = by_id.get(s["parent"])
        return None if s is None else s["id"]

    return {s["id"]: up(by_id.get(s["parent"])) for s in spans}


K1_ENTRIES = ("level_expand_rows", "level_expand_compact")


@pytest.mark.parametrize("path", PATHS)
def test_dispatch_spans_say_what_each_dispatch_came_to(path, monkeypatch):
    """A P1 count at capacity 128 over two buckets, which splits and
    escalates: every dispatch notes its outcome, the count its discarded
    dispatches; each bucket's row count is one `device.sync` a level and
    dispatch; K1's spans lie in dispatches and name each call's rows,
    and each is open around its entry (so that a profiler range opened
    inside the entry is the innermost around K1's launches)."""
    import collections

    plan = _plan(PATTERNS["P1"], False)
    calls, around = [], []
    for name in K1_ENTRIES:
        real = getattr(tx.ops, name)

        def entry(*a, _real=real, _name=name, **kw):
            calls.append(a[1].shape[0])           # cstart: [B]
            around.append(get_tracer()._stack()[-1].name == "kernel." + _name)
            return _real(*a, **kw)

        monkeypatch.setattr(tx.ops, name, entry)
    old = get_tracer()
    tr = set_tracer(Tracer(enabled=True))
    try:
        got = _port("er48", plan, path, 128, BUCKETS).count()
    finally:
        set_tracer(old)
    assert got.count == _oracle_count("er48", plan.pattern)
    spans = tr.spans()
    by = collections.defaultdict(list)
    for s in spans:
        by[s["name"]].append(s)
    disp, (cnt,) = by["executor.dispatch"], by["executor.count"]
    outcomes = collections.Counter(s["attrs"]["outcome"] for s in disp)
    assert sum(outcomes.values()) == cnt["attrs"]["dispatches"] == len(disp)
    assert outcomes["split"] and outcomes["escalated"]
    assert cnt["attrs"]["discarded"] == (outcomes["split"]
                                         + outcomes["escalated"])
    assert set(outcomes) <= {"counted", "split", "escalated"}

    inside = _dispatch_of(spans)
    sites = collections.defaultdict(collections.Counter)
    for s in by["device.sync"]:
        assert inside[s["id"]] is not None
        sites[s["attrs"]["site"]][inside[s["id"]]] += 1
    buckets = len(BUCKETS)
    assert all(sites["slice_rows"][d["id"]] == (plan.depth - 1) * buckets
               for d in disp)
    assert all(sites["dispatch_needed"][d["id"]] == 1 for d in disp)
    assert sum(sites["dispatch_count"].values()) == outcomes["counted"]
    k1 = [s for s in spans if s["name"].startswith("kernel.")]
    if path == "portable":
        assert not k1 and not calls and not sites["k1_own"]
        return
    assert k1 and all(inside[s["id"]] is not None for s in k1)
    assert [s["attrs"]["rows"] for s in k1] == calls
    assert all(around)
    assert {s["name"] for s in k1} == {"kernel." + n for n in K1_ENTRIES}
    assert sum(sites["k1_own"].values()) == len(k1)


def test_a_disabled_tracer_records_nothing_over_a_count(monkeypatch):
    """Every span site of a count, the chunk loop's, the levels', the
    syncs' and K1's, gets the shared no-op from a disabled tracer."""
    from repro_torch.obs import trace

    plan = _plan(PATTERNS["P1"], False)
    tr = Tracer(enabled=False)
    seen = []

    def spy(name, **attrs):
        seen.append((name, Tracer.span(tr, name, **attrs)))
        return seen[-1][1]

    monkeypatch.setattr(tr, "span", spy)
    old = get_tracer()
    set_tracer(tr)
    try:
        got = _port("er48", plan, "kernel", 128, BUCKETS).count()
    finally:
        set_tracer(old)
    assert got.count == _oracle_count("er48", plan.pattern)
    assert {n for n, _ in seen} == {
        "executor.count", "executor.dispatch", "executor.level",
        "device.sync", "kernel.level_expand_rows",
        "kernel.level_expand_compact"}
    assert all(sp is trace._NOP for _, sp in seen)
    assert len(tr) == 0 and tr.spans() == []


def _traced_tails(m, plan):
    """`m.count()` under an enabled tracer: (result, the count span's
    attributes, [(outcome, the last level's `skipped`, count-mode K1
    calls) of each dispatch])."""
    old = get_tracer()
    tr = set_tracer(Tracer(enabled=True))
    try:
        got = m.count()
    finally:
        set_tracer(old)
    spans = tr.spans()
    inside = _dispatch_of(spans)
    (cnt,) = [s for s in spans if s["name"] == "executor.count"]
    per = {s["id"]: [s["attrs"]["outcome"], None, 0] for s in spans
           if s["name"] == "executor.dispatch"}
    for s in spans:
        if (s["name"] == "executor.level"
                and s["attrs"]["level"] == plan.depth - 1):
            assert per[inside[s["id"]]][1] is None     # one a dispatch
            per[inside[s["id"]]][1] = s["attrs"]["skipped"]
        elif (s["name"] == "kernel.level_expand_rows"
              and s["attrs"]["mode"] == "count"):
            per[inside[s["id"]]][2] += 1
    return got, cnt["attrs"], list(per.values())


@pytest.mark.parametrize("path", PATHS)
def test_overflowing_dispatches_skip_their_counting_tail(path):
    """P1 at capacity 128 over two buckets: every split or escalated
    dispatch skips its last level (no count-mode K1 call), every counted
    one runs it, the count's span notes as many skipped tails as
    discarded dispatches, and count, `max_needed` and the flag stay the
    reference's."""
    plan = _plan(PATTERNS["P1"], False)
    got, cnt, per = _traced_tails(_port("er48", plan, path, 128, BUCKETS),
                                  plan)
    assert (got.count, got.max_needed, got.overflowed) == _reference(
        "er48", plan, 128, BUCKETS)
    assert got.count == _oracle_count("er48", plan.pattern)
    outcomes = {o for o, _, _ in per}
    assert {"split", "escalated", "counted"} <= outcomes <= {
        "split", "escalated", "counted"}
    for outcome, skipped, calls in per:
        assert skipped == (outcome != "counted"), (outcome, skipped)
        if skipped:
            assert calls == 0
    assert cnt["tail_skipped"] == cnt["discarded"] == sum(
        s for _, s, _ in per) > 0
    if path == "kernel":
        assert sum(c for _, _, c in per) > 0


@pytest.mark.parametrize("path", PATHS)
def test_a_kept_truncated_count_runs_its_tail(path, monkeypatch):
    """With the escalation ceiling at 128 in both packages, a single
    root that overflows it is counted and flagged, truncated: such an
    `overflowed` dispatch runs its last level, and the count, its
    `max_needed` and the flag equal the reference's."""
    monkeypatch.setattr(tx.Matcher, "MAX_CAPACITY", 128)
    monkeypatch.setattr(rx.Matcher, "MAX_CAPACITY", 128)
    plan = _plan(PATTERNS["P1"], False)
    g, _ = _graph("er48")
    want = rx.count_embeddings(g, plan, rx.ExecutorConfig(
        capacity=128, use_pallas=False, degree_buckets=BUCKETS))
    got, cnt, per = _traced_tails(_port("er48", plan, path, 128, BUCKETS),
                                  plan)
    assert (got.count, got.max_needed, got.overflowed) == (
        want.count, want.max_needed, want.overflowed)
    assert got.overflowed
    kept = [(s, c) for o, s, c in per if o == "overflowed"]
    assert kept and not any(s for s, _ in kept)
    if path == "kernel":
        assert all(c > 0 for _, c in kept)
    assert all(s == (o == "split") for o, s, _ in per)
    assert cnt["tail_skipped"] == cnt["discarded"]


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
