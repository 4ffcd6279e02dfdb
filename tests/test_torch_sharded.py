"""Multi-GPU counting on the CPU: the port's `ShardedMatcher` — one
process per rank under `torch.distributed` (gloo, spawned ranks) —
against the reference's `ShardedMatcher` over 1, 2 and 4 host devices
of one JAX process (`tests/ref_sharded.py`, run in a subprocess since
JAX fixes its device count at start-up).

For each case the plan records are field-equal, each rank's striped
roots are its row of the reference's `_v0`, and the count,
`max_needed`, the overflow flag and the sticky escalated capacity are
equal, on the portable path and on the kernel path (K1's plain versions
on CPU tensors), with the tiny-er values pinned.  Also: a repeat count
is one pass at the sticky capacity; a frontier past the escalation
ceiling is reported as overflowed; `rebind` refusals; ranks holding
different plans or layouts raise on every rank; `import repro_torch`
initializes no group and leaves JAX out.  Counts are exact.

This file imports no JAX: the spawned ranks import it by name.
"""
import json
import os
import pathlib
import subprocess
import sys
import time
import types

import pytest
import torch.distributed as dist
from torch_ranks import init_rank, join_ranks, start_ranks

from repro_torch.configs.graphpi import get_pattern
from repro_torch.core import executor as tx
from repro_torch.core.config_search import (
    graphzero_configuration, search_configuration,
)
from repro_torch.core.plan import build_plan, plan_to_dict
from repro_torch.graph.datasets import named_dataset
from repro_torch.obs import Tracer, get_tracer, set_tracer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PATHS = ("portable", "kernel")
WORLDS = (1, 2, 4)
HOUSE_LABELS = [0, 1, 0, 1, None]
# [id, dataset, pattern, labels, mode, use_iep, capacity, world sizes].
# P1 / P2 at capacity 4,096 escalate by whole passes at every world
# size.  P3 and naive P2 start at a capacity that fits their frontier
# (the reference's static shapes make each pass seconds there), at W = 4.
CASES = [
    ["P1", "tiny-er", "P1", None, "graphpi", False, 4096, WORLDS],
    ["P2", "tiny-er", "P2", None, "graphpi", False, 4096, WORLDS],
    ["P3", "tiny-er", "P3", None, "graphpi", False, 1 << 19, (4,)],
    ["P1-graphzero-iep", "tiny-er", "P1", None, "graphzero", True, 4096,
     WORLDS],
    ["P2-graphzero", "tiny-er", "P2", None, "graphzero", False, 4096,
     (2, 4)],
    ["P2-naive", "tiny-er", "P2", None, "naive", False, 1 << 18, (4,)],
    ["P1-labeled", "tiny-labeled", "P1", HOUSE_LABELS, "graphpi", False,
     4096, WORLDS],
]
# The reference's values on tiny-er at capacity 4,096 (count, then
# max_needed at W = 1, 2, 4).
PINNED = {"P1": (27_358, (30_431, 15_274, 7_841)),
          "P2": (87_724, (117_385, 59_752, 30_041))}


def _plan_of(pattern, stats, mode, use_iep):
    if mode == "graphzero":
        c = graphzero_configuration(pattern, stats, use_iep=use_iep)
    else:
        c = search_configuration(pattern, stats,
                                 use_iep=use_iep and mode != "naive").best
    return build_plan(pattern, c.order, () if mode == "naive" else c.res_set,
                      iep_k=c.iep_k)


def _case_plan(case, graphs):
    _, gname, pname, labels, mode, iep, _, _ = case
    if gname not in graphs:
        g = named_dataset(gname)
        graphs[gname] = (g, tx.compute_stats(
            g, tx.ExecutorConfig(capacity=4096), device="cpu"))
    g, stats = graphs[gname]
    pattern = get_pattern(pname)
    if labels is not None:
        pattern = pattern.with_labels(tuple(labels))
    return g, _plan_of(pattern, stats, mode, iep)


def _raises(fn, exc):
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def _traced_count(m):
    """`m.count()` under an enabled tracer: (result, [each pass's
    `outcome`], the count span's `discarded`)."""
    old = get_tracer()
    tr = set_tracer(Tracer(enabled=True))
    try:
        r = m.count()
    finally:
        set_tracer(old)
    spans = tr.spans()
    (count,) = [s for s in spans if s["name"] == "executor.count"]
    return r, [s["attrs"]["outcome"] for s in spans
               if s["name"] == "executor.dispatch"], count["attrs"][
                   "discarded"]


def _checks(group, rank, graphs):
    """Ceiling overflow, rebind refusals and the same-program check, on
    every rank of a world of 2."""
    g, p1 = _case_plan(CASES[0], graphs)
    _, p2 = _case_plan(CASES[1], graphs)
    out = {}
    ceiling = tx.Matcher.MAX_CAPACITY
    tx.Matcher.MAX_CAPACITY = 8192
    try:
        m = tx.ShardedMatcher(g, p2, group, device="cpu",
                              cfg=tx.ExecutorConfig(capacity=4096))
        r, outcomes, discarded = _traced_count(m)
    finally:
        tx.Matcher.MAX_CAPACITY = ceiling
    out["ceiling"] = [r.overflowed, r.max_needed, m._capacity, m.passes]
    out["ceiling_outcomes"] = [outcomes, discarded]

    m = tx.ShardedMatcher(g, p1, group, device="cpu",
                          cfg=tx.ExecutorConfig(capacity=1 << 15))
    want = m.count().count
    other = named_dataset("tiny-labeled")
    out["rebind_shape"] = _raises(
        lambda: m.rebind(tx.device_graph(other, "cpu")), ValueError)
    arrays = tx.device_graph(g, "cpu")
    out["rebind_window"] = _raises(lambda: m.rebind(
        arrays, graph=types.SimpleNamespace(max_degree=g.max_degree + 1,
                                            n=g.n)), ValueError)
    out["rebind_n"] = _raises(lambda: m.rebind(
        arrays, graph=types.SimpleNamespace(max_degree=g.max_degree,
                                            n=g.n + 1)), ValueError)
    m.rebind(arrays, graph=g)
    out["rebound_count"] = m.count().count == want
    m.release()
    out["released"] = [_raises(m.count, RuntimeError),
                       _raises(lambda: m.rebind(arrays), RuntimeError)]
    out["unlabeled_graph"] = _raises(
        lambda: tx.ShardedMatcher(g, _case_plan(CASES[-1], graphs)[1],
                                  group, device="cpu"), ValueError)
    out["other_plan"] = _raises(
        lambda: tx.ShardedMatcher(g, p1 if rank == 0 else p2, group,
                                  device="cpu"), RuntimeError)
    out["other_chunk"] = _raises(
        lambda: tx.ShardedMatcher(g, p1, group, device="cpu",
                                  chunk=64 * (rank + 1)), RuntimeError)
    return out


def _tail_checks(group, graphs):
    """P1 at capacity 4,096 on both paths, traced with level fences, and
    again with the count function's `discard_overflow` ignored: the
    result, the sticky capacity and the passes of each, and per pass its
    outcome, its `tail_skipped` and each chunk's last level as
    (needed, skipped)."""
    g, plan = _case_plan(CASES[0], graphs)
    out = {}
    for path in PATHS:
        cfg = tx.ExecutorConfig(capacity=4096, use_kernel=path == "kernel")
        m = tx.ShardedMatcher(g, plan, group, device="cpu", cfg=cfg)
        old = get_tracer()
        tr = set_tracer(Tracer(enabled=True, sync=True))
        try:
            r = m.count()
        finally:
            set_tracer(old)
        spans = tr.spans()
        by_id = {s["id"]: s for s in spans}
        passes = {s["id"]: [s["attrs"]["capacity"], s["attrs"]["outcome"],
                            s["attrs"]["tail_skipped"], []]
                  for s in spans if s["name"] == "executor.dispatch"}
        for s in spans:
            if (s["name"] == "executor.level"
                    and s["attrs"]["level"] == plan.depth - 1):
                d = by_id[s["parent"]]
                while d["name"] != "executor.dispatch":
                    d = by_id[d["parent"]]
                passes[d["id"]][3].append([s["attrs"]["needed"],
                                           s["attrs"]["skipped"]])
        (cnt,) = [s for s in spans if s["name"] == "executor.count"]

        plain = tx.ShardedMatcher(g, plan, group, device="cpu", cfg=cfg)
        fn_of = plain._fn

        def unskipped(capacity, _fn_of=fn_of):
            fn = _fn_of(capacity)
            return lambda *a, discard_overflow=False: fn(*a)

        plain._fn = unskipped
        p = plain.count()
        out[path] = {
            "got": [r.count, r.max_needed, r.overflowed, m._capacity,
                    m.passes],
            "unskipped": [p.count, p.max_needed, p.overflowed,
                          plain._capacity, plain.passes],
            "passes": list(passes.values()),
            "tail_skipped": cnt["attrs"]["tail_skipped"]}
    return out


def _count_rank(rank, world, rdv, out_dir):
    """One rank: every case of this world size on both paths (a repeat
    count after an escalating one), then the checks at W = 2."""
    group, _ = init_rank(rank, world, rdv)
    graphs, out = {}, {}
    for case in CASES:
        if world not in case[7]:
            continue
        g, plan = _case_plan(case, graphs)
        rec = {"plan": plan_to_dict(plan), "paths": {}}
        for path in PATHS:
            m = tx.ShardedMatcher(
                g, plan, group, device="cpu", cfg=tx.ExecutorConfig(
                    capacity=case[6], use_kernel=path == "kernel"))
            r, outcomes, discarded = _traced_count(m)
            got = {"count": r.count, "max_needed": r.max_needed,
                   "overflowed": r.overflowed, "capacity": m._capacity,
                   "passes": m.passes, "outcomes": [outcomes, discarded]}
            if m.passes > 1:
                again = m.count()
                got["repeat"] = [again.count, again.max_needed,
                                 m.passes - got["passes"]]
            rec["paths"][path] = got
            rec["v0"] = m._v0.tolist()
        out[case[0]] = rec
    if world == 2:
        out["_checks"] = _checks(group, rank, graphs)
        out["_tails"] = _tail_checks(group, graphs)
    with open(os.path.join(out_dir, f"w{world}-r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's records and the port's, by world size and rank.
    The reference runs in two subprocesses (half the cases each) while
    the port's three worlds of ranks run beside them."""
    tmp = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    refs = []
    for i, part in enumerate((CASES[:3] + CASES[-1:], CASES[3:-1])):
        (tmp / f"cases{i}.json").write_text(json.dumps(part))
        refs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "ref_sharded.py"),
             str(tmp / f"cases{i}.json"), str(tmp / f"ref{i}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        handles = [start_ranks(_count_rank, w, tmp, str(tmp))
                   for w in WORLDS]
        for h in handles:
            join_ranks(h)
        logs = [r.communicate(timeout=300)[0] for r in refs]
    finally:
        for r in refs:
            if r.poll() is None:
                r.kill()
                r.wait()
    for r, log in zip(refs, logs):
        assert r.returncode == 0, log
    ref = {}
    for i in range(len(refs)):
        ref.update(json.loads((tmp / f"ref{i}.json").read_text()))
    port = {w: [json.loads((tmp / f"w{w}-r{r}.json").read_text())
                for r in range(w)] for w in WORLDS}
    return ref, port


COUNT_CASES = [(c[0], w, p) for c in CASES for w in c[7] for p in PATHS]


@pytest.mark.parametrize("cid,world,path", COUNT_CASES,
                         ids=[f"{c}-W{w}-{p}" for c, w, p in COUNT_CASES])
def test_sharded_counts_equal_reference(runs, cid, world, path):
    ref, port = runs
    want = ref[cid]["worlds"][str(world)]
    for rank, rec in enumerate(port[world]):
        got = rec[cid]["paths"][path]
        assert (got["count"], got["max_needed"], got["overflowed"],
                got["capacity"]) == (want["count"], want["max_needed"],
                                     want["overflowed"], want["capacity"]), \
            (rank, got, want)
        if "repeat" in got:        # sticky capacity: one pass, same result
            assert got["repeat"] == [want["count"], want["max_needed"], 1]
    if cid in PINNED:
        count, needed = PINNED[cid]
        assert (want["count"], want["max_needed"]) == (
            count, needed[WORLDS.index(world)])


STRIPE_CASES = [(c[0], w) for c in CASES for w in c[7]]


@pytest.mark.parametrize("cid,world", STRIPE_CASES,
                         ids=[f"{c}-W{w}" for c, w in STRIPE_CASES])
def test_plans_and_stripes_equal_reference(runs, cid, world):
    ref, port = runs
    v0 = ref[cid]["worlds"][str(world)]["v0"]
    per = len(v0) // world
    for rank, rec in enumerate(port[world]):
        assert json.loads(json.dumps(rec[cid]["plan"])) == ref[cid]["plan"]
        assert rec[cid]["v0"] == v0[rank * per:(rank + 1) * per]


def test_escalation_reaches_past_the_first_pass(runs):
    """At capacity 4,096 P1 and P2 need whole-pass doubling on one rank
    (so the repeat above ran), and every rank reports the same passes;
    each pass's span says it escalated, but the last, which counted."""
    _, port = runs
    for cid in ("P1", "P2"):
        passes = {r[cid]["paths"][p]["passes"] for r in port[1]
                  for p in PATHS}
        assert len(passes) == 1 and passes.pop() > 1, cid
    for world, ranks in port.items():
        for rank in ranks:
            for cid, rec in rank.items():
                for got in rec.get("paths", {}).values():
                    n = got["passes"]
                    assert got["outcomes"] == [
                        ["escalated"] * (n - 1) + ["counted"], n - 1], (
                            world, cid, got)


def test_overflow_past_the_ceiling_is_reported(runs):
    _, port = runs
    for rank in port[2]:
        overflowed, needed, capacity, passes = rank["_checks"]["ceiling"]
        assert overflowed and capacity == 8192 and needed > capacity
        assert passes == 2                  # 4,096, then the ceiling
        assert rank["_checks"]["ceiling_outcomes"] == [
            ["escalated", "overflowed"], 1]


def test_overflowing_chunks_skip_their_tail_in_escalated_passes(runs):
    """P1 at capacity 4,096 on two ranks: a chunk skips its last level
    exactly where its `needed` overflows a pass below the ceiling, so
    only escalated passes skip; the count, `max_needed`, the flag, the
    sticky capacity and the passes equal the reference's and those of
    the same count with no tail skipped."""
    ref, port = runs
    want = ref["P1"]["worlds"]["2"]
    skipped_on_any_rank = {}
    for rank in port[2]:
        for path, rec in rank["_tails"].items():
            count, needed, overflowed, capacity, n = rec["got"]
            assert [count, needed, overflowed, capacity] == [
                want["count"], want["max_needed"], want["overflowed"],
                want["capacity"]], (path, rec)
            assert rec["got"] == rec["unskipped"] and n > 1, (path, rec)
            assert [o for _, o, _, _ in rec["passes"]] == [
                "escalated"] * (n - 1) + ["counted"]
            for i, (cap, outcome, tails, chunks) in enumerate(
                    rec["passes"]):
                assert chunks and all(s == (need > cap)
                                      for need, s in chunks), (path, i)
                assert tails == sum(s for _, s in chunks)
                skipped_on_any_rank.setdefault((path, i), 0)
                skipped_on_any_rank[(path, i)] += tails
            assert rec["tail_skipped"] == sum(
                t for _, _, t, _ in rec["passes"])
    for (path, i), tails in skipped_on_any_rank.items():
        n = port[2][0]["_tails"][path]["got"][4]
        assert (tails > 0) == (i < n - 1), (path, i, tails)


def test_rebind_refusals(runs):
    _, port = runs
    for rank in port[2]:
        c = rank["_checks"]
        assert "identical array shapes" in c["rebind_shape"]
        assert "rebind window" in c["rebind_window"]
        assert "rebind vertex count" in c["rebind_n"]
        assert c["rebound_count"] is True
        assert all("released" in msg for msg in c["released"])
        assert "cannot run against unlabeled graph" in c["unlabeled_graph"]


def test_ranks_with_another_program_raise_on_every_rank(runs):
    _, port = runs
    for rank in port[2]:
        c = rank["_checks"]
        assert "ranks [1] hold another plan" in c["other_plan"]
        assert "ranks [1] hold another plan" in c["other_chunk"]


def test_import_initializes_no_group_and_no_jax():
    code = ("import sys, torch.distributed as dist, repro_torch, "
            "repro_torch.core.executor, repro_torch.launch.mesh, "
            "repro_torch.query, repro_torch.launch.mine, "
            "repro_torch.launch.query_serve; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not dist.is_initialized(); print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", (
        out.stdout + out.stderr, time.monotonic() - t0)
