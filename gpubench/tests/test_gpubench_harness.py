"""The benchmark's harness on the CPU: files found by name, the frozen
copies against the program's originals, the references against brute
force, the control, the last line, the imports, and runs with the timed
path broken underneath.

    PYTHONPATH=src python -m pytest -q gpubench/tests

Tests marked `cuda` run the control at a cell's own size on the card."""
from __future__ import annotations

import ast
import contextlib
import io
import itertools
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import bounds, graphgen, loadgen, reference, tracing  # noqa: E402
from gpubench.harness import Catalog, main  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


# ------------------------------------------------------------- helpers
def csr_of(n, edges) -> graphgen.DeviceCSR:
    e = torch.as_tensor(np.asarray(edges, dtype=np.int64).reshape(-1, 2))
    return graphgen.csr_from_edges(n, e[:, 0], e[:, 1])


def brute(g: graphgen.DeviceCSR, pattern) -> int:
    """Injective maps of the pattern into the graph over its
    automorphisms."""
    k = max(max(e) for e in pattern) + 1
    adj = set(map(tuple, g.edges().tolist()))
    maps = sum(all((p[u], p[v]) in adj for u, v in pattern)
               for p in itertools.permutations(range(g.n), k))
    aut = sum({frozenset((p[u], p[v])) for u, v in pattern}
              == {frozenset(e) for e in pattern}
              for p in itertools.permutations(range(k)))
    return maps // aut


def random_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, 1)
    keep = rng.random(len(iu[0])) < p
    return csr_of(n, np.stack([iu[0][keep], iu[1][keep]], 1))


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout-shaped directory whose BENCHMARK.json holds two tiny
    cells over the real mixes, metric readers and references."""
    root = tmp_path_factory.mktemp("tiny")
    gb = root / "gpubench"
    for sub in ("configs", "traffic", "workloads"):
        (gb / sub).mkdir(parents=True)
    for sub in ("metrics", "end_to_end"):
        shutil.copytree(ROOT / "gpubench" / sub, gb / sub)
    bench = dict(BENCH)
    bench["workloads"] = [
        {"name": "tiny.p1", "config": "tiny", "traffic": "closed_house",
         "chips": 1, "why": "tiny"},
        {"name": "tiny.tri", "config": "tiny", "traffic": "closed_triangle",
         "chips": 1, "why": "tiny"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = json.loads((ROOT / "gpubench/configs/g500-s12.json").read_text())
    cfg.update(name="tiny", scale=6, edge_factor=5, capacity=4096)
    (gb / "configs/tiny.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        shutil.copy(ROOT / f"gpubench/traffic/{w['traffic']}.json",
                    gb / "traffic")
        (gb / f"workloads/{w['name']}.json").write_text(json.dumps(
            {"config": "tiny", "traffic": w["traffic"],
             "trace": {"stretches": 2, "dispatches": 1}}))
    return root


def run_cpu(root, cell, seed=4_000_000_017, seconds=0.3, trace=0):
    """One run of `cell` on the CPU: (exit code, last stdout line as a
    dict or None, stderr lines)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  root=root)
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    last = json.loads(lines[-1]) if lines else None
    return rc, last, err.getvalue().splitlines()


# ---------------------------------------------------- found by name
def test_every_cell_finds_its_files_by_name():
    cat = Catalog(ROOT)
    assert {w["name"] for w in BENCH["workloads"]} == {
        p.stem for p in (ROOT / "gpubench/workloads").glob("*.json")}
    for w in BENCH["workloads"]:
        cell = cat.cell(w["name"])
        cfg = cat.config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert {"stretches", "dispatches"} <= set(cell["plan"]["trace"])
        for q in loadgen.queries(cat.mix(cell["traffic"])):
            mod = reference.load(q.pattern)
            assert reference.same_pattern(q.vertices, q.edges, mod.EDGES)
        for kind in ("end_to_end", "per_layer"):
            readers = cat.readers(kind)
            assert readers and all(callable(m.read) for _, m in readers)
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_a_mix_that_names_no_reference_is_refused():
    with pytest.raises(ModuleNotFoundError):
        reference.load("pentagon")
    assert not reference.same_pattern(5, ((0, 1), (1, 2), (2, 3), (3, 4),
                                          (0, 4)), reference.load(
                                              "house").EDGES)


# ------------------------------------------------------ frozen copies
@pytest.mark.parametrize("scale,edge_factor,seed",
                         [(6, 4, 0), (8, 8, 3), (10, 6, 7)])
def test_generator_copy_equals_the_original(scale, edge_factor, seed):
    from repro_torch.graph.datasets import rmat

    want = rmat(scale, edge_factor, seed=seed)
    rng = np.random.default_rng(seed)
    src, dst = graphgen.rmat_edges(
        scale, edge_factor, lambda m: torch.from_numpy(rng.random(m)))
    got = graphgen.csr_from_edges(1 << scale, src, dst)
    assert (got.n, got.m) == (want.n, want.m)
    assert np.array_equal(got.indptr.numpy(), want.indptr)
    assert np.array_equal(got.indices.numpy(), want.indices)
    assert np.array_equal(got.degrees.numpy(), want.degrees)


def test_tie_seed_renumbers_only_equal_degrees():
    spec = {"scale": 8, "edge_factor": 6, "a": 0.57, "b": 0.19, "c": 0.19,
            "graph_seed": 1}
    one = graphgen.draw_rmat(spec, 5, "cpu")
    two = graphgen.draw_rmat(spec, 6, "cpu")
    again = graphgen.draw_rmat(spec, 5, "cpu")
    assert torch.equal(one.indices, again.indices)
    assert not torch.equal(one.indices, two.indices)
    assert torch.equal(one.degrees, two.degrees)
    assert torch.all(one.degrees[:-1] >= one.degrees[1:])
    assert reference.load("house").count(one) == \
        reference.load("house").count(two)


def _rows_case(seed, P, B, E, Q, width):
    g = torch.Generator().manual_seed(seed)
    F = 4096

    def ints(*shape, hi=F):
        return torch.randint(0, hi, shape, generator=g, dtype=torch.int32)

    csrc = torch.sort(ints(F)).values
    cstart = ints(B, hi=F - width)
    clen = ints(B, hi=width + 8)
    starts = ints(P, B, hi=F - 64)
    lens = ints(P, B, hi=80)
    own = torch.randint(-1, P, (B,), generator=g, dtype=torch.int32)
    extra = ints(B, E) if E else None
    neg = ints(B, Q) if Q else None
    dirs = tuple((1, -1, 0)[i % 3] for i in range(E))
    return (csrc, cstart, clen, csrc, starts, lens, own, extra, neg), dict(
        dirs=dirs, width=width, window=64)


@pytest.mark.parametrize("seed,P,B,E,Q,width,written",
                         [(0, 1, 50, 0, 0, 16, None),
                          (1, 2, 300, 2, 0, 128, None),
                          (2, 3, 200, 3, 4, 32, None),
                          (3, 2, 100, 1, 0, 64, 1234)])
def test_bound_copy_equals_the_program(seed, P, B, E, Q, width, written):
    from repro_torch.roofline import kernels as program

    args, kw = _rows_case(seed, P, B, E, Q, width)
    assert bounds.rows_bound_of(*args, **kw, written=written) == \
        program.rows_bound_of(*args, **kw, written=written)
    csrc, cstart, clen, _, starts, lens, _, extra, _ = args
    cand, ok = bounds.gather_window(csrc, cstart, clen, width)
    for count in (False, True):
        assert bounds.bound_of(cand, starts, lens, extra, ok, count, 64) \
            == program.bound_of(cand, starts, lens, extra, ok, count, 64)
    assert bounds.PEAKS["hbm_bytes_per_s"] == program.HBM_BYTES_PER_S
    assert bounds.PEAKS["fp32_ops_per_s"] == program.CORE_OPS_PER_S


# ------------------------------------------------------- the reference
@pytest.mark.parametrize("pattern", ["house", "triangle"])
@pytest.mark.parametrize("n,p,seed", [(7, 0.6, 0), (8, 0.5, 1),
                                      (9, 0.45, 2), (8, 0.9, 3)])
def test_reference_equals_brute_force(pattern, n, p, seed):
    g = random_graph(n, p, seed)
    mod = reference.load(pattern)
    assert mod.count(g) == brute(g, mod.EDGES)


@pytest.mark.parametrize("pattern,n,p", [("house", 400, 0.5),
                                         ("triangle", 600, 0.95)])
def test_control_in_float32_is_not_exact(pattern, n, p):
    """The control: the reference one precision lower.  At counts past
    2**24 it is off, and the comparison (limit 0) fails it."""
    g = random_graph(n, p, 11)
    mod = reference.load(pattern)
    exact = mod.count(g)
    assert exact > 1 << 24
    assert mod.count(g, torch.float32) != exact


def test_the_control_in_the_programs_place_comes_out_not_correct(
        tiny_root):
    """The control driven through the harness's own window and check:
    on a graph whose house count is past 2**24 its float32 counts are
    off, and the run comes out not correct."""
    from gpubench.control import Control, run

    cfg = json.loads((tiny_root / "gpubench/configs/tiny.json").read_text())
    cfg.update(name="tiny16", scale=9, edge_factor=16)
    (tiny_root / "gpubench/configs/tiny16.json").write_text(json.dumps(cfg))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny16.p1", "config": "tiny16",
                               "traffic": "closed_house", "chips": 1,
                               "why": "tiny"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    (tiny_root / "gpubench/workloads/tiny16.p1.json").write_text(json.dumps(
        {"config": "tiny16", "traffic": "closed_house",
         "trace": {"stretches": 1, "dispatches": 1}}))
    row = run(Catalog(tiny_root), "tiny16.p1", 3, 0.2, Control,
              device="cpu")
    assert row["correct"] is False and row["attempted"] >= 1
    assert row["checks"]["count_gap"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_at_the_cells_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gpubench.control import Control, run

    rows = [run(Catalog(ROOT), cell, seed, 1.0, Control)
            for seed in (1, 2, 3)]
    assert all(r["correct"] is False for r in rows)


def test_every_window_query_starts_from_the_configured_capacity(tiny_root):
    """A matcher keeps the capacity its count escalated to; the window's
    queries each start from a fresh plan cache, so each makes the
    warm-up's splits and escalations again."""
    cfg = json.loads((tiny_root / "gpubench/configs/tiny.json").read_text())
    cfg.update(name="tinycap", scale=5, edge_factor=4, capacity=16)
    (tiny_root / "gpubench/configs/tinycap.json").write_text(json.dumps(cfg))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tinycap.p1", "config": "tinycap",
                               "traffic": "closed_house", "chips": 1,
                               "why": "tiny"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    (tiny_root / "gpubench/workloads/tinycap.p1.json").write_text(json.dumps(
        {"config": "tinycap", "traffic": "closed_house",
         "trace": {"stretches": 1, "dispatches": 1}}))
    rc, line, err = run_cpu(tiny_root, "tinycap.p1", seconds=0.6)
    assert rc == 0 and line["correct"] is True
    warm = [ln for ln in err if "warm-up house" in ln]
    rounds = [ln for ln in err if ln.startswith("[gpubench] round ")]
    n = warm[0].split("dispatches=")[1].split()[0]
    assert int(n) > 50 and len(rounds) >= 2
    assert all(ln.split(", ")[-1] == f"{n} dispatches" for ln in rounds)


# ---------------------------------------------------------- the line
@pytest.mark.parametrize("cell,trace", [("tiny.tri", 0), ("tiny.tri", 1),
                                        ("tiny.p1", 0)])
def test_last_line_has_the_contracts_shape(tiny_root, cell, trace):
    rc, line, err = run_cpu(tiny_root, cell, trace=trace)
    assert rc == 0 and line["correct"] is True
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end" if not trace
                                     else "per_layer"]}
    assert set(line["metrics"]) <= want
    assert "query_s" in line["metrics"] or trace
    assert "dispatches_per_query" in line["metrics"] or not trace
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert [c["limit"] for c in line["checks"].values()] == [0, 0]
    assert err[-2:] == [f"[gpubench] check {k} {c['value']} limit "
                        f"{c['limit']}" for k, c in line["checks"].items()]


def test_no_card_no_result(tiny_root):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(["--workload", "tiny.tri", "--seed", "1", "--seconds",
                   "1"], root=tiny_root)
    assert rc != 0 and out.getvalue() == ""


def test_run_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


# ------------------------------------------------------------ imports
def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in (ROOT / "gpubench").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path
    for path in (ROOT / "gpubench/reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_a_run_loads_no_jax_and_the_reference_no_program(tiny_root):
    code = f"""
import contextlib, io, pathlib, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
from gpubench.reference import house, triangle
from gpubench import graphgen
g = graphgen.draw_rmat({{"scale": 6, "edge_factor": 5, "a": .57, "b": .19,
                        "c": .19, "graph_seed": 1}}, 3, "cpu")
house.count(g), triangle.count(g)
assert not any(m.split(".")[0].startswith("repro") for m in sys.modules)
from gpubench.harness import main
with contextlib.redirect_stdout(io.StringIO()):
    assert main(["--workload", "tiny.tri", "--seed", "5", "--seconds",
                 "0.2", "--trace", "1"], device="cpu",
                root=pathlib.Path({str(tiny_root)!r})) == 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
assert not bad, bad
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]


# ------------------------------------------------ the timed path broken
@contextlib.contextmanager
def broken(entry, fault):
    """K1's `entry` in the program's ops with its output changed by
    `fault` where it is produced."""
    from repro_torch.kernels import ops

    real = getattr(ops, entry)

    def wrapped(*a, **kw):
        return fault(real(*a, **kw))

    setattr(ops, entry, wrapped)
    try:
        yield
    finally:
        setattr(ops, entry, real)


def _alter_one(out):
    out = out.clone()
    if out.numel():
        out[0] += 1
    return out


def _half_doubled(out):
    out = out.clone()
    half = out.numel() // 2
    out[half:] = 0
    out[:half] *= 2
    return out


FAULTS = {
    "an answer altered where it is produced": _alter_one,
    "half the rows left out, the rest doubled": _half_doubled,
    "a step that returns nothing (the state unchanged)": torch.zeros_like,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_count_comes_out_not_correct(tiny_root, fault):
    with broken("level_expand_rows", FAULTS[fault]):
        rc, line, err = run_cpu(tiny_root, "tiny.tri")
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["count_gap"]["value"] > 0


def test_a_dropped_pair_of_the_mask_level_comes_out_not_correct(tiny_root):
    from repro_torch.kernels import ops

    real = ops.level_expand_compact

    def drop_last(*a, **kw):
        real(*a, **kw)
        offset = kw["offset"] if "offset" in kw else a[9]
        if int(offset) > 0:
            offset -= 1

    ops.level_expand_compact = drop_last
    try:
        rc, line, _ = run_cpu(tiny_root, "tiny.p1")
    finally:
        ops.level_expand_compact = real
    assert rc == 0 and line["correct"] is False


# ----------------------------------------------------------- reduction
def _ev(name, t0, t1, dev=False, corr=0, linked=0, tid=1, ann=False):
    return tracing.Ev(name, t0, t1, dev, tid, corr, linked, ann)


@pytest.mark.parametrize("device_ranges", [True, False])
def test_reduction_splits_k1_from_glue_and_names_the_gaps(device_ranges):
    k1 = tracing.K1_PREFIX + "level_expand_rows"
    host = [
        _ev("executor.dispatch", 0, 100, corr=1, ann=True),
        _ev(k1, 10, 30, corr=2, ann=True),
        _ev("cudaLaunchKernel", 12, 14, corr=900, linked=2),
        _ev("aten::index", 40, 50, corr=3),
        _ev("cudaLaunchKernel", 42, 44, corr=901, linked=3),
        _ev("executor.dispatch", 120, 200, corr=5, ann=True),
        _ev("aten::cat", 130, 140, corr=6),
        _ev("cudaLaunchKernel", 132, 134, corr=902, linked=6),
    ]
    dev = [_ev("level_rows_kernel", 20, 50, True, corr=900, linked=2),
           _ev("index_kernel", 50, 70, True, corr=901, linked=3),
           _ev("cat_kernel", 140, 150, True, corr=902, linked=6)]
    if device_ranges:      # the device's copies of the host's ranges
        dev += [_ev(k1, 20, 50, True, ann=True),
                _ev("executor.dispatch", 20, 70, True),
                _ev("executor.dispatch", 140, 150, True)]
    r = tracing.reduce([host + dev])
    assert (r.window_ns, r.busy_ns, r.device_ns) == (200, 60, 60)
    assert r.k1_ns == 30
    assert dict(r.gaps) == {
        "executor.dispatch / " + k1: 20,
        "executor.count, between dispatches": 70,
        "executor.dispatch": 50}
    assert tracing.top(r.ops, 1) == [["level_rows_kernel", 30e-9]]
