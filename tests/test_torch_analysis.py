"""The port's static verifier (`repro_torch.analysis`): the seeded
violations of `tests/test_analysis.py` ported to the port's rules, the
lint clean on the live port tree, K1's contract over the executor's
call shapes (clean, violated, and the `--deep` pass on `meta` tensors),
the CLI's exit codes, and fsck of a tampered store through the port's
`PlanStore`.  Rules are matched by name, as in the reference's tests.
"""
import dataclasses
import json
import os
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import (
    ERROR, Finding, LevelExpandSpec, abstract_eval_spec,
    check_graph_contract, check_spec, error_count, executor_specs,
    format_findings, has_errors, lint_source, lint_tree,
)
from repro_torch.analysis.__main__ import main as cli
from repro_torch.configs.graphpi import get_pattern
from repro_torch.core.executor import ExecutorConfig, compute_stats
from repro_torch.graph.datasets import erdos_renyi
from repro_torch.kernels import intersect, ops
from repro_torch.query import PlanStore, QueryEngine, QueryRequest
from repro_torch.query.store import SCHEMA_VERSION

REPO_ROOT = Path(__file__).resolve().parent.parent
CFG = ExecutorConfig(capacity=1 << 12)


@pytest.fixture(scope="module")
def tiny_graph():
    return erdos_renyi(64, 256, seed=7, name="er64")


@pytest.fixture(scope="module")
def tiny_stats(tiny_graph):
    return compute_stats(tiny_graph, CFG, device="cpu")


def _rules(src, rel):
    return {f.rule for f in lint_source(src, rel)}


# ------------------------------------------------------------------ lint
def test_lint_clean_on_live_tree():
    findings = lint_tree(REPO_ROOT)
    assert not has_errors(findings), format_findings(findings)


def test_lint_reads_the_port_and_its_entry_files(tmp_path):
    pkg = tmp_path / "src" / "repro_torch" / "serve"
    pkg.mkdir(parents=True)
    (pkg / "x.py").write_text("import jax\n")
    (tmp_path / "chip_smoke.py").write_text("from repro.core import plan\n")
    (tmp_path / "examples").mkdir()
    (tmp_path / "examples" / "torch_a.py").write_text("import jaxlib\n")
    (tmp_path / "examples" / "other.py").write_text("import jax\n")
    found = {(f.rule, f.location.split(":")[0]) for f in lint_tree(tmp_path)}
    assert found == {
        ("no-reference-import", "src/repro_torch/serve/x.py"),
        ("no-reference-import", "chip_smoke.py"),
        ("no-reference-import", "examples/torch_a.py")}


@pytest.mark.parametrize("imp", ["import torch", "import jax",
                                 "from torch import cuda",
                                 "import torch.distributed as dist"])
def test_lint_scheduler_no_framework(imp):
    src = f"{imp}\ndef pick():\n    return 1\n"
    assert "scheduler-no-framework" in _rules(src, "serve/scheduler.py")
    # the same import is fine anywhere else on that front
    assert "scheduler-no-framework" not in _rules(src, "serve/gateway.py")


def test_lint_scheduler_rules():
    src = ("import time\nimport torch\nimport random\n"
           "def pick():\n"
           "    return torch.zeros(1), time.time(), random.random()\n")
    rules = _rules(src, "src/repro_torch/serve/scheduler.py")
    assert {"scheduler-no-framework", "scheduler-determinism"} <= rules
    assert not {"scheduler-no-framework", "scheduler-determinism"} & \
        _rules(src, "query/engine.py")


def test_lint_no_raw_timing():
    src = "import time\ndef t():\n    return time.perf_counter()\n"
    for rel in ("serve/scheduler.py", "query/engine.py",
                "src/repro_torch/serve/spmd.py"):
        assert _rules(src, rel) == {"no-raw-timing"}, rel
    f = lint_source("from time import monotonic, sleep\n",
                    "serve/gateway.py")
    assert [x.rule for x in f] == ["no-raw-timing"]   # sleep not flagged
    assert not lint_source(src, "src/repro_torch/obs/trace.py")
    assert not lint_source(src, "core/config_search.py")


def test_lint_no_stale_fingerprint():
    src = ("class Engine:\n"
           "    def __init__(self, graph, stats):\n"
           "        self.fp = graph.fingerprint\n"
           "    def rekey(self, graph, stats):\n"
           "        self._key = graph_fingerprint(graph, stats)\n")
    for rel in ("serve/gateway.py", "query/engine.py",
                "src/repro_torch/query/cache.py"):
        f = [x for x in lint_source(src, rel)
             if x.rule == "no-stale-fingerprint"]
        assert len(f) == 2, rel
    ok = ("def f(graph, stats):\n"
          "    fp = graph.fingerprint\n"
          "    return graph_fingerprint(graph, stats), fp\n")
    assert not lint_source(ok, "serve/gateway.py")
    epoch = ("class Engine:\n"
             "    def bump(self, live, stats):\n"
             "        self._epoch = EpochStamp.for_live(live, stats)\n")
    assert not lint_source(epoch, "query/engine.py")
    assert not lint_source(src, "core/executor.py")


def test_lint_label_coverage():
    src = ("def canonical_key(p):\n"
           "    return str(p.n)\n"
           "def _wl_cells(p):\n"
           "    return [p.labels]\n")
    f = lint_source(src, "src/repro_torch/query/canon.py")
    assert any(x.rule == "label-coverage" and "canonical_key" in x.message
               for x in f)
    assert not any("_wl_cells" in x.message for x in f)
    f2 = lint_source("x = 1\n", "src/repro_torch/core/plan.py")
    assert any(x.rule == "label-coverage" and "plan_to_dict" in x.message
               for x in f2)
    assert "label-coverage" not in _rules("x = 1\n",
                                          "src/repro_torch/obs/metrics.py")


@pytest.mark.parametrize("src", [
    "import jax\n", "import jax.numpy as jnp\n", "import jaxlib\n",
    "from jax import lax\n", "import repro\n",
    "from repro.core.plan import build_plan\n",
    "from repro import configs\n",
])
def test_lint_no_reference_import(src):
    assert _rules(src, "src/repro_torch/core/executor.py") == \
        {"no-reference-import"}
    assert _rules(src, "chip_smoke.py") == {"no-reference-import"}


@pytest.mark.parametrize("src", [
    "from ..core import plan\n", "from . import repro_utils\n",
    "import repro_torch.core\n", "from repro_torch import convert\n",
])
def test_lint_port_imports_are_not_reference_imports(src):
    assert "no-reference-import" not in _rules(
        src, "src/repro_torch/core/executor.py")


@pytest.mark.parametrize("src", [
    "import ctypes\n",
    "from ctypes import CDLL\n",
    "def f(p):\n    return ctypes.CDLL(p)\n",
    "from ..kernels import intersect\n",
    "from ..kernels.membership import membership_cuda\n",
    "from repro_torch.kernels import flash_attention\n",
    "import repro_torch.kernels.intersect\n",
    "from ..kernels import nvcc\n",
    "from torch.utils.cpp_extension import load\n",
    "import subprocess\ndef f():\n    subprocess.run(['nvcc', 'a.cu'])\n",
])
def test_lint_kernel_through_ops(src):
    assert _rules(src, "src/repro_torch/core/executor.py") == \
        {"kernel-through-ops"}
    # kernels/ is the home of loads and builds
    assert "kernel-through-ops" not in _rules(
        src, "src/repro_torch/kernels/intersect.py")


@pytest.mark.parametrize("src", [
    "from ..kernels import ops\n", "from ..kernels.ref import gather_window\n",
    "from repro_torch.kernels import ops, ref\n",
    "from ..kernels.ops import K1_MODES\n",
])
def test_lint_kernel_front_is_allowed(src):
    assert not lint_source(src, "src/repro_torch/serve/session.py")


def test_lint_syntax_error_is_a_finding():
    f = lint_source("def f(:\n", "src/repro_torch/core/x.py")
    assert [x.rule for x in f] == ["syntax"] and has_errors(f)


# ------------------------------------------------------- kernel contracts
OK = LevelExpandSpec(B=64, width=16, P=2, E=2, window=16, flat_len=512)


@pytest.mark.parametrize("entry,kw", [
    ("rows", dict(E=1)), ("rows", dict(E=0, Q=4)),
    ("compact", dict(capacity=4096)), ("window", {})])
def test_kernel_spec_clean(entry, kw):
    spec = dataclasses.replace(OK, entry=entry, **kw)
    assert not check_spec(spec)
    assert not abstract_eval_spec(spec), entry


@pytest.mark.parametrize("change,rule", [
    (dict(P=17), "kernel-preds"),
    (dict(P=0), "kernel-preds"),
    (dict(E=17), "kernel-dirs"),
    (dict(width=17), "kernel-window"),
    (dict(window=0, width=0), "kernel-window"),
    (dict(flat_len=2**31 - 10), "kernel-int32-offset"),
    (dict(entry="compact", capacity=2**31), "kernel-int32-offset"),
    (dict(entry="compact", Q=2, capacity=8), "kernel-window"),
    (dict(entry="gathered"), "kernel-entry"),
])
def test_kernel_spec_violations(change, rule):
    found = check_spec(dataclasses.replace(OK, **change))
    assert rule in {f.rule for f in found if f.severity == ERROR}


def test_kernel_window_entry_has_no_pred_limit():
    # the gathered-window kernel loops over any number of rows
    assert not check_spec(dataclasses.replace(OK, entry="window", P=17))


@pytest.mark.parametrize("entry", ["rows", "compact"])
@pytest.mark.parametrize("change", [dict(P=17), dict(E=17)])
def test_kernel_deep_pass_refuses_what_the_limits_refuse(entry, change):
    spec = dataclasses.replace(OK, entry=entry, capacity=64, **change)
    found = abstract_eval_spec(spec)
    assert [f.rule for f in found] == ["kernel-abstract-eval"]


def test_kernel_limits_mirror_the_cuda_source():
    src = intersect.SOURCE.read_text()
    assert f"#define LE_MAX_DIRS {ops.MAX_DIRS}" in src
    assert f"#define LR_MAX_PREDS {ops.MAX_PREDS}" in src


def _rows_inputs(P, E, B=4):
    z = torch.zeros
    return dict(csrc=z(8, dtype=torch.int32), cstart=z(B, dtype=torch.int32),
                clen=z(B, dtype=torch.int32), flat=z(8, dtype=torch.int32),
                starts=z(P, B, dtype=torch.int32),
                lens=z(P, B, dtype=torch.int32),
                extra=z(B, E, dtype=torch.int32) if E else None)


@pytest.mark.parametrize("P,E", [(17, 0), (2, 17)])
def test_wrappers_refuse_past_the_limits_on_either_route(P, E):
    kw = _rows_inputs(P, E)
    with pytest.raises(ValueError, match="exceed K1's"):
        ops.level_expand_rows(**kw, dirs=(1,) * E, width=2, window=2)
    with pytest.raises(ValueError, match="exceed K1's"):
        ops.level_expand_compact(
            **kw, own=None, rows=torch.zeros(4, dtype=torch.int32),
            offset=torch.zeros((), dtype=torch.int64),
            parent=torch.zeros(9, dtype=torch.int32),
            newcol=torch.zeros(9, dtype=torch.int32), dirs=(1,) * E,
            width=2, window=2)


def test_kernel_deep_pass_reads_no_values():
    # `own` on meta tensors: its range check is the entries' value part
    meta = torch.empty((4,), dtype=torch.int32, device="meta")
    kw = {k: (v.to("meta") if v is not None else None)
          for k, v in _rows_inputs(2, 0).items()}
    assert ops.validate_level_expand_rows(**kw, own=meta, width=2)[:2] \
        == (2, 4)


def test_executor_specs_cover_every_bucket_and_mode(tiny_graph):
    from repro_torch.core.executor import auto_buckets

    cfg = ExecutorConfig(capacity=1 << 12,
                         degree_buckets=((4, 1.0), (8, 0.5)))
    specs = executor_specs(tiny_graph.n, tiny_graph.m,
                           tiny_graph.max_degree, cfg)
    W = tiny_graph.max_degree
    widths = sorted({s.width for s in specs})
    assert widths == sorted({4, 8, W})
    assert {s.mode for s in specs} == {"mask", "count", "signed"}
    assert len(specs) == 4 * len(widths)
    assert all(s.width <= s.window == W for s in specs)
    assert auto_buckets(tiny_graph) is None      # W ≤ 128: one bucket


def test_kernel_graph_contract(tiny_graph):
    assert not has_errors(check_graph_contract(tiny_graph, CFG, deep=True))
    f = check_graph_contract((10**10, 2 * 10**9, 1000))
    assert any(x.rule == "kernel-int32-offset" for x in f)
    # wiki-vote scale with buckets: clean by arithmetic alone
    assert not check_graph_contract(
        (7_115, 103_689, 1_065),
        ExecutorConfig(degree_buckets=((128, 1.0), (1_065, 0.25))))


# ------------------------------------------------- store fsck + CLI
def _warm_store(root, graph, stats):
    engine = QueryEngine(graph, cfg=CFG, store=PlanStore(root),
                         stats=stats, device="cpu")
    tickets = [engine.enqueue(QueryRequest(get_pattern(n), use_iep=iep))
               for n, iep in (("P1", False), ("triangle", False),
                              ("rectangle", True))]
    while engine.pending():
        engine.run_pending(limit=1)
    return [t.result.count for t in tickets]


def _flip_record_pair(vdir):
    for fname in sorted(os.listdir(vdir)):
        if not fname.endswith(".json") or fname.startswith("stats-"):
            continue
        path = os.path.join(vdir, fname)
        with open(path) as f:
            rec = json.load(f)
        rs = rec["plan"]["res_set"]
        if rs:
            rs[0] = [rs[0][1], rs[0][0]]
            with open(path, "w") as f:
                json.dump(rec, f)
            return fname[: -len(".json")]
    raise AssertionError("no record with restrictions")


def test_cli_fsck_flags_and_quarantines_a_tampered_store(
        tmp_path, tiny_graph, tiny_stats, capsys):
    root = str(tmp_path / "plan-store")
    _warm_store(root, tiny_graph, tiny_stats)
    assert cli(["--fsck", root]) == 0
    assert "3 records checked, 0 quarantined" in capsys.readouterr().out
    digest = _flip_record_pair(os.path.join(root, f"v{SCHEMA_VERSION}"))
    assert cli(["--fsck", root]) == 1
    out = capsys.readouterr().out
    assert "1 quarantined" in out and "ERROR" in out
    assert os.path.exists(os.path.join(root, f"v{SCHEMA_VERSION}",
                                       "quarantine", digest + ".json"))
    assert cli(["--fsck", root]) == 0             # clean once quarantined


def test_cli_lint_and_contract_passes_exit_zero(capsys):
    assert cli(["--lint", "--root", str(REPO_ROOT)]) == 0
    assert cli(["--kernel-contracts", "--deep"]) == 0
    assert "0 error(s)" in capsys.readouterr().out


def test_cli_exits_one_on_a_lint_error(tmp_path, capsys):
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text("import ctypes\n")
    assert cli(["--lint", "--root", str(tmp_path)]) == 1
    assert "[kernel-through-ops]" in capsys.readouterr().out


def test_cli_soundness_pass_is_clean(monkeypatch, capsys):
    # the library's plans, on the patterns the tests can afford
    from repro_torch.configs import graphpi

    monkeypatch.setattr(graphpi, "PATTERNS",
                        {k: graphpi.PATTERNS[k] for k in ("P1", "P2")})
    monkeypatch.setattr(graphpi, "EXTRA_PATTERNS",
                        {"triangle": graphpi.EXTRA_PATTERNS["triangle"]})
    assert cli(["--soundness"]) == 0
    assert "error(s)" in capsys.readouterr().out


def test_finding_severity_validated():
    with pytest.raises(ValueError):
        Finding("fatal", "rule", "loc", "msg")
    fs = [Finding(ERROR, "r", "l", "m")]
    assert has_errors(fs) and error_count(fs) == 1
