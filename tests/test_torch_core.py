"""Port parity, plan side: repro_torch's copies of the numpy-only modules
give the reference's restriction sets, schedules, searched
configurations, plan records, canonical keys and graph fingerprints on
the same inputs — and the port never reaches for JAX or the reference.

Every compared value is an integer, a tuple or a string: no tolerance.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.graphpi import EXTRA_PATTERNS, PATTERNS
from repro.core.config_search import (config_to_dict, graphzero_configuration,
                                      search_configuration)
from repro.core.perf_model import GraphStats
from repro.core.plan import best_iep_k, build_plan, plan_to_dict
from repro.core.restrictions import generate_restriction_sets
from repro.core.schedule import generate_schedules
from repro.graph.datasets import named_dataset
from repro.query.canon import canonical_key

import repro_torch.configs.graphpi as t_graphpi
import repro_torch.core.config_search as t_search
import repro_torch.core.perf_model as t_perf
import repro_torch.core.plan as t_plan
import repro_torch.core.restrictions as t_restr
import repro_torch.core.schedule as t_sched
import repro_torch.graph.datasets as t_data
import repro_torch.query.canon as t_canon
from repro_torch.convert import graph_from_arrays, plan_from_reference
from repro_torch.core.pattern import Pattern as TPattern

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

NAMES = sorted(PATTERNS) + sorted(EXTRA_PATTERNS) + ["P1-labeled"]
# P1 (house) with labels on the rectangle, wildcard apex
P1_LABELS = (0, 1, 0, 1, None)


def _ref_pattern(name):
    if name == "P1-labeled":
        return PATTERNS["P1"].with_labels(P1_LABELS)
    return PATTERNS.get(name) or EXTRA_PATTERNS[name]


def _port_pattern(name):
    if name == "P1-labeled":
        return t_graphpi.get_pattern("P1").with_labels(P1_LABELS)
    return t_graphpi.get_pattern(name)


STATS = dict(n_vertices=256, n_edges=1991, tri_cnt=643)   # tiny-er


@pytest.mark.parametrize("name", NAMES)
def test_patterns_equal(name):
    r, t = _ref_pattern(name), _port_pattern(name)
    assert (t.n, t.edges, t.labels, t.name) == (r.n, r.edges, r.labels,
                                                r.name)
    assert t.aut_count() == r.aut_count()
    assert t.to_dict() == r.to_dict()


@pytest.mark.parametrize("name", NAMES)
def test_restriction_sets_equal(name):
    # the configuration search's own cap (config_search.py); uncapped,
    # clique5 alone takes half a minute
    assert (t_restr.generate_restriction_sets(_port_pattern(name),
                                              max_sets=64)
            == generate_restriction_sets(_ref_pattern(name), max_sets=64))


@pytest.mark.parametrize("name", NAMES)
def test_schedules_equal(name):
    assert (t_sched.generate_schedules(_port_pattern(name))
            == generate_schedules(_ref_pattern(name)))


@pytest.mark.parametrize("name", NAMES)
def test_plan_to_dict_equal(name):
    """First schedule × first restriction set, IEP folded where sound;
    the reference's record also rebuilds the same port plan."""
    r, t = _ref_pattern(name), _port_pattern(name)
    order = generate_schedules(r)[0]
    rs = generate_restriction_sets(r, max_sets=1)[0]
    k = best_iep_k(r, order, rs)
    assert t_plan.best_iep_k(t, order, rs) == k
    want = plan_to_dict(build_plan(r, order, rs, iep_k=k))
    tp = t_plan.build_plan(t, order, rs, iep_k=k)
    assert t_plan.plan_to_dict(tp) == want
    assert plan_from_reference(want) == tp


@pytest.mark.parametrize("name", NAMES)
def test_canonical_key_equal(name):
    r, t = _ref_pattern(name), _port_pattern(name)
    assert t_canon.canonical_key(t) == canonical_key(r)
    assert (t_canon.canonical_form(t).to_dict()
            == t_canon.canonical_form(TPattern.from_dict(r.to_dict()))
            .to_dict())


@pytest.mark.parametrize("name,use_iep", [
    (p, iep) for p in sorted(PATTERNS) for iep in (False, True)
    if not (iep and p in ("P3", "P5", "P6"))   # the slowest searches
] + [("P1-labeled", False)])
def test_best_configuration_equal(name, use_iep):
    want = search_configuration(_ref_pattern(name), GraphStats(**STATS),
                                use_iep=use_iep).best
    got = t_search.search_configuration(
        _port_pattern(name), t_perf.GraphStats(**STATS),
        use_iep=use_iep).best
    assert t_search.config_to_dict(got) == config_to_dict(want)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_graphzero_configuration_equal(name):
    want = graphzero_configuration(_ref_pattern(name), GraphStats(**STATS),
                                   use_iep=True)
    got = t_search.graphzero_configuration(
        _port_pattern(name), t_perf.GraphStats(**STATS), use_iep=True)
    assert t_search.config_to_dict(got) == config_to_dict(want)


@pytest.mark.parametrize("dataset", ["tiny-er", "small-rmat", "tiny-labeled"])
def test_graph_fingerprint_equal(dataset):
    r = named_dataset(dataset)
    t = t_data.named_dataset(dataset)
    assert t.fingerprint == r.fingerprint
    assert (t.n, t.m, t.max_degree) == (r.n, r.m, r.max_degree)
    c = graph_from_arrays(r.indptr, r.indices, r.degrees, r.labels,
                          name=r.name)
    assert c.fingerprint == r.fingerprint
    if r.labels is not None:
        np.testing.assert_array_equal(c.label_view.flat, r.label_view.flat)


def test_graph_from_arrays_rejects_inconsistent_degrees():
    r = named_dataset("tiny-er")
    bad = r.degrees.copy()
    bad[0] += 1
    with pytest.raises(ValueError, match="indptr"):
        graph_from_arrays(r.indptr, r.indices, bad)


# Copied modules must stay equal to their originals: same code once
# docstrings are set aside (the copies' docstrings name the port).
COPIES = ["core/pattern.py", "core/restrictions.py", "core/schedule.py",
          "core/iep.py", "core/plan.py", "core/perf_model.py",
          "core/config_search.py", "core/oracle.py", "graph/datasets.py",
          "configs/graphpi.py", "query/canon.py", "obs/metrics.py",
          "obs/trace.py", "analysis/findings.py", "analysis/soundness.py",
          "live/epoch.py", "live/compaction.py", "live/overlay.py"]


def _code_dump(path: pathlib.Path) -> str:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], "value", None), ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    assert (_code_dump(SRC / "repro_torch" / rel)
            == _code_dump(SRC / "repro" / rel))


def test_graph_view_matches_original():
    """`graph/csr.py` is not a copy (its device views differ), but its
    `GraphView` class is: the same code once docstrings are set aside."""
    def view(path):
        tree = ast.parse(path.read_text())
        node = next(n for n in tree.body
                    if isinstance(n, ast.ClassDef) and n.name == "GraphView")
        for sub in ast.walk(node):
            body = getattr(sub, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(getattr(body[0], "value", None),
                                   ast.Constant)
                    and isinstance(body[0].value.value, str)):
                sub.body = body[1:] or [ast.Pass()]
        return ast.dump(node)

    assert (view(SRC / "repro_torch" / "graph" / "csr.py")
            == view(SRC / "repro" / "graph" / "csr.py"))


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, repro_torch, repro_torch.core.executor, "
            "repro_torch.launch.mine, repro_torch.kernels.ops, "
            "repro_torch.convert, repro_torch.analysis, repro_torch.live, "
            "repro_torch.query.store, repro_torch.serve.rpc, "
            "repro_torch.launch.query_serve, repro_torch.launch.gateway, "
            "repro_torch.launch.plan_warmup; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_resolve_device_refuses_cuda_without_card(monkeypatch):
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
