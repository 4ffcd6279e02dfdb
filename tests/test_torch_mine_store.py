"""`launch.mine --cache-dir` on the CPU: the port's mining CLI persists
its plan in a `PlanStore`, as the reference's does
(`repro/launch/mine.py`), so a repeat invocation skips the
configuration search.  Two runs on tiny-er share one directory: the
second prints "persisted plan" and runs no search, both counts equal
the oracle's, and the record the port writes is field-equal in its body
to the one the reference's `mine --cache-dir` writes for the same
request (the port stores no executable, by design:
tests/test_torch_store.py).
"""
import glob
import json
import os

import pytest
import torch

from repro_torch.launch import mine

torch.set_num_threads(1)

ARGV = ["--pattern", "P1", "--dataset", "tiny-er", "--verify", "--device",
        "cpu"]
BODY = ("schema_version", "mode", "use_iep", "sharded", "pattern", "config",
        "plan")


def _run(cache_dir):
    lines = []
    res = mine.run(mine.parse_args(ARGV + ["--cache-dir", cache_dir]),
                   log=lines.append)
    return res, lines


def _record(cache_dir):
    paths = [p for p in glob.glob(os.path.join(cache_dir, "v*", "*.json"))
             if not os.path.basename(p).startswith("stats-")]
    assert len(paths) == 1, paths
    with open(paths[0]) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mine-store"))
    return d, _run(d), _run(d)


def test_first_run_searches_and_persists(runs):
    d, (res, lines), _ = runs
    assert res.engine.cache.stats.n_searches == 1
    assert any("cache miss" in ln for ln in lines if "config:" in ln)
    assert res.verified and res.result.count == res.expected == 27358
    assert _record(d)["mode"] == "graphpi"


def test_repeat_run_loads_the_persisted_plan(runs):
    _, (first, _), (res, lines) = runs
    assert res.engine.cache.stats.n_searches == 0
    assert res.engine.cache.stats.persist_hits == 1
    assert any("persisted plan" in ln for ln in lines if "config:" in ln)
    assert res.result.count == first.result.count == res.expected
    assert res.verified and res.config == first.config


def test_main_with_cache_dir_exits_zero(runs, capsys):
    d, _, _ = runs
    assert mine.main(ARGV + ["--cache-dir", d]) == 0
    assert "persisted plan" in capsys.readouterr().out


def test_record_body_equals_the_reference_mine(runs, tmp_path):
    pytest.importorskip("jax")
    from repro.launch import mine as rmine

    d, _, _ = runs
    ref_dir = str(tmp_path / "ref")
    assert rmine.main(["--pattern", "P1", "--dataset", "tiny-er",
                       "--verify", "--single-device", "--cache-dir",
                       ref_dir]) == 0
    got, want = _record(d), _record(ref_dir)
    for field in BODY:
        assert got[field] == want[field], field
    assert got["has_executable"] is False
