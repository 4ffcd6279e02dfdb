"""The port's examples run on the CPU (`--device cpu`): the counting
ones print each count beside the oracle's, as the reference's examples
do; the serving one generates tokens."""
import importlib.util
import pathlib
import re

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _run(name, capsys):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    return capsys.readouterr().out


@pytest.mark.parametrize("name,want", [("torch_quickstart.py", 27_358),
                                       ("torch_motif_counting_iep.py", 612)])
def test_example_counts_equal_the_oracle(name, want, capsys):
    out = _run(name, capsys)
    counts = [int(c) for c in re.findall(r"(?m)(?:^|: +)count\s*=\s*(\d+)",
                                         out)]
    assert counts and set(counts) == {want}
    assert f"oracle = {want}" in out
    assert "count == oracle" in out


def test_serve_lm_example_serves_the_moe_config(capsys):
    """`examples/torch_serve_lm.py --device cpu`: granite-moe's reduced
    config through LMSession, 16 steps in batches of 4."""
    out = _run("torch_serve_lm.py", capsys)
    assert "granite-moe-1b-a400m [moe] 2 layers, 4 experts top-2" in out
    assert "prefill: 4x32 tokens" in out and "K4 launches=0" in out
    assert "decoded 16/16 steps" in out
    assert re.search(r"sample tokens\[0,:8\] = \[(\d+, ){7}\d+\]", out)


def test_train_lm_example_trains_and_resumes(capsys, tmp_path):
    """`examples/torch_train_lm.py --device cpu`: the reduced qwen3
    config through `launch.train`, checkpointed; a second run with more
    steps resumes from the first's last step."""
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", EXAMPLES / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path)]
    assert mod.main(argv + ["--steps", "10"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^step 10/10 loss=[\d.]+ gnorm=", out, re.M)
    assert "[train] done" in out
    assert mod.main(argv + ["--steps", "20"]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 10" in out
    assert re.search(r"^step 20/20 loss=", out, re.M)
