"""The port's training launcher on the CPU: `python -m
repro_torch.launch.train --device cpu --smoke`, its resume (a port of
tests/test_checkpoint.py::test_train_resume_continues_stream, within
the reference's tolerance), preemption by SIGTERM / SIGINT (a
checkpoint, exit 0), and its refusals: `--model-axis` other than 1
and `--device cuda` without a card raise."""
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.launch.train import main as train_main
from repro_torch.train import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMMON = ["--arch", "qwen3-1.7b", "--smoke", "--batch", "2", "--seq", "16",
          "--device", "cpu"]
STEP_LINE = re.compile(r"^step (\d+)/(\d+) loss=([\d.]+) gnorm=([\d.]+) "
                       r"lr=([\d.e+-]+) tok/s=(\d+)$", re.M)

torch.set_num_threads(1)


def test_smoke_run_prints_the_reference_lines(capsys, tmp_path):
    rc = train_main(COMMON + ["--steps", "6", "--log-every", "2",
                              "--ckpt-dir", str(tmp_path), "--ckpt-every",
                              "4"])
    out = capsys.readouterr().out
    assert rc == 0 and "[train] done" in out
    lines = STEP_LINE.findall(out)
    assert [int(s) for s, *_ in lines] == [2, 4, 6]
    assert all(np.isfinite(float(x)) for _, _, x, *_ in lines)
    assert ckpt.latest_step(str(tmp_path)) == 6
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_4", "step_6"]


def _leaves(d):
    man = json.load(open(os.path.join(d, "step_8", "manifest.json")))
    return {m["path"]: np.load(os.path.join(d, "step_8", m["file"]))
            for m in man["leaves"]}


def test_train_resume_continues_stream(tmp_path, capsys):
    """Train 4 steps, stop, resume to 8: the same params and optimizer
    state as an uninterrupted 8-step run (checkpoint + deterministic
    data pipeline)."""
    common = COMMON + ["--log-every", "100"]
    d1 = str(tmp_path / "interrupted")
    train_main(common + ["--steps", "4", "--ckpt-dir", d1, "--ckpt-every",
                         "4"])
    train_main(common + ["--steps", "8", "--ckpt-dir", d1, "--ckpt-every",
                         "4"])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    d2 = str(tmp_path / "straight")
    train_main(common + ["--steps", "8", "--ckpt-dir", d2, "--ckpt-every",
                         "8"])
    l1, l2 = _leaves(d1), _leaves(d2)
    assert l1.keys() == l2.keys()
    assert {"o/step", "p/embed/w", "o/m/embed/w"} <= l1.keys()
    for k in l1:
        np.testing.assert_allclose(l1[k], l2[k], rtol=2e-5, atol=2e-6,
                                   err_msg=k)
    assert int(l1["o/step"]) == 8


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT],
                         ids=["SIGTERM", "SIGINT"])
def test_preemption_checkpoints_and_exits_cleanly(sig, tmp_path):
    """A signal mid-run: the launcher finishes the step, writes a
    checkpoint of {"p", "o"} and exits 0; a rerun resumes from it."""
    d = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *COMMON,
           "--steps", "100000", "--log-every", "1", "--ckpt-dir", d,
           "--ckpt-every", "100000"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env,
                            cwd=str(ROOT))
    try:
        deadline = time.monotonic() + 120
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("step 3/"):
                proc.send_signal(sig)
                break
            assert time.monotonic() < deadline, "no step line in time"
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0, "".join(seen) + out
    m = re.search(r"\[train\] preempted at step (\d+); checkpointed", out)
    assert m, out
    step = int(m.group(1))
    assert step >= 3 and ckpt.latest_step(d) == step
    man = json.load(open(os.path.join(d, f"step_{step}", "manifest.json")))
    paths = {leaf["path"] for leaf in man["leaves"]}
    assert {"p/embed/w", "o/m/embed/w", "o/v/embed/w", "o/step"} <= paths
    # a rerun picks the run up where the signal stopped it
    rc = train_main(COMMON + ["--steps", str(step + 1), "--ckpt-dir", d,
                              "--log-every", "100"])
    assert rc == 0 and ckpt.latest_step(d) == step + 1


def test_model_axis_other_than_one_raises():
    """One process is a world of one rank: a model axis of 2 does not
    divide it (sharded training runs under torchrun)."""
    with pytest.raises(ValueError, match="does not divide the world"):
        train_main(COMMON + ["--steps", "1", "--model-axis", "2"])


def test_cuda_without_a_card_raises():
    """No fallback: the default device is the card, and without one the
    launcher raises before it trains."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = [a for a in COMMON if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(argv + ["--steps", "1"])
