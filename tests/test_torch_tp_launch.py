"""The tensor-parallel launchers on the CPU: `launch.serve --model-axis
2` under `torchrun --nproc-per-node 2 --device cpu` gives the tokens of
one process, `launch.gateway --model-axis 2` under torchrun gives
`launch.serve`'s, a world the model axis does not divide exits
non-zero, decode checkpoints are written per rank and resume only
under the grid that wrote them, and `launch.train --model-axis 2` in
one process raises (2 does not divide a world of one rank; sharded
training is tests/test_torch_tp_train*.py's).  The launches start together, in two waves (the resumes
need the first wave's checkpoints).
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 240
SERVE = ["-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "16",
         "--gen", "8"]
GATEWAY = ["-m", "repro_torch.launch.gateway", "--device", "cpu",
           "--workload", "smoke", "--model-axis", "2"]


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _start(argv, world=0):
    head = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(world)] if world else [sys.executable])
    return subprocess.Popen(head + argv, cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _wait(procs):
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=TIMEOUT)
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("tp-ckpt"))
    first = _wait({
        "one": _start(SERVE),
        "model2": _start(SERVE + ["--model-axis", "2", "--ckpt-dir", ckpt,
                                  "--ckpt-every", "4"], world=2),
        "gateway": _start(GATEWAY, world=2),
        "world3": _start(SERVE + ["--model-axis", "2"], world=3),
        "no-world": _start(SERVE + ["--model-axis", "2"]),
    })
    second = _wait({
        "resume2": _start(SERVE + ["--model-axis", "2", "--ckpt-dir", ckpt,
                                   "--resume"], world=2),
        "resume1": _start(SERVE + ["--ckpt-dir", ckpt, "--resume"]),
    })
    return {**first, **second}


def _tokens(out, prefix):
    m = re.search(rf"\[{prefix}\] (?:lm )?sample tokens\[0,:16\] = "
                  rf"(\[[\d, ]*\])", out)
    assert m, out[-2000:]
    return m.group(1)


def test_serve_model_axis_2_gives_the_tokens_of_one_process(runs):
    rc, out, err = runs["model2"]
    assert rc == 0, err[-3000:]
    assert _tokens(out, "serve") == _tokens(runs["one"][1], "serve")
    assert "[serve] grid data=1 model=2 over 2 ranks" in out
    assert len(re.findall(r"\[serve\] rank \d: K4 launches=0 ", out)) == 2
    assert "still referenced" not in err


def test_gateway_model_axis_2_gives_the_tokens_of_serve(runs):
    rc, out, err = runs["gateway"]
    assert rc == 0, err[-3000:]
    assert _tokens(out, "gateway") == _tokens(runs["one"][1], "serve")
    assert "lm: 8/8 steps" in out


@pytest.mark.parametrize("name", ["world3", "no-world"])
def test_a_model_axis_that_does_not_divide_the_world_exits_non_zero(
        runs, name):
    rc, out, err = runs[name]
    assert rc != 0
    assert "does not divide" in err or "needs a world" in err, err[-2000:]


def test_checkpoints_resume_only_under_their_grid(runs, tmp_path_factory):
    rc, out, err = runs["resume2"]
    assert rc == 0, err[-3000:]
    assert "[serve] resumed from checkpoint step 8" in out
    rc, out, err = runs["resume1"]
    assert rc != 0
    assert "another grid" in err, err[-2000:]


def test_train_model_axis_2_still_raises():
    """In one process (a world of one rank) `--model-axis 2` raises: 2
    does not divide the world."""
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="does not divide the world of 1"):
        train.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                    "--model-axis", "2"])
