"""Leaving a process group: no rank aborts at exit, however many
launches share the host.

A gloo group's worker threads are joined only when its backend is
freed; a group still referenced when the interpreter exits is freed
during finalization, and a rank of a torchrun launch then aborts now
and then (SIGABRT, "terminate called without an active exception").
`close_group` waits for every rank, destroys the group and frees it,
and `leaves_group` calls it once the launcher's `main` has returned,
so nothing holds the group any more.  Several two-rank torchrun
launches of this file end as the sharded launchers do, at once; every
rank must see the group freed, and every launch must exit with 0.
"""
import os
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAUNCHES = 4
WORLD = 2
DEADLINE_S = 120


class _Holder:
    """An engine's stand-in: holds the group in a reference cycle."""

    def __init__(self, group):
        self.group = group
        self.me = self


def _main(argv=None):
    """A sharded launcher's `main`: the agreed exit code is the largest
    rank's; the rank exits with 0."""
    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    group, _ = mesh.shared_group("cpu", timeout=60.0, log=None)
    holder = _Holder(group)
    assert mesh.agreed_exit(holder.group, group.rank()) == WORLD - 1
    return 0


def _leave():
    from repro_torch.launch import mesh

    rc = mesh.leaves_group(_main)()
    assert not torch.distributed.is_initialized()
    return rc


def _torchrun():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), __file__], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_concurrent_launches_leave_without_aborting():
    procs = [_torchrun() for _ in range(LAUNCHES)]
    try:
        outs = [p.communicate(timeout=DEADLINE_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # an abort fails the launch with the rank's -6 in torchrun's report
    bad = [(p.returncode, err[-600:]) for p, (_, err) in zip(procs, outs)
           if p.returncode != 0]
    assert not bad, bad
    for _, err in outs:
        assert "terminate called" not in err
        assert "still referenced" not in err


if __name__ == "__main__":
    sys.exit(_leave())
