"""Helpers for the port's multi-rank tests on the CPU: spawn `world`
gloo ranks with a ``file://`` rendezvous and join them under a deadline.

`fn(rank, world, rdv, *args)` runs in each spawned process (it must be
importable by name, so it lives at module level of a test file); it
calls `init_rank` first.  A rank that raises fails the whole spawn (the
others are terminated), and ranks past their deadline are killed and
fail the join, so a hang never eats the suite's time limit."""
import os
import time

import torch
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 240.0
GROUP_TIMEOUT_S = 60.0


def init_rank(rank, world, rdv, device="cpu"):
    """One CPU thread, then the group (the backend rule's choice: gloo
    on the CPU or for ranks sharing a card); returns (group, device)."""
    from repro_torch.launch.mesh import init_group

    torch.set_num_threads(1)
    return init_group(device, rank=rank, world_size=world,
                      local_rank=rank, local_world=world,
                      init_method=f"file://{rdv}", timeout=GROUP_TIMEOUT_S,
                      log=None)


def start_ranks(fn, world, tmp_path, *args, timeout=JOIN_TIMEOUT_S):
    """Start `fn` on `world` spawned ranks; returns the handle that
    `join_ranks` waits on."""
    rdv = os.path.join(str(tmp_path), f"rdv-{world}-{time.monotonic_ns()}")
    ctx = mp.start_processes(fn, args=(world, rdv, *args), nprocs=world,
                             join=False, start_method="spawn")
    return ctx, world, time.monotonic() + timeout


def join_ranks(handle) -> None:
    """Wait for the ranks of `start_ranks`; raises if any rank failed or
    they outlive their deadline (then they are killed)."""
    ctx, world, deadline = handle
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running past "
                                   f"their deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)


def spawn_ranks(fn, world, tmp_path, *args, timeout=JOIN_TIMEOUT_S):
    """`start_ranks`, then `join_ranks`."""
    join_ranks(start_ranks(fn, world, tmp_path, *args, timeout=timeout))
