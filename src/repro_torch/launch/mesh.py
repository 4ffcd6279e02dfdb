"""Process groups for multi-GPU counting: one process per GPU.

Port of `repro/launch/mesh.py`.  The reference builds a JAX mesh over
the devices one controller sees; the port runs one process per GPU
under `torch.distributed` — SPMD ranks that run the same program, as
the hosts of a multi-host JAX mesh do.  `init_group` reads torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``); tests pass
the rank, the world size and a ``file://`` rendezvous instead.

The backend follows one static rule (`backend_rule`), printed by
`init_group`: NCCL when every rank of the node has a card of its own,
gloo when ranks share a card (NCCL refuses two ranks on one device) or
run on the CPU.  Gloo reduces CUDA tensors by staging them through the
host; the sharded matcher reduces two scalars per pass, so that copy is
negligible.

Tensor-parallel serving lays the ranks out on a data × model grid
(`make_grid`, the counterpart of `make_host_mesh`): rank r sits at data
index r // M and model index r % M, and the grid carries the process
groups of its model axis (the M ranks of one data index), its data
axis and all its ranks.  `make_production_grid` is the counterpart of
`make_production_mesh` (the dry-run's 16 x 16 and 2 x 16 x 16 grids),
and `HW` holds the card's rates the roofline divides by.

Functions only: importing this module initializes no group.
"""
from __future__ import annotations

import datetime
import functools
import gc
import os
import sys
import weakref

import torch
import torch.distributed as dist

# Seconds a collective waits for its peers before it raises.  NCCL's
# default is ten minutes, so a rank that dies before a collective would
# hang the others that long.  The wait also covers the imbalance of a
# pass (the fastest rank waits for the slowest in the reduction).
GROUP_TIMEOUT_S = 300.0


def backend_rule(device_type: str, local_world: int,
                 cards: int) -> tuple[str, str]:
    """(backend, reason) for `local_world` ranks on one node with
    `cards` visible cards."""
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    if local_world <= cards:
        return "nccl", (f"{local_world} local rank(s) on {cards} card(s): "
                        "a card each")
    return "gloo", f"{local_world} local ranks share {cards} card(s)"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def launched_sharded(single_device: bool = False) -> bool:
    """Whether a launcher counts sharded: started with more than one rank
    (torchrun's ``WORLD_SIZE``) and not told `--single-device`."""
    return not single_device and _env_int("WORLD_SIZE", 1) > 1


def init_group(device="cuda", *, timeout: float = GROUP_TIMEOUT_S,
               rank: int | None = None, world_size: int | None = None,
               local_rank: int | None = None,
               local_world: int | None = None,
               init_method: str | None = None, log=print):
    """Initialize the default process group; returns ``(group, device)``
    with the rank's device ``cuda:{LOCAL_RANK % device_count}`` (made
    the current card) or the CPU when `device` names it.  Unset
    arguments come from torchrun's environment (rank 0 of 1 without
    it).  Rank 0 logs the backend and the rule that chose it."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already "
                           "initialized in this process")
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = (_env_int("WORLD_SIZE", 1) if world_size is None
                  else world_size)
    local_rank = (_env_int("LOCAL_RANK", rank) if local_rank is None
                  else local_rank)
    local_world = (_env_int("LOCAL_WORLD_SIZE", world_size)
                   if local_world is None else local_world)
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        cards, dev = 0, torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    backend, why = backend_rule(kind, local_world, cards)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    if rank == 0 and log is not None:
        log(f"[group] world={world_size} backend={backend} ({why}); "
            f"timeout {timeout:g}s")
    return dist.group.WORLD, dev


_SHARED: dict[str, tuple] = {}


def shared_group(device="cuda", **kw):
    """The process-wide ``(group, device)`` every sharded tenant of the
    process uses — the counterpart of the reference's
    `shared_host_mesh`.  The first call initializes it (`init_group`,
    same keywords); later calls return it."""
    if "world" not in _SHARED:
        _SHARED["world"] = init_group(device, **kw)
    return _SHARED["world"]


def make_grid(group=None, *, model: int = 1):
    """A data × model `parallel.sharding.Grid` over the ranks of `group`
    (default: the world), in the order of the reference's
    `make_host_mesh` (the devices reshaped to (n // model, model)).
    Creates the model-axis and data-axis subgroups, then one of all the
    grid's ranks (the batch's group under 'dp_replicated'; a
    collective: every rank creates every subgroup, in the same order);
    raises when `model` does not divide the world."""
    from ..parallel.sharding import Grid

    group = dist.group.WORLD if group is None else group
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world of {world} rank(s)")
    ranks = (list(range(world)) if group is dist.group.WORLD else
             [dist.get_global_rank(group, i) for i in range(world)])
    rows = world // model
    kw = dict(backend=dist.get_backend(group),
              timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    model_group = data_group = None
    for d in range(rows):
        g = dist.new_group([ranks[d * model + m] for m in range(model)], **kw)
        if rank // model == d:
            model_group = g
    for m in range(model):
        g = dist.new_group([ranks[d * model + m] for d in range(rows)], **kw)
        if rank % model == m:
            data_group = g
    whole = dist.new_group(ranks, **kw)
    return Grid(("data", "model"), (rows, model), rank=rank,
                model_group=model_group, data_group=data_group, group=whole)


def make_production_grid(*, multi_pod: bool = False):
    """The production grids, for specs alone (no devices, no group):
    (16, 16) over ("data", "model") for one pod, (2, 16, 16) over
    ("pod", "data", "model") for two; the counterpart of the
    reference's `make_production_mesh`."""
    from ..parallel.sharding import grid

    if multi_pod:
        return grid((2, 16, 16), ("pod", "data", "model"))
    return grid((16, 16), ("data", "model"))


# One NVIDIA H100 80GB HBM3 (SXM, 700 W): NVIDIA's data sheet, dense
# rates without sparsity.  Published peaks, not measurements; a card set
# below 700 W runs below them.  The counterpart of the reference's `HW`.
HW = {
    "peak_flops_bf16": 989e12,     # FLOP/s, tensor cores
    "peak_flops_fp32": 67e12,      # FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,             # B/s
    "link_bw": 450e9,              # B/s, NVLink, one way
    "hbm_bytes": 80e9,
}


_GRIDS: dict = {}


def shared_grid(model: int = 1, group=None):
    """The process-wide grid of a model-axis width over `group` (default
    the world): the counterpart of the reference's `shared_host_mesh`,
    so every tenant of a process uses one set of subgroups."""
    group = dist.group.WORLD if group is None else group
    key = (id(group), model)
    if key not in _GRIDS:
        _GRIDS[key] = make_grid(group, model=model)
    return _GRIDS[key]


def close_group() -> bool:
    """Leave the default group and free it (a collective); returns
    whether it was freed.

    `destroy_process_group` leaves gloo's worker threads running: the
    group's backend joins them only when its last reference goes.  A
    group still referenced when the interpreter exits is destroyed
    during finalization, and a rank then aborts now and then (SIGABRT,
    "terminate called without an active exception"), more often the
    more launches share the host.  So every rank waits for the others
    at a barrier, destroys the group, drops this module's references
    and collects, which joins the threads while the interpreter runs.
    That frees the group only when nothing else holds it: launchers
    close it after the engines and matchers that held it are gone
    (`leaves_group`).  A group still held is reported on stderr."""
    _SHARED.clear()
    _DEVICES.clear()
    _GRIDS.clear()
    if not dist.is_initialized():
        return True
    pg = weakref.ref(dist.group.WORLD)
    rank = dist.get_rank()
    dist.barrier()
    dist.destroy_process_group()
    gc.collect()
    if pg() is None:
        return True
    print(f"[group] rank {rank}: the process group is still referenced "
          f"after close; its worker threads outlive it", file=sys.stderr,
          flush=True)
    return False


def leaves_group(main):
    """Wrap a launcher's `main(argv)`: once it returns, close the group
    it opened through `shared_group` (if it did), outside its frame, so
    the objects that held the group are gone (`close_group`)."""
    @functools.wraps(main)
    def wrapped(argv=None):
        rc = main(argv)
        if "world" in _SHARED:
            close_group()
        return rc
    return wrapped


def gather(group, obj) -> list:
    """`obj` from every rank, in rank order (a collective)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast(group, obj, *, src: int = 0):
    """Rank `src`'s `obj` on every rank (a collective; the other ranks'
    `obj` is ignored)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


_DEVICES: dict = {}


def group_devices(group, device) -> tuple:
    """Every rank's device string, in rank order; gathered once per
    group (a collective on the first call), so every rank builds the
    same cache key."""
    if group not in _DEVICES:
        _DEVICES[group] = tuple(gather(group, str(torch.device(device))))
    return _DEVICES[group]


def rank_lines(group, prefix: str, *, wall: float, passes: int,
               launches: dict) -> tuple[list, list]:
    """Gather every rank's counting wall (its seconds before each
    reduction), passes and K1 launches (a collective); returns them in
    rank order with the lines rank 0 prints: one per rank, then the
    balance, max over mean rank wall (the quantity of the paper's
    Fig. 12)."""
    ranks = gather(group, {"wall": wall, "passes": passes,
                           "launches": launches})
    lines = [f"{prefix} rank {r}: wall={st['wall']:.3f}s "
             f"passes={st['passes']} K1 launches "
             + " ".join(f"{k}={v}" for k, v in st["launches"].items())
             for r, st in enumerate(ranks)]
    walls = [st["wall"] for st in ranks]
    mean = sum(walls) / len(walls)
    lines.append(f"{prefix} balance: max/mean rank wall = "
                 f"{max(walls) / mean if mean > 0 else 1.0:.3f} over "
                 f"{len(walls)} ranks")
    return ranks, lines


def agreed_exit(group, rc: int) -> int:
    """The largest exit code over the ranks, so every rank of a launch
    exits with the same code (a collective)."""
    return max(gather(group, int(rc)))
