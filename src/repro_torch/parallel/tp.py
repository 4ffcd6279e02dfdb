"""The grid a serving step runs under, and the collectives the models
call on it.

The reference's layers read the ambient mesh (`get_abstract_mesh`) and
GSPMD inserts the collectives; here a serving step opens `using(Ctx)`
and the layers ask `active()` for it.  Without a context (one device,
training) every model function runs as before and calls nothing here.

Collectives take the model or the data axis's process group from the
grid.  NCCL reduces tensors where they lie.  Gloo (ranks sharing a
card, or on the CPU) gets an fp32 host copy of floating tensors: it
stages CUDA tensors through the host anyway, it refuses some ops on
CUDA tensors (all_gather) and bf16 on some builds, and summing bf16
partials in fp32 rounds once instead of at every step.  A collective
that fails raises; nothing falls back to one rank.  `calls` counts
the collectives by kind (the launchers report a prefill's).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .sharding import Grid


@dataclass(frozen=True)
class Ctx:
    """What a step's layers need to know: the grid, the config, how the
    self-attention cache is split over the model axis (`kv`:
    `sharding.kv_layout`) and whether the batch is split over the data
    axis (the MoE keep decision is then taken over the whole batch)."""

    grid: Grid
    cfg: object
    kv: str = "heads"
    batch_sharded: bool = False

    @property
    def model(self) -> int:
        return self.grid.model

    @property
    def model_rank(self) -> int:
        return self.grid.model_rank


_ACTIVE: list[Ctx] = []
calls = {"all_reduce": 0, "all_max": 0, "all_gather": 0, "gather_batch": 0}


def active() -> Ctx | None:
    """The innermost open context, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def using(ctx: Ctx | None):
    """Run the body under `ctx` (None: no context, the one-device
    path)."""
    if ctx is None:
        yield
        return
    _ACTIVE.append(ctx)
    try:
        yield
    finally:
        _ACTIVE.pop()


def _need() -> Ctx:
    ctx = active()
    if ctx is None:
        raise RuntimeError("a weight split over the model axis used "
                           "outside a serving step's grid")
    return ctx


def _staged(x: torch.Tensor, group):
    """(tensor to hand the backend, how to bring the result back)."""
    if dist.get_backend(group) == "nccl":
        return x.contiguous(), lambda y: y
    dtype, device = x.dtype, x.device
    y = x.detach().to("cpu", torch.float32 if x.is_floating_point()
                      else x.dtype).contiguous()
    return y, lambda z: z.to(device, dtype)


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    y, back = _staged(x, group)
    if y is x:
        y = y.clone()
    dist.all_reduce(y, op=op, group=group)
    return back(y)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    y, back = _staged(x, group)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return back(torch.cat(parts, dim=dim))


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the model axis (a new tensor)."""
    calls["all_reduce"] += 1
    return _reduce(x, _need().grid.model_group, dist.ReduceOp.SUM)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of `x` over the model axis."""
    calls["all_max"] += 1
    return _reduce(x, _need().grid.model_group, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's `x`, concatenated along `dim` in rank order."""
    calls["all_gather"] += 1
    return _gather(x, _need().grid.model_group, dim)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of `x` (dim 0) in rank order, where the
    active step splits the batch; else `x`."""
    ctx = active()
    if ctx is None or not ctx.batch_sharded:
        return x
    calls["gather_batch"] += 1
    return _gather(x, ctx.grid.data_group, 0)
