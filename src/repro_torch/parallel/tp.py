"""The grid a serving or training step runs under, and the collectives
the models call on it.

The reference's layers read the ambient mesh (`get_abstract_mesh`) and
GSPMD inserts the collectives, forward and backward; here a step opens
`using(Ctx)` and the layers ask `active()` for it.  Without a context
(one device) every model function runs as before and calls nothing
here.

Collectives take the model or the data axis's process group from the
grid.  NCCL (and any backend but gloo: the dry-run's `fake` group on
`meta` tensors) reduces tensors where they lie.  Gloo (ranks sharing a
card, or on the CPU) gets an fp32 host copy of floating tensors: it
stages CUDA tensors through the host anyway, it refuses some ops on
CUDA tensors (all_gather) and bf16 on some builds, and summing bf16
partials in fp32 rounds once instead of at every step.  A collective
that fails raises; nothing falls back to one rank.

Autograd passes through every collective.  Its backward rule depends
on what reads the result, so each call site names it (Megatron's f and
g operators, and ZeRO-3's gather):

    collective         forward                 backward
    copy_in            identity                all_reduce SUM (model)
    all_reduce         all_reduce SUM (model)  identity, or SUM where
                                               split work reads it
    all_gather         all_gather (model)      this rank's block
    gather_data        all_gather (data)       reduce-scatter SUM (data)

`copy_in` stands before a column-parallel product (its input's
gradient is partial on each rank) and on a weight that every model
rank holds whole but reads only in part (its gradient is partial:
whole wk / wv, the q / k norms, Mamba's B/C columns).  `all_max` and
`gather_batch` carry no gradient.  `calls` counts the collectives by
kind, backward ones included, and `moved` their bytes (the launchers
report them).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .sharding import Grid


@dataclass(frozen=True)
class Ctx:
    """What a step's layers need to know: the grid, the config, how the
    self-attention cache is split over the model axis (`kv`:
    `sharding.kv_layout`), which ranks split the batch (`rows`:
    `sharding.batch_split`, "data", "grid" or None; the MoE keep
    decision is then taken over the whole batch, and the loss is the
    whole batch's mean) and, in training under ZeRO-3, `zero`: a tree
    like the params holding, per leaf, the dim its rank holds a
    data-axis block of (None: whole)."""

    grid: Grid
    cfg: object
    kv: str = "heads"
    rows: str | None = None
    zero: Any = None

    @property
    def model(self) -> int:
        return self.grid.model

    @property
    def model_rank(self) -> int:
        return self.grid.model_rank

    @property
    def rows_group(self):
        """The process group of the ranks that split the batch."""
        return self.grid.group if self.rows == "grid" else self.grid.data_group

    @property
    def rows_rank(self) -> int:
        """This rank's block of the batch."""
        return self.grid.rank if self.rows == "grid" else self.grid.data_rank


_ACTIVE: list[Ctx] = []
KINDS = ("all_reduce", "all_max", "all_gather", "gather_batch",
         "gather_data", "reduce_scatter")
calls = dict.fromkeys(KINDS, 0)
moved = dict.fromkeys(KINDS, 0)


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
                           "outside a serving or training step's grid")
    return ctx


def _count(kind: str, x: torch.Tensor) -> None:
    calls[kind] += 1
    moved[kind] += x.numel() * x.element_size()


def _staged(x: torch.Tensor, group):
    """(tensor to hand the backend, how to bring the result back): a
    host copy under gloo, the tensor itself under any other backend."""
    if dist.get_backend(group) != "gloo":
        return x.contiguous(), lambda y: y
    dtype, device = x.dtype, x.device
    y = x.detach().to("cpu", torch.float32 if x.is_floating_point()
                      else x.dtype).contiguous()
    return y, lambda z: z.to(device, dtype)


def _reduce(x: torch.Tensor, group, op, kind="all_reduce") -> torch.Tensor:
    _count(kind, x)
    y, back = _staged(x.detach(), group)
    if y.data_ptr() == x.data_ptr():        # reduce a copy, not `x`
        y = y.clone()
    dist.all_reduce(y, op=op, group=group)
    return back(y)


def _gather(x: torch.Tensor, group, dim: int, kind: str) -> torch.Tensor:
    _count(kind, x)
    y, back = _staged(x.detach(), group)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return back(torch.cat(parts, dim=dim))


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of `x` along `dim` (the group's ranks hold
    equal blocks in rank order)."""
    n = dist.get_world_size(group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """`x` summed over the group, this rank's block along `dim`.  NCCL
    (and any backend but gloo) reduce-scatters; gloo has no
    reduce-scatter, so it all_reduces and keeps the block."""
    if dist.get_backend(group) == "gloo":
        return _block(_reduce(x, group, dist.ReduceOp.SUM, "reduce_scatter"),
                      group, dim)
    _count("reduce_scatter", x)
    n = dist.get_world_size(group)
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _live(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, part):
        ctx.group, ctx.part = group, part
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.part is None:
            return _reduce(g, ctx.group, dist.ReduceOp.SUM), None, None
        dim, lo, hi = ctx.part
        g = g.clone()
        piece = g.narrow(dim, lo, hi - lo)
        piece.copy_(_reduce(piece, ctx.group, dist.ReduceOp.SUM))
        return g, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op, summed):
        ctx.group, ctx.summed = group, summed
        return _reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _reduce(g, ctx.group, dist.ReduceOp.SUM)
        return g, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.group, ctx.dim, ctx.kind = group, dim, kind
        return _gather(x, group, dim, kind)

    @staticmethod
    def backward(ctx, g):
        if ctx.kind == "gather_data":
            return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return _block(g, ctx.group, ctx.dim), None, None, None


def copy_in(x: torch.Tensor, part=None) -> torch.Tensor:
    """Copy into the model axis: `x` itself forward; its gradient summed
    over the model axis backward (`part` = (dim, lo, hi): only that
    slice of it).  A no-op without a split grid or a gradient."""
    ctx = active()
    if ctx is None or ctx.model == 1 or not _live(x):
        return x
    return _CopyIn.apply(x, ctx.grid.model_group, part)


def all_reduce(x: torch.Tensor, *, summed: bool = False) -> torch.Tensor:
    """`x` summed over the model axis (a new tensor).  Backward: the
    gradient as it is (replicated work reads the sum: it is whole on
    every rank) or, with `summed`, summed over the model axis (each
    rank's split work reads it)."""
    return _AllReduce.apply(x, _need().grid.model_group, dist.ReduceOp.SUM,
                            summed)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of `x` over the model axis (no
    gradient)."""
    return _reduce(x.detach(), _need().grid.model_group, dist.ReduceOp.MAX,
                   "all_max")


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's `x`, concatenated along `dim` in rank order;
    backward, this rank's block of the (whole, replicated) gradient."""
    return _AllGather.apply(x, _need().grid.model_group, dim, "all_gather")


def gather_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """ZeRO-3's gather of a parameter block: every data rank's block of
    `x` along `dim`, in rank order; backward, the gradient summed over
    the data axis, this rank's block of it."""
    return _AllGather.apply(x, _need().grid.data_group, dim, "gather_data")


def gathered(tree, dims):
    """`tree` (a layer's params) with each leaf whose `dims` entry is a
    dim gathered over the data axis there (`dims` None: as it is)."""
    if dims is None:
        return tree
    if isinstance(tree, dict):
        return {k: gathered(v, dims[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gathered(v, d) for v, d in zip(tree, dims)]
    return gather_data(tree, dims)


def zero_of(*path):
    """The active step's ZeRO-3 dims below `path` of the params tree
    (None without ZeRO-3)."""
    ctx = active()
    node = None if ctx is None else ctx.zero
    for k in path:
        if node is None:
            return None
        node = node[k]
    return node


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks that split the batch (`Ctx.rows`: the
    data axis, or every rank under 'dp_replicated') where the active
    step splits it, else `x` (no gradient: counts, reported losses, the
    gradients of whole leaves)."""
    ctx = active()
    if ctx is None or ctx.rows is None:
        return x
    return _reduce(x.detach(), ctx.rows_group, dist.ReduceOp.SUM)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every row block of `x` (dim 0) in the order of the ranks that
    split the batch, where the active step splits it; else `x` (no
    gradient: the MoE's routing indices, the served logits)."""
    ctx = active()
    if ctx is None or ctx.rows is None:
        return x
    return _gather(x.detach(), ctx.rows_group, 0, "gather_batch")


def whole(x: torch.Tensor, piece, grid: Grid) -> torch.Tensor:
    """The whole leaf from every rank's `piece` of it
    (`sharding.Piece`; `x` is this rank's block): gathered over the
    data axis, then over the model axis into each model rank's
    indices.  A collective over the grid, with no gradient (what a
    checkpoint writes)."""
    x = x.detach()
    if piece.data is not None:
        x = _gather(x, grid.data_group, piece.data, "gather_data")
    if piece.model is None:
        return x
    dim, idx = piece.model
    parts = _gather(x.unsqueeze(0), grid.model_group, 0, "all_gather")
    where = [idx(r).to(x.device) for r in range(grid.model)]
    shape = list(x.shape)
    shape[dim] = max(int(i.max()) for i in where) + 1
    out = x.new_zeros(shape)
    for i, part in zip(where, parts):
        out.index_copy_(dim, i, part)
    return out
