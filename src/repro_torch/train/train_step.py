"""Train-step construction: loss and gradients, then the AdamW update.

Counterpart of `repro/train/train_step.py`, with its microbatch
gradient accumulation, activation remat, query-chunked attention and
sequence-chunked loss.  Parameters are fp32 masters, updated in place
(the reference donates them).

On one device the step takes the whole tree.  Under a data × model
grid (`launch.mesh.make_grid`; one process per rank) it takes the
layout `pick_layout` gives, as the reference's does (or the one it is
told).  Under 'tp2d', tensor parallelism over the model axis and
ZeRO-3 over the data axis; under 'dp_replicated', every leaf whole on
every rank and the batch split over every rank.  A rank holds its
`sharding.Piece` of every leaf, of its gradient and of its AdamW
moments (`opt_state_shardings`: m and v mirror the params, the step is
replicated): the intersection of its model-axis part and its block of
the leaf's DP dim.  The step keeps the rank's rows of the global batch
(`sharding.local_batch`) and runs the loss under `parallel.tp`: each
layer gathers its leaves over the data axis inside the rematerialized
layer (backward: their gradient reduce-scattered over it), the
collectives of the model axis pass gradients as `parallel.tp` says,
the loss is the rank's share of the whole batch's mean, and the leaves
the data axis leaves whole have their gradient summed over the ranks
that split the batch (each row counted once: the model ranks of a data
index that hold the same rows do not add theirs).  The global norm
counts each element of the whole gradient once
(`optimizer.global_norm`), and AdamW runs elementwise on the blocks.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..models import transformer as T
from ..parallel import tp
from ..parallel.sharding import (batch_split, in_order_of, local_batch,
                                 map_leaves, opt_state_shardings,
                                 pick_layout, train_pieces)
from .optimizer import AdamWConfig, adamw_update, global_norm, init_opt_state
from .tree import leaves, unflatten


@dataclass(frozen=True)
class TrainOptions:
    remat: bool = True
    q_chunk: int = 1024          # query chunking for long-seq attention
    loss_chunk: int = 1024       # sequence chunking for the vocab softmax
    accum_steps: int = 1         # microbatch gradient accumulation


def _needs_chunk(cfg, batch_shape, opts) -> bool:
    leaf = batch_shape.get("tokens", batch_shape.get("embeds"))
    S = leaf.shape[1]
    return bool(opts.q_chunk) and S >= 2 * opts.q_chunk


def _grads(loss, params, batch):
    """(loss, metrics, grads like `params`) of one batch; a leaf the loss
    does not reach (the embedding under a stub frontend) gets zeros, as
    in JAX."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    l, metrics = loss(params, batch)
    gs = torch.autograd.grad(l, ps, allow_unused=True)
    grads = unflatten(params, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(ps, gs)])
    return l.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def pieces_of(cfg, grid, layout: str | None = None):
    """The `sharding.Piece` of every param leaf on `grid` under
    `layout` (default `pick_layout`'s)."""
    layout = layout or pick_layout(cfg, grid)
    return train_pieces(cfg, abstract_params(cfg), grid, layout)


def state_pieces(cfg, grid, layout: str | None = None):
    """Pieces of a {"p": params, "o": opt_state} tree (what `launch.train`
    checkpoints): the moments mirror the params, the step is whole."""
    pieces = pieces_of(cfg, grid, layout)
    return {"p": pieces, "o": opt_state_shardings(None, pieces, grid)}


def make_train_step(cfg, opt_cfg: AdamWConfig, opts: TrainOptions, *,
                    device="cuda", grid=None, layout: str | None = None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), `params` and `opt_state` updated in place.  `batch` is
    moved to `device` (a CUDA device raises without a card).

    With `accum_steps` A > 1 the batch splits into A microbatches along
    its leading axis; the gradients are summed in fp32 and divided by A,
    the loss is the mean of the microbatch losses, and
    `metrics["tokens"]` is 0, as in the reference.  Attention chunks its
    queries by `q_chunk` where the sequence is at least twice that
    (`_needs_chunk`, decided on the batch's shape).

    With `grid`, `params` and `opt_state` hold this rank's pieces
    under `layout` (default `pick_layout`'s; `init_train_state(...,
    grid=)`), `batch` is the global batch, and the metrics are the
    whole batch's, equal on every rank (see the module).  A global
    batch that the axes the layout splits it over do not divide raises.
    The step also carries `step.gradients(params, batch)` -> (loss,
    metrics, this rank's gradient blocks) and `step.pieces`."""
    device = resolve_device(device)
    losses = {}
    if grid is not None:
        layout = layout or pick_layout(cfg, grid)
    pieces = None if grid is None else pieces_of(cfg, grid, layout)
    zero = (None if pieces is None or grid.data == 1 else
            map_leaves(lambda _, p: p.data, pieces))

    def loss_for(batch):
        q = opts.q_chunk if _needs_chunk(cfg, batch, opts) else 0
        if q not in losses:
            losses[q] = T.loss_fn(cfg, remat=opts.remat, q_chunk=q,
                                  loss_chunk=opts.loss_chunk)
        return losses[q]

    def grads_of(params, batch):
        loss = loss_for(batch)
        if opts.accum_steps <= 1:
            return _grads(loss, params, batch)
        A = opts.accum_steps
        micro = {k: v.reshape((A, v.shape[0] // A) + v.shape[1:])
                 for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves(params)]
        tot = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(A):
            l, _, g = _grads(loss, params, {k: v[i] for k, v in micro.items()})
            for a, gi in zip(acc, leaves(g)):
                a.add_(gi)
            tot = tot + l
        g = unflatten(params, [a / A for a in acc])
        l = tot / A
        return l, {"loss": l, "tokens": torch.zeros((), device=device)}, g

    def gradients(params, batch):
        batch = {k: v.to(device) for k, v in batch.items()}
        if grid is None:
            return grads_of(params, batch)
        B = next(iter(batch.values())).shape[0]
        lo, n = local_batch(B, grid, layout)
        split = batch_split(B, grid, layout)
        over = grid.size if layout == "dp_replicated" else grid.data
        if over > 1 and split is None:
            raise ValueError(f"a batch of {B} rows splits over none of the "
                             f"axes the {layout!r} layout splits it over "
                             f"(data {grid.data}, model {grid.model})")
        ctx = tp.Ctx(grid, cfg, rows=split, zero=zero)
        with tp.using(ctx):
            l, metrics, g = grads_of(params, {k: v[lo:lo + n]
                                              for k, v in batch.items()})
            _sum_whole_over_data(g, in_order_of(g, pieces))
            l = tp.data_sum(l)
        return l, {**metrics, "loss": l}, g

    def step(params, opt_state, batch):
        l, metrics, g = gradients(params, batch)
        gnorm = (None if grid is None else global_norm(
            g, pieces=in_order_of(g, pieces), grid=grid))
        params, opt_state, om = adamw_update(opt_cfg, g, opt_state, params,
                                             gnorm=gnorm)
        return params, opt_state, {**metrics, **om}

    step.gradients = gradients
    step.pieces = pieces
    return step


def _sum_whole_over_data(grads, pieces) -> None:
    """Sum, in place over the ranks that split the batch (the data axis,
    or every rank under 'dp_replicated'), the gradients of the leaves
    the data axis leaves whole (every such rank holds them and saw its
    own rows), in one flat fp32 buffer (the blocks of the split leaves
    came back summed from their gathers' backward).  Runs under the
    step's context."""
    if tp.active().rows is None:
        return
    whole = [g for p, g in zip(leaves(pieces), leaves(grads))
             if p.data is None]
    if not whole:
        return
    flat = tp.data_sum(torch.cat([g.reshape(-1).float() for g in whole]))
    at = 0
    with torch.no_grad():
        for g in whole:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()


def abstract_params(cfg):
    """The params tree of `cfg` on the `meta` device: shapes and dtypes,
    no storage (what a checkpoint restores into)."""
    return T.init(cfg, 0, "meta")


def init_train_state(cfg, *, seed: int = 0, device="cuda", grid=None,
                     layout: str | None = None):
    """fp32 master params from `seed` (`models.transformer.init`) and a
    zeroed optimizer state, on `device`.  With `grid`, this rank's
    pieces under `layout` (default `pick_layout`'s): every rank draws
    the same whole masters part by part and keeps its piece of each
    (`pieces_of`), so one part at a time is whole on the device."""
    device = resolve_device(device)
    if grid is None:
        params = T.init(cfg, seed, device)
    else:
        from ..convert import shard_params

        params = T.init(cfg, seed, device, shard=lambda part: shard_params(
            part, cfg, grid, zero=True, layout=layout))
    return params, init_opt_state(params)
