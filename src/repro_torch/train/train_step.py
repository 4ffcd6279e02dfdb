"""Train-step construction: loss and gradients, then the AdamW update.

Counterpart of `repro/train/train_step.py` on one device, with its
microbatch gradient accumulation, activation remat, query-chunked
attention and sequence-chunked loss.  Parameters are fp32 masters,
updated in place (the reference donates them); the sharded layouts of
the reference (`pick_layout`, `param_shardings`) are not ported yet,
so nothing here takes a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..models import transformer as T
from .optimizer import AdamWConfig, adamw_update, init_opt_state
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


def make_train_step(cfg, opt_cfg: AdamWConfig, opts: TrainOptions, *,
                    device="cuda"):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), `params` and `opt_state` updated in place.  `batch` is
    moved to `device` (a CUDA device raises without a card).

    With `accum_steps` A > 1 the batch splits into A microbatches along
    its leading axis; the gradients are summed in fp32 and divided by A,
    the loss is the mean of the microbatch losses, and
    `metrics["tokens"]` is 0, as in the reference.  Attention chunks its
    queries by `q_chunk` where the sequence is at least twice that
    (`_needs_chunk`, decided on the batch's shape)."""
    device = resolve_device(device)
    losses = {}

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

    def step(params, opt_state, batch):
        batch = {k: v.to(device) for k, v in batch.items()}
        l, metrics, g = grads_of(params, batch)
        params, opt_state, om = adamw_update(opt_cfg, g, opt_state, params)
        return params, opt_state, {**metrics, **om}

    return step


def abstract_params(cfg):
    """The params tree of `cfg` on the `meta` device: shapes and dtypes,
    no storage (what a checkpoint restores into)."""
    return T.init(cfg, 0, "meta")


def init_train_state(cfg, *, seed: int = 0, device="cuda"):
    """fp32 master params from `seed` (`models.transformer.init`) and a
    zeroed optimizer state, on `device`."""
    device = resolve_device(device)
    params = T.init(cfg, seed, device)
    return params, init_opt_state(params)
