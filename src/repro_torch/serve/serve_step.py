"""Serving steps: prefill and single-token decode.

Counterpart of `repro/serve/serve_step.py`.  Steps run eagerly under
`torch.inference_mode`.  With a `grid` (`launch.mesh.make_grid`) the
step takes the layout `pick_layout(cfg, grid)` gives, as the
reference's do, or the one it is told.  The rank's params are its
shard under that layout (`convert.shard_params`) and the step runs
under `parallel.tp`: it takes the whole batch, keeps this rank's rows
of it (`sharding.local_batch`: over the data axis, or over every rank
under 'dp_replicated'), and returns the whole batch's logits (gathered
over the ranks that split it) beside this rank's part of the cache
(`init_cache(..., grid=)`).  Decode caches are split as
`parallel.sharding.kv_layout` says: heads over the model axis when
divisible, else the sequence (flash-decoding, for the MQA / GQA
configs whose KV heads do not fill the axis); a rank's rows whole
under 'dp_replicated'.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models import transformer as T
from ..parallel import tp
from ..parallel.sharding import (batch_split, kv_layout, local_batch,
                                 pick_layout)


def cast_params_for_serving(params, dtype=torch.bfloat16):
    """Cast fp32 master weights (ndim ≥ 2) to the serving compute dtype;
    norm scales and other 1-D leaves stay fp32, and so does the MoE
    router (routing decisions are precision-sensitive).  Returns a new
    tree; a leaf already in `dtype` is shared, so casting twice costs
    nothing."""
    def one(node, in_router=False):
        if isinstance(node, dict):
            return {k: one(v, in_router or k == "router")
                    for k, v in node.items()}
        if isinstance(node, list):
            return [one(v, in_router) for v in node]
        if not in_router and node.dtype == torch.float32 and node.dim() >= 2:
            return node.to(dtype)
        return node

    return one(params)


def make_prefill(cfg, device, *, q_chunk: int = 1024, flash: bool = True,
                 grid=None, layout: str | None = None):
    """prefill(params, batch) -> (last-token logits [B, V] fp32, cache),
    on `device` (where params and batch must already lie).  Params are
    cast for serving first (free when they already are); `flash=False`
    takes the plain attention path, the yardstick K4 is checked
    against.  With `grid` (and `layout`, default `pick_layout`'s), as
    the module says."""
    base = T.prefill_fn(cfg, q_chunk=q_chunk, flash=flash)
    dtype = getattr(torch, cfg.dtype)
    device = resolve_device(device)
    if grid is not None:
        layout = layout or pick_layout(cfg, grid)

    @torch.inference_mode()
    def fn(params, batch):
        params = cast_params_for_serving(params, dtype)
        for name, t in batch.items():
            if t.device != device:
                raise ValueError(f"batch[{name!r}] on {t.device}, "
                                 f"prefill on {device}")
        if grid is None:
            return base(params, batch)
        B = next(iter(batch.values())).shape[0]
        lo, n = local_batch(B, grid, layout)
        with tp.using(tp.Ctx(grid, cfg, rows=batch_split(B, grid, layout))):
            logits, cache = base(params, {k: t[lo:lo + n]
                                          for k, t in batch.items()})
            return tp.gather_batch(logits), cache

    return fn


def make_decode(cfg, device, *, grid=None, batch: int = 0, max_seq: int = 0,
                layout: str | None = None):
    """step(params, tokens [B,1], cache, pos) -> (logits [B,V], cache),
    on `device`; params are cast for serving first, and the cache
    (`T.init_cache`) is updated in place.  With `grid` (and `layout`,
    default `pick_layout`'s), as the module says, for the cache of
    `batch` rows and `max_seq` positions; `pos` (an int or [B]) is the
    whole batch's."""
    base = T.decode_fn(cfg)
    dtype = getattr(torch, cfg.dtype)
    device = resolve_device(device)

    @torch.inference_mode()
    def fn(params, tokens, cache, pos):
        params = cast_params_for_serving(params, dtype)
        if tokens.device != device:
            raise ValueError(f"tokens on {tokens.device}, decode on {device}")
        if ctx is None:
            return base(params, tokens, cache, pos)
        if torch.is_tensor(pos) and pos.dim() == 1:
            pos = pos[lo:lo + n]
        with tp.using(ctx):
            logits, cache = base(params, tokens[lo:lo + n], cache, pos)
            return tp.gather_batch(logits), cache

    ctx = None
    if grid is not None:
        layout = layout or pick_layout(cfg, grid)
        lo, n = local_batch(batch, grid, layout)
        ctx = tp.Ctx(grid, cfg,
                     kv=kv_layout(cfg, batch, max_seq, grid, layout),
                     rows=batch_split(batch, grid, layout))
    return fn
