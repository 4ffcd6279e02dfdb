"""Serving steps on one device: prefill and single-token decode.

Counterpart of `repro/serve/serve_step.py` without shardings (one
device per process; the multi-GPU layout is a later slice).  Steps run
eagerly under `torch.inference_mode`.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models import transformer as T


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


def make_prefill(cfg, device, *, q_chunk: int = 1024, flash: bool = True):
    """prefill(params, batch) -> (last-token logits [B, V] fp32, cache),
    on `device` (where params and batch must already lie).  Params are
    cast for serving first (free when they already are); `flash=False`
    takes the plain attention path, the yardstick K4 is checked
    against."""
    base = T.prefill_fn(cfg, q_chunk=q_chunk, flash=flash)
    dtype = getattr(torch, cfg.dtype)
    device = resolve_device(device)

    @torch.inference_mode()
    def fn(params, batch):
        params = cast_params_for_serving(params, dtype)
        for name, t in batch.items():
            if t.device != device:
                raise ValueError(f"batch[{name!r}] on {t.device}, "
                                 f"prefill on {device}")
        return base(params, batch)

    return fn


def make_decode(cfg, device):
    """step(params, tokens [B,1], cache, pos) -> (logits [B,V], cache),
    on `device`; params are cast for serving first, and the cache
    (`T.init_cache`) is updated in place."""
    base = T.decode_fn(cfg)
    dtype = getattr(torch, cfg.dtype)
    device = resolve_device(device)

    @torch.inference_mode()
    def fn(params, tokens, cache, pos):
        params = cast_params_for_serving(params, dtype)
        if tokens.device != device:
            raise ValueError(f"tokens on {tokens.device}, decode on {device}")
        return base(params, tokens, cache, pos)

    return fn
