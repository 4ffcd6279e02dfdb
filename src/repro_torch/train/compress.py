"""Gradient compression for the data-parallel all-reduce (int8 with
error feedback).

Counterpart of `repro/train/compress.py`: an int8 quantizer with one
fp32 scale per tensor, and `compressed_all_reduce`, the counterpart of
its `compressed_psum`, over `torch.distributed`.  Each leaf's int8
payload is summed as int32 across the ranks, the scales reduced by
MAX, and the sum dequantized and divided by the world size; the
quantization residual is carried to the next step (error feedback).
It is off by default: `train_step` does not call it, as the
reference's does not.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor, scale=None):
    """(q int8, scale fp32): q = clip(round(x / scale), ±127), rounding
    half to even; scale = max(|x|) / 127 (at least 1e-12 / 127) unless
    given."""
    x32 = x.float()
    if scale is None:
        scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def compressed_all_reduce(tree, group=None, error_state=None):
    """int8-compressed mean over the ranks of `group` (the default group
    when None), with error feedback.

    `error_state`: a tree like `tree` carrying the quantization residual
    of the previous step (zeros when None).  Without an initialized
    process group this is one rank, as a single-device psum is: the
    result is the dequantized value.  Returns (reduced, new_error); the
    reduced leaves keep their dtype, the errors are fp32."""
    if error_state is None:
        error_state = tree_map(
            lambda v: torch.zeros_like(v, dtype=torch.float32), tree)
    ranked = dist.is_available() and dist.is_initialized()
    n = float(dist.get_world_size(group)) if ranked else 1.0

    def one(g, e):
        g32 = g.float() + e
        q, scale = quantize_int8(g32)
        new_e = g32 - dequantize_int8(q, scale)
        # the int8 payload is what crosses the slow links; the scales
        # are one fp32 scalar per tensor
        total = q.to(torch.int32)
        scale = scale.clone()
        if ranked:
            dist.all_reduce(total, dist.ReduceOp.SUM, group=group)
            dist.all_reduce(scale, dist.ReduceOp.MAX, group=group)
        return (total.float() * scale / n).to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(leaves(tree), leaves(error_state))]
    return (unflatten(tree, [o[0] for o in out]),
            unflatten(tree, [o[1] for o in out]))
