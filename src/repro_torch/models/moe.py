"""Token-choice top-k Mixture-of-Experts (plain PyTorch).

Counterpart of `repro/models/moe.py`, with its two dispatches:

 * `moe_sorted` (prefill): sort-based, capacity-bounded.  Token-expert
   pairs are stably sorted by expert and written into per-expert
   buckets [E, C, d]; the expert FFNs run as one batched matmul over E;
   pairs past an expert's capacity C drop (their residual path still
   carries the token).
 * `moe_dense` (decode, and the oracle in tests): every expert on every
   token, combined with the routing weights; exact, drops nothing.

Router: softmax over the expert logits in fp32, top-k (ties to the
lower expert index, as `jax.lax.top_k`), weights renormalized over the
selected experts, plus the Switch load-balancing auxiliary loss.

Nothing here adds floats through atomics: `moe_sorted` combines each
token's k expert outputs by a gather, summed one expert after another
in increasing expert id — the order in which the reference's
scatter-add visits them — so two prefills on one card are bit-equal.

Expert parallelism: under a grid a rank may hold E/M of the experts
(`parallel.sharding.partition`); the router stays whole, in fp32.
Each rank adds its experts' share of every token's output, and the
shares are summed over the model axis.  In training the experts' input
and the routing weights are copied into the model axis (`tp.copy_in`):
each rank's experts reach only their share of the output, so the
gradients that reach the input and the router through them are
partial and summed over the model axis.  The capacity C and the drops
stay those of the whole batch, as the reference's (GSPMD sees global
shapes): where the batch is split over the data axis, every rank
gathers the routing (N·k expert ids) over it and takes the same keep
decision.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import tp
from .layers import Params, cast, init_dense


def init_moe(gen: torch.Generator, cfg, device=None) -> Params:
    """Router normal/√d, gate and up normal/√d [E, d, ff], down normal/√ff
    [E, ff, d]; drawn in that order from `gen`."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_expert

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(scale)

    return {
        "router": init_dense(gen, d, E, device=device),
        "gate": normal((E, d, ff), 1.0 / math.sqrt(d)),
        "up": normal((E, d, ff), 1.0 / math.sqrt(d)),
        "down": normal((E, ff, d), 1.0 / math.sqrt(ff)),
    }


def _route(p: Params, x: torch.Tensor, cfg, dtype):
    """x [N, d] → (weights [N, k] in `dtype`, experts [N, k] int64,
    aux_loss fp32 scalar).  The router runs in fp32 on an fp32 copy of
    x (the reference's bf16 @ f32 promotes the same way)."""
    logits = x.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower index first among equal
    # probabilities, which is jax.lax.top_k's order
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.top_k], idx[:, :cfg.top_k]
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    E = cfg.n_experts
    f = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(f * probs.mean(dim=0))
    return w.to(dtype), idx, aux


def _experts(xb, p: Params, dtype):
    """SwiGLU of every expert on its own rows: xb [E, C, d] → [E, C, d]."""
    g = torch.bmm(xb, cast(p["gate"], dtype))
    u = torch.bmm(xb, cast(p["up"], dtype))
    return torch.bmm(F.silu(g) * u, cast(p["down"], dtype))


def _local_experts(p: Params, cfg) -> tuple[int, int]:
    """(first expert id, experts) this rank holds."""
    El = p["gate"].shape[0]
    return (0 if El == cfg.n_experts else tp.active().model_rank * El), El


def _summed(out: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """Every rank's experts' shares of `out` summed over the model axis
    (where the experts are split)."""
    return out if p["gate"].shape[0] == cfg.n_experts else tp.all_reduce(out)


def moe_dense(p: Params, x: torch.Tensor, cfg, dtype):
    """Reference dispatch: all experts on all tokens.  x [B, S, d] →
    (out [B, S, d], aux)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    w, idx, aux = _route(p, xf, cfg, dtype)
    lo, El = _local_experts(p, cfg)
    y = _experts(xf.unsqueeze(0).expand(El, -1, -1), p, dtype)  # [El, N, d]
    mine = (idx >= lo) & (idx < lo + El)
    sel = y[(idx - lo).clamp(0, El - 1),
            torch.arange(xf.shape[0], device=x.device)[:, None]]
    out = torch.einsum("nkd,nk->nd", sel, w * mine.to(w.dtype))
    return _summed(out.reshape(B, S, d), p, cfg), aux


def capacity(N: int, cfg) -> int:
    """Per-expert capacity C of `moe_sorted` for N tokens (the
    reference's formula, in Python floats)."""
    return max(1, int((N * cfg.top_k) / cfg.n_experts * cfg.capacity_factor))


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in the int64 `ids`: int64 [n], as
    `torch.bincount(ids, minlength=n)` gives them, through a scatter-add
    that also runs on `meta` tensors (bincount has no meta kernel)."""
    return torch.zeros(n, dtype=ids.dtype, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def dispatch(idx: torch.Tensor, cfg):
    """The sorted dispatch of `moe_sorted` for experts idx [N, k]:
    (order, token, keep, slot, C).  Pairs (flattened token-major, [N*k])
    are stably sorted by expert (`order`; `token` is each sorted pair's
    token); a pair keeps its place when its rank within its expert is
    below the capacity C, and `slot` is its bucket row e·C + rank, or
    the drop row E·C."""
    N, k = idx.shape
    E = cfg.n_experts
    C = capacity(N, cfg)
    se, order = torch.sort(idx.reshape(-1), stable=True)
    token = torch.arange(N, device=idx.device).repeat_interleave(k)[order]
    counts = _counts(se, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * k, device=idx.device) - starts[se]
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)
    return order, token, keep, slot, C


def _keep(idx: torch.Tensor, whole: torch.Tensor, cfg) -> torch.Tensor:
    """Whether each token-major pair of `idx` [N, k] keeps its place
    under `dispatch`'s capacity, decided over the whole batch's routing
    `whole` (`idx` itself, or every data rank's gathered)."""
    order, _, kept, _, _ = dispatch(whole, cfg)
    keep = torch.empty_like(kept)
    keep[order] = kept
    if whole.shape[0] == idx.shape[0]:
        return keep
    first = tp.active().rows_rank * idx.numel()
    return keep[first:first + idx.numel()]


def moe_sorted(p: Params, x: torch.Tensor, cfg, dtype):
    """Sort-based dispatch with per-expert capacity C (`capacity`):
    within each expert, pairs keep their token order and those of rank
    ≥ C drop (`dispatch`).  x [B, S, d] → (out [B, S, d], aux).  A
    rank's kept pairs on its experts fill its buckets [El·C, d]."""
    B, S, d = x.shape
    k = cfg.top_k
    xf = x.reshape(-1, d)
    N = xf.shape[0]
    w, idx, aux = _route(p, xf, cfg, dtype)
    whole = tp.gather_batch(idx)
    C = capacity(whole.shape[0], cfg)
    lo, El = _local_experts(p, cfg)
    if El < cfg.n_experts:
        xf, w = tp.copy_in(xf), tp.copy_in(w)
    flat = idx.reshape(-1)
    mine = _keep(idx, whole, cfg) & (flat >= lo) & (flat < lo + El)
    # pairs on another rank's experts, or dropped, sort past the
    # buckets (into the spare expert El) and write the spare row
    se, order = torch.sort(torch.where(mine, flat - lo, El), stable=True)
    token = torch.arange(N, device=x.device).repeat_interleave(k)[order]
    counts = _counts(se, El + 1)
    rank = torch.arange(N * k, device=x.device) - (torch.cumsum(counts, 0)
                                                   - counts)[se]
    keep = se < El
    slot = torch.where(keep, se * C + rank, El * C)

    buckets = torch.zeros((El * C + 1, d), dtype=dtype, device=x.device)
    buckets[slot] = cast(xf[token], dtype)
    y = _experts(buckets[:El * C].reshape(El, C, d), p, dtype).reshape(
        El * C, d)

    gathered = y[slot.clamp_max(El * C - 1)]                 # [N*k, d]
    gathered = torch.where(keep[:, None], gathered, 0)
    # back to token-major pairs, then each token's experts by id
    pairs = torch.empty_like(gathered)
    pairs[order] = gathered
    pairs = pairs.reshape(N, k, d) * w[:, :, None]
    by_id = torch.argsort(idx, dim=1)
    pairs = pairs.gather(1, by_id[:, :, None].expand(N, k, d))
    out = pairs[:, 0]
    for j in range(1, k):
        out = out + pairs[:, j]
    return _summed(out.reshape(B, S, d), p, cfg), aux
