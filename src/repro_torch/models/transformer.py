"""Model assembly, dense family (plain PyTorch).

Counterpart of `repro/models/transformer.py` for `family == "dense"`
(qwen3, minitron, granite-34b).  The reference stacks homogeneous layers
for `lax.scan`; the port keeps one parameter dict per layer in
`params["layers"]` and loops over them.

Public API:
    init(cfg, seed, device)                     -> params
    prefill_fn(cfg)(params, batch)              -> (last_logits, cache)
    decode_fn(cfg)(params, tokens, cache, pos)  -> (logits, cache)
    init_cache(cfg, batch, max_seq)             -> cache

Batches: prefill {"tokens" [B, S] int}; decode tokens [B, 1] int.
Caches: {"layers": [{"k": [B, S, K, hd], "v": ...}, ...]}.

Other families (moe, ssm, hybrid, encdec, vlm) raise NotImplementedError:
they need `models/moe.py` and `models/mamba2.py`, planned in ROADMAP.md
queue 1 (the remaining LM families).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import layers as L
from .layers import (Params, cast, dense, init_dense, init_mlp, init_rmsnorm,
                     rms_norm, swiglu_mlp)

_PLANNED = ("the {family} family is not ported yet (ROADMAP.md queue 1: "
            "the remaining LM families)")


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _require_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(_PLANNED.format(family=cfg.family))


# ===========================================================================
# layer classification (the reference's, for every family)
# ===========================================================================
def layer_kinds(cfg) -> list[str]:
    """Per-layer mixer kind: 'attn' or 'ssm'."""
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "hybrid":
        assert cfg.attn_every > 0
        return [
            "attn" if i % cfg.attn_every == cfg.attn_every - 1 else "ssm"
            for i in range(cfg.n_layers)
        ]
    return ["attn"] * cfg.n_layers


def mlp_kinds(cfg) -> list[str]:
    """Per-layer MLP kind: 'dense', 'moe' or 'none'."""
    out = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            out.append("none")
        elif cfg.n_experts and i % cfg.moe_every == cfg.moe_every - 1:
            out.append("moe")
        elif cfg.d_ff:
            out.append("dense")
        else:
            out.append("none")
    return out


def _block_len(cfg) -> int:
    """Layers per repeating superblock (1 for homogeneous stacks)."""
    kinds = list(zip(layer_kinds(cfg), mlp_kinds(cfg)))
    for blk in range(1, cfg.n_layers + 1):
        if cfg.n_layers % blk:
            continue
        pattern = kinds[:blk]
        if all(
            kinds[i * blk : (i + 1) * blk] == pattern
            for i in range(cfg.n_layers // blk)
        ):
            return blk
    return cfg.n_layers


# ===========================================================================
# init
# ===========================================================================
def init(cfg, seed: int = 0, device="cpu") -> Params:
    """fp32 master weights from `seed`: embed normal·0.02, every dense
    projection normal/√d_in, lm_head normal·0.02, norms at 1.  Drawn
    from one `torch.Generator` on `device` in a fixed order (embed,
    lm_head, then each layer's attention and MLP), so the same seed on
    the same device type gives the same weights.  They differ from
    `jax.random`'s: tests carry the reference's weights across with
    `convert.lm_params_from_reference` instead."""
    _require_dense(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: Params = {
        "embed": {"w": torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                   device=device).mul_(0.02)},
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab,
                                       scale=0.02, device=device)
    params["layers"] = [
        {"norm1": init_rmsnorm(cfg.d_model, device),
         "attn": L.init_attention(gen, cfg, device),
         "norm2": init_rmsnorm(cfg.d_model, device),
         "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, device)}
        for _ in range(cfg.n_layers)]
    return params


# ===========================================================================
# forward building blocks
# ===========================================================================
def _embed_in(cfg, params, batch, dtype):
    """Token embedding input + positions [B, S]."""
    if "tokens" not in batch:
        raise NotImplementedError(_PLANNED.format(family=cfg.family))
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = cast(params["embed"]["w"], dtype)[tokens]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    return x, positions


def _logits(cfg, params, x, dtype):
    if cfg.tie_embeddings:
        w = cast(params["embed"]["w"], dtype).T
    else:
        w = cast(params["lm_head"]["w"], dtype)
    return x @ w


# ------------------------------------------------------------- serving ----
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cpu"):
    """Decode cache: one zeroed K and V [batch, max_seq, K, hd] per layer."""
    _require_dense(cfg)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"layers": [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.n_layers)]}


def decode_fn(cfg) -> Callable:
    """One-token decode step: (params, tokens [B,1], cache, pos) ->
    (logits [B,V] fp32, cache).  The cache is updated in place."""
    _require_dense(cfg)
    dtype = _dtype(cfg)

    def step(params, tokens, cache, pos):
        h = cast(params["embed"]["w"], dtype)[tokens]          # [B,1,d]
        for lp, lc in zip(params["layers"], cache["layers"]):
            a = rms_norm(lp["norm1"], h, cfg.norm_eps)
            a, lc["k"], lc["v"] = L.attention_decode(
                lp["attn"], a, lc["k"], lc["v"], pos, cfg, dtype)
            h = h + a
            m = rms_norm(lp["norm2"], h, cfg.norm_eps)
            h = h + swiglu_mlp(lp["mlp"], m, dtype)
        h = rms_norm(params["final_norm"], h, cfg.norm_eps)
        logits = _logits(cfg, params, h, dtype)[:, 0, :]
        return logits.float(), cache

    return step


def prefill_fn(cfg, *, q_chunk: int = 0, flash: bool = True) -> Callable:
    """Full-sequence prefill: returns last-token logits (fp32 [B, V]) and
    every layer's K/V ({"layers": [{"k", "v"} [B, S, K, hd]]}, compute
    dtype).  `flash=True` routes self-attention through kernel K4 where
    `layers.flash_eligible` allows (serving has no backward pass)."""
    _require_dense(cfg)
    dtype = _dtype(cfg)

    def prefill(params, batch):
        x, positions = _embed_in(cfg, params, batch, dtype)
        B, S = x.shape[:2]
        caches = []
        for lp in params["layers"]:
            a = rms_norm(lp["norm1"], x, cfg.norm_eps)
            q, k, v = L._qkv(lp["attn"], a, cfg, dtype, positions)
            o = L.sdpa_any(q, k, v, causal=True, q_chunk=q_chunk,
                           flash=flash)
            x = x + dense(lp["attn"]["wo"], o.reshape(B, S, -1), dtype)
            caches.append({"k": k, "v": v})
            m = rms_norm(lp["norm2"], x, cfg.norm_eps)
            x = x + swiglu_mlp(lp["mlp"], m, dtype)
        x = rms_norm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
        logits = _logits(cfg, params, x, dtype)[:, 0]
        return logits.float(), {"layers": caches}

    return prefill
