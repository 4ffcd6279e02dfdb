"""Model assembly for every LM family (plain PyTorch around kernel K4).

Counterpart of `repro/models/transformer.py` for the serving path of
all six families: dense (qwen3, minitron, granite-34b), moe (granite-moe,
moonshot), ssm (mamba2), hybrid (jamba: Mamba and attention layers, MoE
every other layer), encdec (whisper: a bidirectional encoder over frame
embeddings, decoder layers with cross-attention) and vlm (qwen2-vl:
patch embeddings in, M-RoPE positions).  The reference stacks
repeating superblocks for `lax.scan`; the port keeps one parameter dict
per layer in `params["layers"]` (and `params["encoder"]`,
`params["cross"]` for encdec) and loops over them.

Public API:
    init(cfg, seed, device, cast=None)          -> params
    loss_fn(cfg, remat=...)(params, batch)      -> (loss, metrics)
    prefill_fn(cfg)(params, batch)              -> (last_logits, cache)
    decode_fn(cfg)(params, tokens, cache, pos)  -> (logits, cache)
    init_cache(cfg, batch, max_seq)             -> cache

Batches (`configs.input_specs`): prefill {"tokens" [B, S] int} plus
"enc_embeds" [B, S, d] (encdec), or {"embeds" [B, S, d], "positions3"
[B, 3, S]} (vlm); training adds "labels" [B, S] int (−1 masks a
position); decode tokens [B, 1] int.  Caches: {"layers": [per layer
{"k", "v"} [B, S, K, hd] (attention) or {"h" [B, nh, hd, ds], "conv"
[B, cw-1, conv_dim]} (Mamba, fp32)]}, and for encdec "cross_kv": [per
decoder layer {"k", "v"}].  The enc-dec prefill returns only
"cross_kv", as the reference's does: the decoder's self-attention cache
stays zero.

Prefill and training route MoE layers through `moe_sorted` (capacity
drops; training drops the router's aux loss) and decode through
`moe_dense` (dropless), as the reference does.  Training attention is
plain PyTorch (`layers._sdpa` / `_sdpa_chunked`): K4 is forward-only,
and the reference's `loss_fn` passes no `flash` either.  With `remat`
each decoder layer is recomputed in the backward pass
(`torch.utils.checkpoint`), where the reference rematerializes each
scanned superblock: the math is the same.

Tensor parallelism (serving and training, under `parallel.tp`): a
rank's tree holds its part of each leaf (`convert.shard_params`, or
`init(..., shard=)`), every leaf whole under the 'dp_replicated'
layout.  The embedding is vocabulary-parallel where the
vocabulary divides the model axis (a rank looks up its rows, zeros
elsewhere, summed over the model axis), serving gathers the logits
along the vocabulary so every rank takes the same argmax, training
takes the loss vocabulary-parallel (`_xent`), and the layers split as
`layers`, `moe` and `mamba2` say.  A leaf a rule leaves whole
(granite-moe's vocabulary of 49,155) is replicated.  `init_cache(...,
grid=)` sizes one rank's cache.

ZeRO-3 (training under a grid with a data axis, `tp.Ctx.zero`): a
rank holds a data-axis block of most leaves, and each layer gathers
its leaves over the data axis where it runs (`tp.gathered`), inside
the rematerialized layer, so the backward pass gathers them again and
the whole layer lives only while it is used; the embedding and the
output projection are gathered where they are read.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel import tp
from ..parallel.sharding import (heads_whole, kv_layout, local_batch,
                                 pick_layout)
from . import layers as L
from .layers import (Params, cast, init_dense, init_mlp, init_rmsnorm,
                     rms_norm, swiglu_mlp)
from .mamba2 import init_mamba, init_mamba_state, mamba_block, mamba_decode_step
from .moe import init_moe, moe_dense, moe_sorted


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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
    """Layers per repeating superblock (1 for homogeneous stacks): the
    reference's scan unit, which `convert` unstacks."""
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


def _kinds(cfg) -> list[tuple[str, str]]:
    return list(zip(layer_kinds(cfg), mlp_kinds(cfg)))


def flash_calls(cfg) -> int:
    """Attention calls per prefill that K4 takes when the prompt length
    is a multiple of 512 and hd ≤ 128: every decoder attention layer,
    plus the encoder's layers and the cross-attentions (encdec)."""
    n = layer_kinds(cfg).count("attn")
    if cfg.family == "encdec":
        n += cfg.enc_layers + cfg.n_layers
    return n


# ===========================================================================
# init
# ===========================================================================
def init(cfg, seed: int = 0, device="cpu", cast=None, shard=None) -> Params:
    """fp32 master weights from `seed`: embed normal·0.02, every dense
    projection normal/√d_in, lm_head normal·0.02, norms at 1, the MoE
    and Mamba leaves as `init_moe` / `init_mamba` draw them.  Drawn from
    one `torch.Generator` on `device` in a fixed order — embed, lm_head,
    each decoder layer's mixer then MLP, then (encdec) each encoder
    layer's attention and MLP and each cross-attention — so the same
    seed on the same device type gives the same weights.  They differ
    from `jax.random`'s: tests carry the reference's weights across with
    `convert.lm_params_from_reference` instead.

    `cast`, when given, maps each part (the embedding, the lm_head, one
    layer) right after it is drawn, so only one part's fp32 masters are
    alive at a time: serving passes `cast_params_for_serving`, and the
    result equals casting the whole fp32 tree.  `shard`, when given,
    then maps {name: part} (name "embed", "lm_head", "layers",
    "encoder" or "cross"; a layer as a one-element list) to this rank's
    part of it (`convert.shard_params`).  On the `meta` device the tree
    has the shapes and dtypes and no storage."""
    device = torch.device(device)
    # on the meta device only shapes and dtypes exist (the counterpart of
    # the reference's `abstract_params`): there is nothing to draw
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))

    def put(part, name):
        if cast is not None:
            part = cast(part)
        if shard is None:
            return part
        if name in ("embed", "lm_head"):
            return shard({name: part})[name]
        return shard({name: [part]})[name][0]

    d = cfg.d_model
    params: Params = {
        "embed": put({"w": torch.randn((cfg.vocab, d), generator=gen,
                                       device=device).mul_(0.02)}, "embed"),
        "final_norm": init_rmsnorm(d, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = put(init_dense(gen, d, cfg.vocab, scale=0.02,
                                           device=device), "lm_head")
    layers = []
    for mix, mlp in _kinds(cfg):
        lp = {"norm1": init_rmsnorm(d, device)}
        if mix == "attn":
            lp["attn"] = L.init_attention(gen, cfg, device)
        else:
            lp["ssm"] = init_mamba(gen, cfg, device)
        if mlp != "none":
            lp["norm2"] = init_rmsnorm(d, device)
            lp["mlp"] = (init_mlp(gen, d, cfg.d_ff, device) if mlp == "dense"
                         else init_moe(gen, cfg, device))
        layers.append(put(lp, "layers"))
    params["layers"] = layers
    if cfg.family == "encdec":
        params["encoder"] = [
            put({"norm1": init_rmsnorm(d, device),
                 "attn": L.init_attention(gen, cfg, device),
                 "norm2": init_rmsnorm(d, device),
                 "mlp": init_mlp(gen, d, cfg.d_ff, device)}, "encoder")
            for _ in range(cfg.enc_layers)]
        params["enc_final_norm"] = init_rmsnorm(d, device)
        params["cross"] = [
            put({"norm": init_rmsnorm(d, device),
                 "attn": L.init_attention(gen, cfg, device)}, "cross")
            for _ in range(cfg.n_layers)]
    return params


# ===========================================================================
# forward building blocks
# ===========================================================================
def _embed_in(cfg, params, batch, dtype):
    """Token or stub-frontend embedding input, positions [B, S] and
    `positions3` (vlm; None otherwise)."""
    if "embeds" in batch:                       # vlm stub frontend
        x = batch["embeds"].to(dtype)
        B, S = x.shape[:2]
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = _lookup(cfg, params, tokens, dtype)
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions, batch.get("positions3")


def _top(params, name):
    """params[name] (embed, lm_head), gathered over the data axis under
    ZeRO-3."""
    return tp.gathered(params[name], tp.zero_of(name))


def _lookup(cfg, params, tokens, dtype):
    """Token embeddings; vocabulary-parallel where this rank holds only
    its block of the rows."""
    w = cast(_top(params, "embed")["w"], dtype)
    V = w.shape[0]
    if V == cfg.vocab:
        return w[tokens]
    local = tokens - tp.active().model_rank * V
    hit = (local >= 0) & (local < V)
    return tp.all_reduce(w[local.clamp(0, V - 1)] * hit[..., None].to(dtype))


def _encoder(cfg, params, enc_embeds, dtype, q_chunk=0, flash=False):
    """Whisper-style bidirectional encoder over (stub) frame embeddings
    with sinusoidal positions."""
    S, d = enc_embeds.shape[1:]
    x = (enc_embeds.to(dtype)
         + L.sinusoidal_positions(S, d, enc_embeds.device).to(dtype))
    for i, lp in enumerate(params["encoder"]):
        lp = tp.gathered(lp, tp.zero_of("encoder", i))
        a = rms_norm(lp["norm1"], x, cfg.norm_eps)
        x = x + L.attention(lp["attn"], a, cfg, dtype, causal=False,
                            q_chunk=q_chunk, flash=flash)
        m = rms_norm(lp["norm2"], x, cfg.norm_eps)
        x = x + swiglu_mlp(lp["mlp"], m, dtype, cfg.d_ff)
    return rms_norm(params["enc_final_norm"], x, cfg.norm_eps)


def _mlp(cfg, lp, mlp, x, dtype, *, decode: bool):
    """x plus the layer's MLP (dense SwiGLU, or MoE: sorted dispatch in
    prefill, dropless in decode)."""
    if mlp == "none":
        return x
    m = rms_norm(lp["norm2"], x, cfg.norm_eps)
    if mlp == "dense":
        return x + swiglu_mlp(lp["mlp"], m, dtype, cfg.d_ff)
    moe = moe_dense if decode else moe_sorted
    return x + moe(lp["mlp"], m, cfg, dtype)[0]


def _maybe_remat(remat: bool, fn, *args):
    """fn(*args), recomputed in the backward pass when `remat`."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _decdec_layer(cfg, lp, cp, x, enc_out, dtype, positions, q_chunk, flash,
                  zero=(None, None)):
    """One enc-dec decoder layer: causal self-attention, cross-attention
    over the encoder output, MLP (`zero`: the ZeRO-3 dims of its self
    and cross parts).  Returns (x, its cross K/V)."""
    lp, cp = tp.gathered(lp, zero[0]), tp.gathered(cp, zero[1])
    a = rms_norm(lp["norm1"], x, cfg.norm_eps)
    x = x + L.attention(lp["attn"], a, cfg, dtype, causal=True,
                        positions=positions, q_chunk=q_chunk, flash=flash)
    c = rms_norm(cp["norm"], x, cfg.norm_eps)
    kv = L.enc_kv(cp["attn"], enc_out, cfg, dtype)
    x = x + L.cross_attention(cp["attn"], c, kv, cfg, dtype,
                              q_chunk=q_chunk, flash=flash)
    return _mlp(cfg, lp, "dense", x, dtype, decode=False), kv


def _decdec_backbone(cfg, params, x, enc_out, dtype, positions, q_chunk=0,
                     flash=False, remat=False):
    """Enc-dec decoder stack.  Returns (x, per-layer cross K/V)."""
    kvs = []
    for i, (lp, cp) in enumerate(zip(params["layers"], params["cross"])):
        zero = (tp.zero_of("layers", i), tp.zero_of("cross", i))
        x, kv = _maybe_remat(remat, _decdec_layer, cfg, lp, cp, x, enc_out,
                             dtype, positions, q_chunk, flash, zero)
        kvs.append({"k": kv[0], "v": kv[1]})
    return x, kvs


def _layer(cfg, kinds, lp, x, dtype, positions, positions3, q_chunk, flash,
           zero=None):
    """One decoder layer of every family but encdec: the mixer (causal
    attention or Mamba) and the MLP, each on the residual stream
    (`zero`: its ZeRO-3 dims).  Returns (x, the layer's cache entry:
    its K/V or its Mamba state)."""
    lp = tp.gathered(lp, zero)
    mix, mlp = kinds
    a = rms_norm(lp["norm1"], x, cfg.norm_eps)
    if mix == "attn":
        q, k, v = L._qkv(lp["attn"], a, cfg, dtype, positions, positions3)
        o = L.sdpa_any(q, *L._local_kv(q, k, v, cfg), causal=True,
                       q_chunk=q_chunk, flash=flash)
        a = L.out_proj(lp["attn"], o, cfg, dtype)
        entry = {"k": k, "v": v}
    else:
        a, entry = mamba_block(lp["ssm"], a, cfg, dtype)
    return _mlp(cfg, lp, mlp, x + a, dtype, decode=False), entry


def _backbone(cfg, params, x, dtype, positions, positions3, q_chunk=0,
              flash=False, remat=False):
    """The decoder stack of every family but encdec.  Returns (x, per-layer
    cache entries)."""
    caches = []
    for i, (kinds, lp) in enumerate(zip(_kinds(cfg), params["layers"])):
        x, entry = _maybe_remat(remat, _layer, cfg, kinds, lp, x, dtype,
                                positions, positions3, q_chunk, flash,
                                tp.zero_of("layers", i))
        caches.append(entry)
    return x, caches


def _out_weight(cfg, params, dtype):
    """The output projection [d, V] (or this rank's vocabulary block of
    it): the lm_head, or the tied embedding transposed."""
    if cfg.tie_embeddings:
        return cast(_top(params, "embed")["w"], dtype).T
    return cast(_top(params, "lm_head")["w"], dtype)


def _logits(cfg, params, x, dtype):
    """x @ the output projection; where this rank holds a block of the
    vocabulary, every rank's block gathered in order."""
    y = x @ _out_weight(cfg, params, dtype)
    return y if y.shape[-1] == cfg.vocab else tp.all_gather(y, dim=-1)


# ===========================================================================
# training
# ===========================================================================
def _xent(cfg, params, x, labels, dtype, loss_chunk: int = 0):
    """Token NLL sum and count of labels ≥ 0 (fp32 log-softmax over the
    vocabulary); over sequence chunks of `loss_chunk` when S is a
    multiple of it above it, as in the reference, so the [B, S, V] fp32
    logits never exist at once in the forward pass.

    Where this rank holds a vocabulary block of the output projection
    the loss is taken vocabulary-parallel, the same function without
    gathering the logits: each row's maximum over the model axis (no
    gradient: the loss does not depend on it), Σ exp and the label's
    logit (from the rank that holds it) summed over the model axis
    (backward: as is, every rank reads the sums)."""
    w = _out_weight(cfg, params, dtype)
    parallel = w.shape[-1] < cfg.vocab

    def nll_of(xc, lc):
        if not parallel:
            logp = torch.log_softmax((xc @ w).float(), dim=-1)
            # the reference's take_along_axis wraps a −1 label to the
            # last class and its mask zeroes it; gather needs an index
            # in range
            return -logp.gather(-1, lc.clamp_min(0).long()[..., None])[..., 0]
        logits = (tp.copy_in(xc) @ w).float()
        Vl = logits.shape[-1]
        m = tp.all_max(logits.amax(dim=-1, keepdim=True))
        local = lc.long() - tp.active().model_rank * Vl
        hit = (local >= 0) & (local < Vl)
        picked = logits.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0]
        sums = tp.all_reduce(torch.stack([
            torch.exp(logits - m).sum(dim=-1),
            torch.where(hit, picked, torch.zeros_like(picked))]))
        return torch.log(sums[0]) + m[..., 0] - sums[1]

    def piece(xc, lc):
        mask = (lc >= 0).float()
        return (nll_of(xc, lc) * mask).sum(), mask.sum()

    S = labels.shape[1]
    if loss_chunk and S % loss_chunk == 0 and S > loss_chunk:
        tot = cnt = x.new_zeros((), dtype=torch.float32)
        for i in range(0, S, loss_chunk):
            s, c = piece(x[:, i:i + loss_chunk], labels[:, i:i + loss_chunk])
            tot, cnt = tot + s, cnt + c
        return tot, cnt
    return piece(x, labels)


def loss_fn(cfg, *, remat: bool = False, q_chunk: int = 0,
            loss_chunk: int = 0) -> Callable:
    """(params, batch) -> (mean token NLL, {"loss", "tokens"}), `tokens`
    the count of labels ≥ 0.  `remat` recomputes each decoder layer in
    the backward pass; `q_chunk` chunks attention over queries;
    `loss_chunk` chunks the vocabulary softmax over the sequence."""
    dtype = _dtype(cfg)

    def loss(params, batch):
        x, positions, positions3 = _embed_in(cfg, params, batch, dtype)
        if cfg.family == "encdec":
            enc_out = _encoder(cfg, params, batch["enc_embeds"], dtype,
                               q_chunk=q_chunk)
            x = _decdec_backbone(cfg, params, x, enc_out, dtype, positions,
                                 q_chunk=q_chunk, remat=remat)[0]
        else:
            x = _backbone(cfg, params, x, dtype, positions, positions3,
                          q_chunk=q_chunk, remat=remat)[0]
        x = rms_norm(params["final_norm"], x, cfg.norm_eps)
        tot, cnt = _xent(cfg, params, x, batch["labels"], dtype, loss_chunk)
        # a rank of a batch split over the data axis: its share of the
        # whole batch's mean (the shares sum to it)
        cnt = tp.data_sum(cnt)
        loss = tot / cnt.clamp_min(1.0)
        return loss, {"loss": loss, "tokens": cnt}

    return loss


# ------------------------------------------------------------- serving ----
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cpu", grid=None, layout: str | None = None):
    """Decode cache: per layer a zeroed K and V [batch, max_seq, K, hd]
    in `dtype` (attention) or a zeroed fp32 Mamba state; encdec adds the
    cross-attention K/V per decoder layer ("cross_kv").  With `grid`,
    one rank's part under `layout` (default `sharding.pick_layout`'s):
    its rows of the batch (`sharding.local_batch`), its KV heads or its
    1/M of the positions (`sharding.kv_layout`), its Mamba heads, and
    the cross K/V's heads where `sharding.partition` splits wk / wv;
    under 'dp_replicated' its rows whole."""
    B, S, K, Kx, m = batch, max_seq, cfg.n_kv_heads, cfg.n_kv_heads, 1
    if grid is not None:
        layout = layout or pick_layout(cfg, grid)
        B = local_batch(batch, grid, layout)[1]
        kv = kv_layout(cfg, batch, max_seq, grid, layout)
        if layout == "tp2d":
            m = grid.model
        K = K // m if kv == "heads" else K
        S = S // m if kv == "seq" else S
        if m > 1 and not heads_whole(cfg, grid) and Kx % m == 0:
            Kx //= m

    def zeros_kv(seq, heads):
        shape = (B, seq, heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    cache = {"layers": [zeros_kv(S, K) if mix == "attn"
                        else init_mamba_state(cfg, B, device, model=m)
                        for mix in layer_kinds(cfg)]}
    if cfg.family == "encdec":
        cache["cross_kv"] = [zeros_kv(max_seq, Kx)
                             for _ in range(cfg.n_layers)]
    return cache


def decode_fn(cfg) -> Callable:
    """One-token decode step: (params, tokens [B,1], cache, pos) ->
    (logits [B,V] fp32, cache).  The cache is updated in place (a Mamba
    state too: its bf16 conv window lands in the fp32 leaf exactly).
    Encdec cross-attention reads the whole `max_seq` cross cache with no
    mask, as the reference's does."""
    dtype = _dtype(cfg)
    kinds = _kinds(cfg)
    encdec = cfg.family == "encdec"

    def step(params, tokens, cache, pos):
        h = _lookup(cfg, params, tokens, dtype)                # [B,1,d]
        for i, ((mix, mlp), lp, lc) in enumerate(zip(
                kinds, params["layers"], cache["layers"])):
            a = rms_norm(lp["norm1"], h, cfg.norm_eps)
            if mix == "attn":
                a, lc["k"], lc["v"] = L.attention_decode(
                    lp["attn"], a, lc["k"], lc["v"], pos, cfg, dtype)
            else:
                a, st = mamba_decode_step(lp["ssm"], a, lc, cfg, dtype)
                lc["h"].copy_(st["h"])
                lc["conv"].copy_(st["conv"])
            h = h + a
            if encdec:
                cp, ckv = params["cross"][i], cache["cross_kv"][i]
                c = rms_norm(cp["norm"], h, cfg.norm_eps)
                h = h + L.cross_attention(
                    cp["attn"], c, (cast(ckv["k"], dtype),
                                    cast(ckv["v"], dtype)), cfg, dtype)
            h = _mlp(cfg, lp, mlp, h, dtype, decode=True)
        h = rms_norm(params["final_norm"], h, cfg.norm_eps)
        logits = _logits(cfg, params, h, dtype)[:, 0, :]
        return logits.float(), cache

    return step


def prefill_fn(cfg, *, q_chunk: int = 0, flash: bool = True) -> Callable:
    """Full-sequence prefill: returns last-token logits (fp32 [B, V]) and
    the cache it fills (per layer K/V [B, S, K, hd] in the compute dtype
    or the Mamba state after the prompt; encdec: "cross_kv" only).
    `flash=True` routes self- and cross-attention through kernel K4
    where `layers.flash_eligible` allows (serving has no backward
    pass)."""
    dtype = _dtype(cfg)

    def head(params, x):
        x = rms_norm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
        return _logits(cfg, params, x, dtype)[:, 0].float()

    def prefill(params, batch):
        x, positions, positions3 = _embed_in(cfg, params, batch, dtype)
        if cfg.family == "encdec":
            enc_out = _encoder(cfg, params, batch["enc_embeds"], dtype,
                               q_chunk=q_chunk, flash=flash)
            x, kvs = _decdec_backbone(cfg, params, x, enc_out, dtype,
                                      positions, q_chunk=q_chunk, flash=flash)
            return head(params, x), {"cross_kv": kvs}
        x, caches = _backbone(cfg, params, x, dtype, positions, positions3,
                              q_chunk=q_chunk, flash=flash)
        return head(params, x), {"layers": caches}

    return prefill
