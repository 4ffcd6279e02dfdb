"""Neural building blocks (plain PyTorch; params are nested dicts).

Counterpart of `repro/models/layers.py`:

 * params are fp32 masters; `cast` converts activations/weights to the
   compute dtype at use sites (mixed precision);
 * norms and RoPE compute in fp32 and cast back to the input's dtype;
 * attention is grouped-query: q [B, S, H, hd] over k/v [B, S, K, hd];
   positions are RoPE's [B, S] or, for M-RoPE (qwen2-vl), `positions3`
   [B, 3, S] (t, h, w components).

Self- and cross-attention in prefill go through kernel K4
(`kernels.ops.flash_attention`) under the reference's dispatch rule
(`sdpa_any`); decode attention is plain PyTorch, as it is plain XLA in
the reference.  The projections, the MLP and the lm_head are
`torch.matmul`, as the reference leaves them to XLA.

Under a serving or training step's grid (`parallel.tp`) a layer's
weights may hold only this rank's part (`parallel.sharding.partition`):
wq / wk / wv their heads' columns and the MLP's gate / up their
columns (column-parallel, their input copied into the model axis:
`tp.copy_in`, whose backward sums the input's gradient over it), wo and
the MLP's down projection their rows (row-parallel, followed by an
all_reduce over the model axis).  The head counts come from the
weights' shapes, so the one-device path is the same code with every
part whole.  Where the KV heads do not divide the model axis, wk / wv
stay whole and a rank picks the KV heads its query heads read
(`_local_kv`); each rank's gradient of them, and of the q / k norms
every head shares, is then partial and summed over the model axis.
Where the query heads do not divide the model axis, attention is whole
on every model rank (`sharding.heads_whole`; and every layer is whole
under 'dp_replicated'): each rank computes every head on the same
input, its input takes no `tp.copy_in` and wo's output no all_reduce,
so each rank's gradient of the attention weights and of its input is
already whole.  Decode attention over a cache split along the sequence
is flash-decoding (`_attention_decode_seq`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import tp

Params = dict


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) if x.dtype != dtype else x


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, device=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return {"w": w.mul_(scale)}


def dense(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    return x @ cast(p["w"], dtype)


def dense_rows(p: Params, x: torch.Tensor, dtype, n_in: int) -> torch.Tensor:
    """`dense` of a row-parallel weight: where this rank holds fewer
    than its `n_in` rows (x holds the matching columns), the partial
    products are summed over the model axis."""
    y = dense(p, x, dtype)
    return tp.all_reduce(y) if p["w"].shape[0] < n_in else y


def init_rmsnorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return head_rms_norm(x, p["scale"], eps)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis in fp32, cast back to x's dtype (also
    the per-head q/k norm of Qwen3's qk_norm: x [..., head_dim])."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, hd]; positions [..., S] (int).  Rotates the two
    halves of hd (not interleaved pairs), in fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = positions[..., None].float() * freqs               # [..., S, hd/2]
    return _rotate(x, ang[..., None, :])                     # [..., S, 1, hd/2]


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x's two halves of hd rotated by the angles `ang` (broadcast over
    the heads), in fp32, cast back to x's dtype."""
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: x [..., S, H, hd]; positions3 [..., 3, S] (t, h,
    w components); the hd/2 frequency slots are split across the three
    components by `sections` (sum = hd/2)."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    comp = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                      for i, s in enumerate(sections)])      # [hd/2]
    pos = positions3.movedim(-2, -1)[..., comp]              # [..., S, hd/2]
    return _rotate(x, (pos.float() * freqs)[..., None, :])


def _mrope_sections(hd: int):
    """qwen2-vl's (16, 24, 24) for hd = 128, scaled otherwise."""
    base = (16, 24, 24)
    if hd // 2 == sum(base):
        return base
    unit = (hd // 2) // 4
    return (unit, (hd // 2 - unit) // 2, hd // 2 - unit - (hd // 2 - unit) // 2)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """[seq, d] fp32: sines over the first d/2 columns, cosines after."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------------ MLP
def init_mlp(gen: torch.Generator, d: int, ff: int, device=None):
    return {
        "gate": init_dense(gen, d, ff, device=device),
        "up": init_dense(gen, d, ff, device=device),
        "down": init_dense(gen, ff, d, device=device),
    }


def swiglu_mlp(p: Params, x: torch.Tensor, dtype, d_ff: int = 0
               ) -> torch.Tensor:
    """SwiGLU; with `d_ff`, gate / up may hold their columns of it and
    down its rows (then summed over the model axis)."""
    if d_ff and p["gate"]["w"].shape[1] < d_ff:
        x = tp.copy_in(x)
    g = dense(p["gate"], x, dtype)
    u = dense(p["up"], x, dtype)
    return dense_rows(p["down"], F.silu(g) * u, dtype, d_ff)


# ------------------------------------------------------------- attention
def init_attention(gen: torch.Generator, cfg, device=None) -> Params:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init_dense(gen, d, H * hd, device=device),
        "wk": init_dense(gen, d, K * hd, device=device),
        "wv": init_dense(gen, d, K * hd, device=device),
        "wo": init_dense(gen, H * hd, d, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _heads(p, hd) -> tuple[int, int]:
    """(query heads, KV heads) this rank's weights hold."""
    return p["wq"]["w"].shape[1] // hd, p["wk"]["w"].shape[1] // hd


def _split(p, cfg) -> bool:
    """Whether this rank's attention weights hold some of the heads."""
    return _heads(p, cfg.head_dim)[0] < cfg.n_heads


def _kv_weights(p, cfg):
    """(wk, wv) as this rank's products read them: where its query heads
    are split and wk / wv are whole, every model rank reads them only
    for the KV heads its query heads use (`_local_kv`), so their
    gradient is summed over the model axis."""
    if _split(p, cfg) and _heads(p, cfg.head_dim)[1] == cfg.n_kv_heads:
        return ({"w": tp.copy_in(p["wk"]["w"])},
                {"w": tp.copy_in(p["wv"]["w"])})
    return p["wk"], p["wv"]


def _qkv(p, x, cfg, dtype, positions=None, positions3=None):
    hd = cfg.head_dim
    H, K = _heads(p, hd)
    split = _split(p, cfg)
    if split:
        x = tp.copy_in(x)
    wk, wv = _kv_weights(p, cfg)
    q = _split_heads(dense(p["wq"], x, dtype), H, hd)
    k = _split_heads(dense(wk, x, dtype), K, hd)
    v = _split_heads(dense(wv, x, dtype), K, hd)
    if cfg.qk_norm:
        # one scale for every head: each rank's heads give part of its
        # gradient
        qn, kn = p["q_norm"], p["k_norm"]
        if split:
            qn, kn = tp.copy_in(qn), tp.copy_in(kn)
        q = head_rms_norm(q, qn, cfg.norm_eps)
        k = head_rms_norm(k, kn, cfg.norm_eps)
    if cfg.mrope and positions3 is not None:
        q = apply_mrope(q, positions3, cfg.rope_theta, _mrope_sections(hd))
        k = apply_mrope(k, positions3, cfg.rope_theta, _mrope_sections(hd))
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, *, causal: bool, q_offset: int = 0):
    """q [B,Sq,H,hd], k/v [B,Sk,K,hd] — grouped-query attention; scores
    in q's dtype, softmax in fp32, weights cast to v's dtype."""
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    G = H // K
    q = q.reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) / math.sqrt(hd)
    scores = scores.float()
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Sk, device=q.device)[None, :]
        scores = scores.masked_fill(qi < ki, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def _sdpa_chunked(q, k, v, *, causal: bool, chunk: int = 1024):
    """Attention over query chunks of `chunk` rows, so the [Sq, Sk] score
    matrix never fully materializes (a loop where the reference scans)."""
    B, Sq, H, hd = q.shape
    if Sq <= chunk:
        return _sdpa(q, k, v, causal=causal)
    if Sq % chunk:
        raise ValueError(f"Sq={Sq} is not a multiple of chunk={chunk}")
    return torch.cat([
        _sdpa(q[:, i:i + chunk], k, v, causal=causal, q_offset=i)
        for i in range(0, Sq, chunk)], dim=1)


def flash_eligible(q, k) -> bool:
    """The reference's rule for routing self-attention to the flash
    kernel (`layers.py:254`): equal query and key lengths, a multiple
    of 512, head dim at most 128."""
    Sq, hd = q.shape[1], q.shape[3]
    return Sq == k.shape[1] and Sq % 512 == 0 and hd <= 128


def _local_kv(q, k, v, cfg):
    """k / v reduced to the KV heads this rank's query heads read.
    Where the query heads are split over the model axis and the KV
    heads are not (K % M != 0), model rank r's heads r·H/M + i read KV
    head (r·H/M + i) // G: a block of KV heads when G divides H/M, one
    KV head when H/M divides G, else one per query head (G = 1 then)."""
    Hl, Kl = q.shape[2], k.shape[2]
    H = cfg.n_heads
    if Hl == H or Kl < cfg.n_kv_heads:
        return k, v
    G = H // cfg.n_kv_heads
    first = tp.active().model_rank * Hl
    if Hl % G == 0 or G % Hl == 0:
        lo, n = first // G, max(Hl // G, 1)
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = (first + torch.arange(Hl, device=k.device)) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def sdpa_any(q, k, v, *, causal: bool, q_chunk: int = 0,
             flash: bool = False):
    """Dispatch: flash kernel K4 (serving) → chunked → plain.  Shapes
    outside `flash_eligible` take the plain path, as in the reference:
    that is its semantics, not a fallback for a failed kernel."""
    if flash and flash_eligible(q, k):
        return ops.flash_attention(q, k, v, causal=causal)
    if q_chunk:
        return _sdpa_chunked(q, k, v, causal=causal, chunk=q_chunk)
    return _sdpa(q, k, v, causal=causal)


def attention(p: Params, x, cfg, dtype, *, causal=True, positions=None,
              positions3=None, q_chunk: int = 0, flash: bool = False):
    q, k, v = _qkv(p, x, cfg, dtype, positions, positions3)
    k, v = _local_kv(q, k, v, cfg)
    out = sdpa_any(q, k, v, causal=causal, q_chunk=q_chunk, flash=flash)
    return out_proj(p, out, cfg, dtype)


def out_proj(p: Params, out, cfg, dtype):
    """wo over the attention output [B, S, heads, hd] (row-parallel
    where the heads are split)."""
    B, S = out.shape[:2]
    return dense_rows(p["wo"], out.reshape(B, S, -1), dtype,
                      cfg.n_heads * cfg.head_dim)


def cross_attention(p: Params, x, enc_kv, cfg, dtype, *, q_chunk: int = 0,
                    flash: bool = False):
    """x [B, Sq, d]; enc_kv = (k, v) precomputed from the encoder output
    (`enc_kv`).  Bidirectional, no RoPE; K4 under the same rule as
    self-attention (Sq == Sk, a multiple of 512)."""
    hd = cfg.head_dim
    if _split(p, cfg):
        x = tp.copy_in(x)
    q = _split_heads(dense(p["wq"], x, dtype), _heads(p, hd)[0], hd)
    k, v = _local_kv(q, *enc_kv, cfg)
    out = sdpa_any(q, k, v, causal=False, q_chunk=q_chunk, flash=flash)
    return out_proj(p, out, cfg, dtype)


def enc_kv(p: Params, enc_out, cfg, dtype):
    """Cross-attention K and V [B, S_enc, K, hd] of the encoder output
    (this rank's KV heads)."""
    hd = cfg.head_dim
    K = _heads(p, hd)[1]
    if _split(p, cfg):
        enc_out = tp.copy_in(enc_out)
    wk, wv = _kv_weights(p, cfg)
    k = _split_heads(dense(wk, enc_out, dtype), K, hd)
    v = _split_heads(dense(wv, enc_out, dtype), K, hd)
    return k, v


# --------------------------------------------------- decode (KV cache) ----
def attention_decode(p: Params, x, cache_k, cache_v, pos, cfg, dtype,
                     positions3=None):
    """One-token decode: x [B,1,d]; cache [B,S,K,hd]; pos an int OR a
    per-row ``[B]`` int tensor (continuous batching: each slot of the
    padded batch sits at its own sequence position).  Under M-RoPE
    without `positions3` every component takes the position.

    Writes this token's K/V into the caches IN PLACE (the reference
    returns updated copies; its caller donates the old ones) and returns
    (out, cache_k, cache_v).  A write position past the cache is clamped
    to its last cell, as `lax.dynamic_update_slice` clamps.  Under a
    grid whose cache is split along the sequence the step is
    `_attention_decode_seq`; a head-split cache holds this rank's KV
    heads."""
    ctx = tp.active()
    if ctx is not None and ctx.kv == "seq":
        return _attention_decode_seq(p, x, cache_k, cache_v, pos, cfg, dtype,
                                     positions3)
    B = x.shape[0]
    hd = cfg.head_dim
    S = cache_k.shape[1]
    q, k, v, posv = _decode_qkv(p, x, pos, cfg, dtype, positions3)
    at = posv[:, 0].clamp(0, S - 1)
    rows = torch.arange(B, device=x.device)
    cache_k[rows, at] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, at] = v[:, 0].to(cache_v.dtype)
    ck, cv = _local_kv(q, cache_k, cache_v, cfg)
    H, K = q.shape[2], ck.shape[2]
    G = H // K
    qh = q.reshape(B, 1, K, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qh,
                          cast(ck, dtype)) / math.sqrt(hd)
    scores = scores.float()
    # [B,1,1,1,S] per-row causal horizon (broadcasts over heads/groups)
    mask = (torch.arange(S, device=x.device)[None, :] <= posv)
    scores = scores.masked_fill(~mask[:, None, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, cast(cv, dtype))
    return out_proj(p, out.reshape(B, 1, H, hd), cfg, dtype), cache_k, cache_v


def _decode_qkv(p, x, pos, cfg, dtype, positions3):
    """The decode token's q, k, v and its positions [B, 1]."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    posv = pos[:, None] if pos.dim() == 1 else pos.expand(B, 1)
    if cfg.mrope and positions3 is None:
        positions3 = posv[:, None, :].expand(B, 3, 1)
    q, k, v = _qkv(p, x, cfg, dtype, posv, positions3)
    return q, k, v, posv


def _attention_decode_seq(p, x, cache_k, cache_v, pos, cfg, dtype,
                          positions3):
    """Decode over a cache split along the sequence (flash-decoding;
    `choose_kv_spec` picks it where the KV heads do not divide the
    model axis, so wk / wv are whole): model rank r holds positions
    [r·S, (r+1)·S) of every KV head, and only the owner of `pos`
    writes the new K/V.  Every rank attends all H query heads (gathered
    over the model axis where its weights hold some of them) over its
    slice; the partial softmaxes combine through an all_reduce MAX of
    the row maxima and one SUM of the rescaled sums and outputs.  Then
    wo takes this rank's heads' rows, summed over the model axis, or
    every row where the heads are whole."""
    ctx = tp.active()
    B, hd = x.shape[0], cfg.head_dim
    S = cache_k.shape[1]
    off = ctx.model_rank * S
    q, k, v, posv = _decode_qkv(p, x, pos, cfg, dtype, positions3)
    Hl = q.shape[2]
    at = posv[:, 0].clamp(0, S * ctx.model - 1) - off
    own = ((at >= 0) & (at < S))[:, None, None]
    # every row writes its slot, a row this rank does not own its slot's
    # own value back: no row count read from the data (`meta` tensors)
    rows, at = torch.arange(B, device=x.device), at.clamp(0, S - 1)
    cache_k[rows, at] = torch.where(own, k[:, 0].to(cache_k.dtype),
                                    cache_k[rows, at])
    cache_v[rows, at] = torch.where(own, v[:, 0].to(cache_v.dtype),
                                    cache_v[rows, at])
    if Hl < cfg.n_heads:
        q = tp.all_gather(q, dim=2)                   # [B, 1, H, hd]
    H, K = q.shape[2], cache_k.shape[2]
    qh = q.reshape(B, 1, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qh,
                          cast(cache_k, dtype)) / math.sqrt(hd)
    scores = scores.float()                           # [B, K, G, 1, S]
    mask = (off + torch.arange(S, device=x.device))[None, :] <= posv
    scores = scores.masked_fill(~mask[:, None, None, None, :], float("-inf"))
    # position 0 lies on rank 0, so every row's global maximum is finite
    m = tp.all_max(scores.amax(dim=-1, keepdim=True))
    e = torch.exp(scores - m)
    part = torch.cat([
        e.sum(dim=-1).reshape(B, -1),
        torch.einsum("bkgqs,bskh->bkgh", e, cache_v.float()).reshape(B, -1)],
        dim=1)
    part = tp.all_reduce(part)
    out = part[:, H:].reshape(B, K, H // K, hd) / part[:, :H].reshape(
        B, K, H // K, 1)
    out = out.reshape(B, 1, H, hd)
    if Hl < H:
        out = out[:, :, ctx.model_rank * Hl:(ctx.model_rank + 1) * Hl]
    return out_proj(p, out.to(dtype), cfg, dtype), cache_k, cache_v
