"""Mamba-2 (SSD, state-space duality) block, chunked matmul form, in plain
PyTorch.

Counterpart of `repro/models/mamba2.py`.  Within a chunk of length Q
every interaction is a dense product under a decay mask; across chunks
a small state [B, nh, hd, ds] is carried by a loop over the chunks
(where the reference scans).  The SSD products run in fp32 (PyTorch
keeps fp32 matmuls out of TF32 unless a caller allows it, and nothing
in the port does).

Decode is the O(1) recurrent update: h ← a·h + dt·x⊗B, y = C·h + D·x.

Under a grid a rank may hold its heads' part of a block
(`parallel.sharding.partition`: z, x, dt, A_log, D, dt_bias, the norm
scale and x's conv channels by heads, the B/C group whole): the widths
come from the weights, the gated norm's mean over d_inner sums over
the model axis and out_proj is row-parallel.  In training the block's
input is copied into the model axis (in_proj is column-parallel), the
gated norm's sum of squares passes its gradient back summed over the
model axis (each rank's channels read it), and the B/C columns of
in_proj and the conv, which every rank holds but reads only for its
heads, have their gradient summed over the model axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import tp
from .layers import Params, dense, dense_rows, init_dense


def init_mamba(gen: torch.Generator, cfg, device=None) -> Params:
    """in_proj normal/√d, conv_w normal·0.1, out_proj normal/√d_inner
    (drawn from `gen` in that order); conv_b and dt_bias 0, D and the
    gated norm's scale 1, A_log = log(linspace(1, 16, nh))."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, cw = cfg.ssm_heads, cfg.conv_width
    conv_dim = di + 2 * ds
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = init_dense(gen, d, 2 * di + 2 * ds + nh, device=device)
    conv_w = torch.randn((cw, conv_dim), generator=gen, **f32).mul_(0.1)
    return {
        "in_proj": in_proj,                       # z, x, B, C, dt
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm": torch.ones((di,), **f32),         # gated RMSNorm scale
        "out_proj": init_dense(gen, di, d, device=device),
    }


def _widths(p: Params, cfg) -> tuple[int, int]:
    """(d_inner, heads) this rank's block holds."""
    return p["norm"].shape[0], p["A_log"].shape[0]


def _split_proj(di, ds, zxbcdt):
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * ds]
    dt = zxbcdt[..., 2 * di + 2 * ds:]
    return z, xBC, dt


def _causal_conv(xBC, w, b, *, state=None):
    """Depthwise causal conv of width cw over xBC [B, S, Cd] (w [cw, Cd]),
    in xBC's dtype, then SiLU.  With `state` [B, cw-1, Cd] it streams
    (decode).  Returns (out, the last cw-1 inputs)."""
    cw = w.shape[0]
    if state is None:
        pad = xBC.new_zeros(xBC.shape[:1] + (cw - 1,) + xBC.shape[2:])
    else:
        pad = state.to(xBC.dtype)
    full = torch.cat([pad, xBC], dim=1)
    S = xBC.shape[1]
    wd = w.to(xBC.dtype)
    out = full[:, 0:S] * wd[0]
    for i in range(1, cw):
        out = out + full[:, i:i + S] * wd[i]
    out = F.silu(out + b.to(xBC.dtype))
    new_state = full[:, -(cw - 1):] if cw > 1 else None
    return out, new_state


def _gated_norm(y, z, scale, eps, d_inner):
    """RMS norm of y·silu(z) over d_inner (summed over the model axis
    where y holds this rank's channels of it)."""
    y32 = y.float() * F.silu(z.float())
    if y.shape[-1] < d_inner:
        var = tp.all_reduce(y32.square().sum(dim=-1, keepdim=True),
                            summed=True) / d_inner
    else:
        var = y32.square().mean(dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * scale).to(y.dtype)


def mamba_block(p: Params, x, cfg, dtype, *, initial_state=None):
    """x [B, S, d] → (y [B, S, d], state {"h" fp32 [B, nh, hd, ds],
    "conv" fp32 [B, cw-1, conv_dim]}).  S must be a multiple of
    min(ssm_chunk, S); `initial_state` continues a sequence."""
    B, S, _ = x.shape
    ds, hd = cfg.ssm_state, cfg.ssm_head_dim
    di, nh = _widths(p, cfg)
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    w_in, conv_w, conv_b = p["in_proj"]["w"], p["conv_w"], p["conv_b"]
    if di < cfg.d_inner:
        x = tp.copy_in(x)
        w_in = tp.copy_in(w_in, (1, 2 * di, 2 * di + 2 * ds))
        conv_w = tp.copy_in(conv_w, (1, di, di + 2 * ds))
        conv_b = tp.copy_in(conv_b, (0, di, di + 2 * ds))
    z, xBC, dt = _split_proj(di, ds, dense({"w": w_in}, x, dtype))
    xBC, conv_state = _causal_conv(
        xBC, conv_w, conv_b,
        state=None if initial_state is None else initial_state["conv"])
    xs = xBC[..., :di].reshape(B, S, nh, hd)
    Bm = xBC[..., di:di + ds].float()                 # [B, S, ds] (1 group)
    Cm = xBC[..., di + ds:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])        # [B, S, nh]
    A = -torch.exp(p["A_log"])                        # [nh], negative
    dA = dt * A                                       # log decay per step

    nq = S // Q
    xs32 = xs.float().reshape(B, nq, Q, nh, hd)
    Bm = Bm.reshape(B, nq, Q, ds)
    Cm = Cm.reshape(B, nq, Q, ds)
    dtc = dt.reshape(B, nq, Q, nh)
    seg = torch.cumsum(dA.reshape(B, nq, Q, nh), dim=2)

    # intra-chunk (the dual, quadratic form): L[q,s] = exp(seg_q - seg_s)
    # for q >= s, masked with -inf BEFORE exp (the upper triangle's
    # positive exponents would overflow)
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]   # [B,nq,Q,Q,nh]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    rel = rel.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    gate = torch.einsum("bnqs,bnts->bnqt", Cm, Bm)[..., None] * torch.exp(rel)
    xdt = xs32 * dtc[..., None]                       # [B,nq,Q,nh,hd]
    y_intra = torch.einsum("bnqth,bnthp->bnqhp", gate, xdt)

    # inter-chunk: each chunk's state contribution, then the carried state
    chunk_decay = torch.exp(seg[:, :, -1, :])         # [B, nq, nh]
    wdt = torch.exp(seg[:, :, -1:, :] - seg) * dtc    # [B, nq, Q, nh]
    state_in = torch.einsum("bnqs,bnqh,bnqhp->bnhps", Bm, wdt, xs32)
    h = (initial_state["h"].float() if initial_state is not None
         else x.new_zeros((B, nh, hd, ds), dtype=torch.float32))
    h_before = []
    for n in range(nq):                               # state BEFORE chunk n
        h_before.append(h)
        h = h * chunk_decay[:, n, :, None, None] + state_in[:, n]
    h_before = torch.stack(h_before, dim=1)           # [B, nq, nh, hd, ds]
    y_inter = torch.einsum("bnqs,bnhps,bnqh->bnqhp", Cm, h_before,
                           torch.exp(seg))
    y = (y_intra + y_inter).reshape(B, S, nh, hd)
    y = y + xs.float() * p["D"][:, None]
    y = _gated_norm(y.reshape(B, S, di).to(dtype), z, p["norm"], cfg.norm_eps,
                    cfg.d_inner)
    state = {"h": h, "conv": conv_state.float()}
    return dense_rows(p["out_proj"], y, dtype, cfg.d_inner), state


def mamba_decode_step(p: Params, x, state, cfg, dtype):
    """x [B, 1, d]; state {"h": [B, nh, hd, ds], "conv": [B, cw-1,
    conv_dim]} → (y [B, 1, d], new state: h fp32, conv in `dtype`)."""
    B = x.shape[0]
    ds, hd = cfg.ssm_state, cfg.ssm_head_dim
    di, nh = _widths(p, cfg)
    z, xBC, dt = _split_proj(di, ds, dense(p["in_proj"], x, dtype))
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                   state=state["conv"])
    xs = xBC[..., :di].reshape(B, nh, hd).float()
    Bm = xBC[:, 0, di:di + ds].float()                # [B, ds]
    Cm = xBC[:, 0, di + ds:].float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])  # [B, nh]
    a = torch.exp(dt * -torch.exp(p["A_log"]))        # [B, nh]
    upd = torch.einsum("bh,bhp,bs->bhps", dt, xs, Bm)
    h = state["h"].float() * a[:, :, None, None] + upd
    y = torch.einsum("bhps,bs->bhp", h, Cm)
    y = y + xs * p["D"][None, :, None]
    y = _gated_norm(y.reshape(B, 1, di).to(dtype), z, p["norm"], cfg.norm_eps,
                    cfg.d_inner)
    return (dense_rows(p["out_proj"], y, dtype, cfg.d_inner),
            {"h": h, "conv": conv_state})


def init_mamba_state(cfg, batch: int, device=None, model: int = 1):
    """Zeroed decode state, fp32 (as the reference's); `model` > 1
    sizes one rank's heads of it."""
    nh, hd, ds = cfg.ssm_heads // model, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner // model + 2 * ds
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, nh, hd, ds), **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim), **f32)}
