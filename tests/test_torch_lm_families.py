"""Port parity, the building blocks of the non-dense LM families:
`repro_torch.models.moe`, `models.mamba2` and the family additions to
`models.layers` (M-RoPE, sinusoidal positions, cross-attention),
against the reference package on the CPU.  Whole models are in
tests/test_torch_lm_families_model.py, which shares the helpers here.

Weights are drawn by the reference (`repro.models.transformer.init`,
or its `init_moe` / `init_mamba`) and carried across with `convert`;
inputs are numpy arrays from a seed, the same for both packages.
Tolerances: 1e-5 for a single layer and 1e-4 for a whole prefill in
float32 (sums in another order), 5e-2 in bf16 (the reference's own
bf16 tolerance between its decode and prefill paths).  At S = 512 both
packages route cross-attention through their flash kernel (the
reference's Pallas kernel in interpret mode, the port's K4 wrapper,
which runs its plain version on CPU tensors).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import mamba2 as RM
from repro.models import moe as RMoE
from repro.models import transformer as RT
from repro.serve.serve_step import cast_params_for_serving as ref_cast

from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MoE
from repro_torch.serve.serve_step import cast_params_for_serving

torch.set_num_threads(1)

FAMILIES = {"moe": "granite-moe-1b-a400m", "ssm": "mamba2-370m",
            "hybrid": "jamba-v0.1-52b", "encdec": "whisper-base",
            "vlm": "qwen2-vl-72b"}
ARCHS = list(FAMILIES.values())


def _cfgs(arch, **kw):
    """The arch's smoke config in both packages, float32 unless `dtype`
    is given, with `kw` applied."""
    kw.setdefault("dtype", "float32")
    return (ref_configs.get_smoke_config(arch).scaled(**kw),
            configs.get_smoke_config(arch).scaled(**kw))


@functools.lru_cache(maxsize=None)
def _ref_tree(arch, seed):
    """The reference's smoke weights (fp32 masters) as a numpy tree."""
    rcfg = ref_configs.get_smoke_config(arch)
    rp = jax.jit(lambda key: RT.init(rcfg, key))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, rp)


def _weights(arch, seed=0):
    tree = _ref_tree(arch, seed)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_reference(tree)


def _x(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _tree_close(got, want, tol):
    """Every leaf of two trees of like structure (torch / jax)."""
    g = jax.tree.leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, tol)


def _batch(cfg, B, S, seed=1):
    """numpy prompts for `cfg`'s family (the reference's input spec)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
                    np.float32),
                "positions3": np.broadcast_to(
                    np.arange(S, dtype=np.int32), (B, 3, S)).copy()}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    return batch


def _to_ref(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v) if v.dtype == np.int32
            else jnp.asarray(v, dtype) for k, v in batch.items()}


def _to_port(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v).to(dtype) for k, v in batch.items()}


def _ref_cache_layers(cfg, rc):
    """The reference's prefill / decode cache as the port's per-layer
    list: block leaves [n_blocks, ...] unstacked, block b position j
    being layer b·block_len + j."""
    blk = RT._block_len(cfg)
    return [jax.tree.map(lambda a, i=i: a[i // blk], rc["blocks"][f"l{i % blk}"])
            for i in range(cfg.n_layers)]


def _ref_cross(rc):
    kv = rc["cross_kv"]                  # [n_layers, 2, B, S, K, hd]
    return [{"k": kv[i, 0], "v": kv[i, 1]} for i in range(kv.shape[0])]


# ------------------------------------------------------------------ MoE ---
def _moe_params(cfg, seed=0):
    p = jax.jit(lambda k: RMoE.init_moe(k, cfg))(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, p)
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree))


def test_route_matches_reference():
    rcfg, pcfg = _cfgs("granite-moe-1b-a400m")
    rp, pp = _moe_params(rcfg)
    x = _x((40, rcfg.d_model), 3)
    rw, ri, raux = jax.jit(lambda p, x: RMoE._route(p, x, rcfg, jnp.float32))(
        rp, jnp.asarray(x))
    pw, pi, paux = MoE._route(pp, torch.from_numpy(x), pcfg, torch.float32)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    _close(pw, rw, 1e-5)
    _close(paux, raux, 1e-5)


def test_route_breaks_ties_to_the_lower_expert_as_top_k():
    """A zero router gives every expert the same probability: both
    packages pick experts 0..k-1 in order."""
    rcfg, pcfg = _cfgs("moonshot-v1-16b-a3b")
    rp, pp = _moe_params(rcfg)
    rp = {**rp, "router": {"w": jnp.zeros_like(rp["router"]["w"])}}
    pp = {**pp, "router": {"w": torch.zeros_like(pp["router"]["w"])}}
    x = _x((5, rcfg.d_model), 4)
    _, ri, _ = RMoE._route(rp, jnp.asarray(x), rcfg, jnp.float32)
    _, pi, _ = MoE._route(pp, torch.from_numpy(x), pcfg, torch.float32)
    want = np.broadcast_to(np.arange(rcfg.top_k), (5, rcfg.top_k))
    np.testing.assert_array_equal(np.asarray(ri), want)
    np.testing.assert_array_equal(pi.numpy(), want)


def test_moe_dense_matches_reference():
    rcfg, pcfg = _cfgs("granite-moe-1b-a400m")
    rp, pp = _moe_params(rcfg, 1)
    x = _x((2, 9, rcfg.d_model), 5)
    want, _ = jax.jit(lambda p, x: RMoE.moe_dense(p, x, rcfg, jnp.float32))(
        rp, jnp.asarray(x))
    got, _ = MoE.moe_dense(pp, torch.from_numpy(x), pcfg, torch.float32)
    _close(got, want, 1e-5)


def _ref_kept(rcfg, rp, x):
    """The (token, expert) pairs the reference's `moe_sorted` keeps: its
    `_route` and its dispatch lines (`repro/models/moe.py:79-96`)."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    N = xf.shape[0]
    _, idx, _ = RMoE._route(rp, xf, rcfg, jnp.float32)
    k, E = rcfg.top_k, rcfg.n_experts
    C = max(1, int((N * k) / E * rcfg.capacity_factor))
    flat_e = idx.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(N, dtype=jnp.int32), k)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    counts = jnp.bincount(se, length=E)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(se.shape[0]) - starts[se]
    keep = np.asarray(rank < C)
    return {(int(t), int(e)) for t, e, kp in
            zip(np.asarray(st), np.asarray(se), keep) if kp}, len(keep)


@pytest.mark.parametrize("cf", [1.25, 1.0], ids=["cf1.25", "cf1.0"])
def test_moe_sorted_matches_reference(cf):
    """Sorted dispatch with capacity drops: the same kept (token,
    expert) set as the reference and the same output."""
    rcfg, pcfg = _cfgs("granite-moe-1b-a400m", capacity_factor=cf)
    rp, pp = _moe_params(rcfg, 2)
    x = _x((2, 24, rcfg.d_model), 6)
    want, _ = jax.jit(lambda p, x: RMoE.moe_sorted(p, x, rcfg, jnp.float32))(
        rp, jnp.asarray(x))
    got, _ = MoE.moe_sorted(pp, torch.from_numpy(x), pcfg, torch.float32)
    _close(got, want, 1e-5)
    ref_kept, pairs = _ref_kept(rcfg, rp, x)
    _, idx, _ = MoE._route(pp, torch.from_numpy(x).reshape(-1, pcfg.d_model),
                           pcfg, torch.float32)
    order, token, keep, slot, C = MoE.dispatch(idx, pcfg)
    se = idx.reshape(-1)[order]
    kept = {(int(t), int(e)) for t, e, kp in zip(token, se, keep) if kp}
    assert kept == ref_kept
    assert C == MoE.capacity(48, pcfg)
    if cf == 1.0:
        assert len(kept) < pairs           # this case drops pairs
    assert int(slot.max()) <= pcfg.n_experts * C


def test_moe_sorted_matches_dense_reference():
    """Port of tests/test_arch_smoke.py: with a generous capacity nothing
    drops, and the sorted dispatch equals the dense one."""
    _, pcfg = _cfgs("granite-moe-1b-a400m", capacity_factor=8.0)
    rcfg = ref_configs.get_smoke_config("granite-moe-1b-a400m")
    _, pp = _moe_params(rcfg, 0)
    x = torch.from_numpy(_x((2, 16, pcfg.d_model), 1))
    a, _ = MoE.moe_dense(pp, x, pcfg, torch.float32)
    b, _ = MoE.moe_sorted(pp, x, pcfg, torch.float32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_moe_sorted_matches_reference_bf16():
    rcfg, pcfg = _cfgs("granite-moe-1b-a400m", dtype="bfloat16")
    rp, pp = _moe_params(rcfg, 3)
    x = _x((2, 16, rcfg.d_model), 7)
    want, _ = jax.jit(lambda p, x: RMoE.moe_sorted(p, x, rcfg, jnp.bfloat16))(
        ref_cast(rp, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    got, _ = MoE.moe_sorted(cast_params_for_serving(pp),
                            torch.from_numpy(x).bfloat16(), pcfg,
                            torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, want, 5e-2)


# ---------------------------------------------------------------- Mamba ---
def _mamba_params(cfg, seed=0):
    p = jax.jit(lambda k: RM.init_mamba(k, cfg))(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, p)
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree))


@pytest.mark.parametrize("carried", [False, True],
                         ids=["fresh", "initial_state"])
def test_mamba_block_matches_reference(carried):
    rcfg, pcfg = _cfgs("mamba2-370m")
    rp, pp = _mamba_params(rcfg, 1)
    x = _x((2, 32, rcfg.d_model), 2, 0.5)
    rinit = pinit = None
    if carried:
        st = {"h": _x((2, rcfg.ssm_heads, rcfg.ssm_head_dim, rcfg.ssm_state),
                      3, 0.3),
              "conv": _x((2, rcfg.conv_width - 1,
                          rcfg.d_inner + 2 * rcfg.ssm_state), 4, 0.3)}
        rinit = jax.tree.map(jnp.asarray, st)
        pinit = jax.tree.map(torch.from_numpy, st)
    wy, wst = jax.jit(lambda p, x, s: RM.mamba_block(
        p, x, rcfg, jnp.float32, initial_state=s))(rp, jnp.asarray(x), rinit)
    gy, gst = M.mamba_block(pp, torch.from_numpy(x), pcfg, torch.float32,
                            initial_state=pinit)
    _close(gy, wy, 1e-5)
    assert gst["h"].dtype == gst["conv"].dtype == torch.float32
    _tree_close(gst, wst, 1e-5)


def test_mamba_block_matches_reference_bf16():
    rcfg, pcfg = _cfgs("mamba2-370m", dtype="bfloat16")
    rp, pp = _mamba_params(rcfg, 2)
    x = _x((2, 32, rcfg.d_model), 5, 0.5)
    wy, wst = jax.jit(lambda p, x: RM.mamba_block(p, x, rcfg, jnp.bfloat16))(
        ref_cast(rp, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    gy, gst = M.mamba_block(cast_params_for_serving(pp),
                            torch.from_numpy(x).bfloat16(), pcfg,
                            torch.bfloat16)
    assert gy.dtype == torch.bfloat16
    _close(gy, wy, 5e-2)
    _tree_close(gst, wst, 5e-2)


def test_mamba_decode_step_matches_reference():
    rcfg, pcfg = _cfgs("mamba2-370m")
    rp, pp = _mamba_params(rcfg, 3)
    x = _x((3, 1, rcfg.d_model), 6, 0.5)
    st = {"h": _x((3, rcfg.ssm_heads, rcfg.ssm_head_dim, rcfg.ssm_state),
                  7, 0.3),
          "conv": _x((3, rcfg.conv_width - 1,
                      rcfg.d_inner + 2 * rcfg.ssm_state), 8, 0.3)}
    wy, wst = jax.jit(lambda p, x, s: RM.mamba_decode_step(
        p, x, s, rcfg, jnp.float32))(rp, jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, st))
    gy, gst = M.mamba_decode_step(pp, torch.from_numpy(x),
                                  jax.tree.map(torch.from_numpy, st), pcfg,
                                  torch.float32)
    _close(gy, wy, 1e-5)
    _tree_close(gst, wst, 1e-5)


def test_mamba_chunked_matches_stepwise():
    """Port of tests/test_arch_smoke.py: the chunked SSD over 16 tokens
    equals 16 recurrent decode steps, output and final state."""
    _, pcfg = _cfgs("mamba2-370m", ssm_chunk=8)
    _, pp = _mamba_params(pcfg, 0)
    x = torch.from_numpy(_x((1, 16, pcfg.d_model), 1, 0.5))
    y_chunk, final = M.mamba_block(pp, x, pcfg, torch.float32)
    state = M.init_mamba_state(pcfg, 1)
    outs = []
    for t in range(16):
        o, state = M.mamba_decode_step(pp, x[:, t:t + 1], state, pcfg,
                                       torch.float32)
        outs.append(o)
    np.testing.assert_allclose(y_chunk.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(final["h"].numpy(), state["h"].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_mamba_block_refuses_a_ragged_chunk():
    _, pcfg = _cfgs("mamba2-370m")
    _, pp = _mamba_params(pcfg, 0)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        M.mamba_block(pp, torch.zeros(1, 20, pcfg.d_model), pcfg,
                      torch.float32)


# --------------------------------------------------------------- layers ---
@pytest.mark.parametrize("hd", [16, 128])
def test_apply_mrope_matches_reference(hd):
    x = _x((2, 7, 4, hd), 1)
    p3 = np.stack([np.arange(7), np.arange(7) * 3 + 1,
                   np.arange(7)[::-1] * 100], 0).astype(np.int32)
    p3 = np.broadcast_to(p3, (2, 3, 7)).copy()
    sec = RL._mrope_sections(hd)
    assert L._mrope_sections(hd) == sec
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6, sec)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), 1e6, sec)
    _close(got, want, 1e-5)


def test_sinusoidal_positions_match_reference():
    _close(L.sinusoidal_positions(33, 64), RL.sinusoidal_positions(33, 64),
           1e-5)


def _layer(arch, name, i=0):
    """Layer i's `name` params ("attn", "cross", ...) in both packages."""
    rp, pp = _weights(arch)
    if name == "cross":
        return (jax.tree.map(lambda a: a[i], rp["cross"]["attn"]),
                pp["cross"][i]["attn"])
    blk = RT._block_len(ref_configs.get_smoke_config(arch))
    return (jax.tree.map(lambda a: a[i // blk], rp["blocks"][f"l{i % blk}"][name]),
            pp["layers"][i][name])


@pytest.mark.parametrize("S,flash", [(12, False), (512, True)],
                         ids=["plain", "flash"])
def test_cross_attention_and_enc_kv_match_reference(S, flash):
    arch = "whisper-base"
    rcfg, pcfg = _cfgs(arch)
    ra, pa = _layer(arch, "cross", 1)
    x, enc = _x((2, S, pcfg.d_model), 1), _x((2, S, pcfg.d_model), 2)
    rkv = RL.enc_kv(ra, jnp.asarray(enc), rcfg, jnp.float32)
    pkv = L.enc_kv(pa, torch.from_numpy(enc), pcfg, torch.float32)
    _tree_close(pkv, rkv, 1e-5)
    want = jax.jit(lambda p, x, kv: RL.cross_attention(
        p, x, kv, rcfg, jnp.float32, flash=flash))(ra, jnp.asarray(x), rkv)
    got = L.cross_attention(pa, torch.from_numpy(x), pkv, pcfg,
                            torch.float32, flash=flash)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("given", [False, True], ids=["broadcast", "given"])
def test_attention_decode_with_mrope_matches_reference(given):
    """M-RoPE in decode: without positions3 every component takes the
    row's position; given, its own components."""
    arch = "qwen2-vl-72b"
    rcfg, pcfg = _cfgs(arch)
    ra, pa = _layer(arch, "attn", 1)
    B, S = 3, 10
    x = _x((B, 1, pcfg.d_model), 5)
    ck = _x((B, S, pcfg.n_kv_heads, pcfg.head_dim), 6)
    cv = _x((B, S, pcfg.n_kv_heads, pcfg.head_dim), 7)
    pos = np.array([2, 9, 5], np.int32)
    p3 = (np.stack([pos, pos + 1, pos * 2], 1)[:, :, None].astype(np.int32)
          if given else None)
    wo, wk, wv = jax.jit(lambda *a: RL.attention_decode(
        *a[:5], rcfg, jnp.float32, positions3=a[5]))(
        ra, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos), None if p3 is None else jnp.asarray(p3))
    go, gk, gv = L.attention_decode(
        pa, torch.from_numpy(x), torch.from_numpy(ck.copy()),
        torch.from_numpy(cv.copy()), torch.from_numpy(pos), pcfg,
        torch.float32, positions3=None if p3 is None else torch.from_numpy(p3))
    _close(go, wo, 1e-5)
    _close(gk, wk, 1e-5)
    _close(gv, wv, 1e-5)


def test_attention_with_positions3_matches_reference():
    arch = "qwen2-vl-72b"
    rcfg, pcfg = _cfgs(arch)
    ra, pa = _layer(arch, "attn", 0)
    S = 12
    x = _x((2, S, pcfg.d_model), 8)
    p3 = np.broadcast_to(np.stack([np.arange(S), np.arange(S) // 2,
                                   np.arange(S) % 3]), (2, 3, S))
    p3 = p3.astype(np.int32).copy()
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want = jax.jit(lambda p, x, a, b: RL.attention(
        p, x, rcfg, jnp.float32, positions=a, positions3=b))(
        ra, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(p3))
    got = L.attention(pa, torch.from_numpy(x), pcfg, torch.float32,
                      positions=torch.from_numpy(pos),
                      positions3=torch.from_numpy(p3))
    _close(got, want, 1e-5)
