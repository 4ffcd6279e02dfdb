"""Port parity, whole models of the non-dense LM families (moe, ssm,
hybrid, encdec, vlm): `models.transformer`'s prefill, cache and decode,
`convert.lm_params_from_reference` and the layer-by-layer serving init,
against the reference package on the CPU.

Weights are the reference's smoke weights carried across with
`convert`; prompts are numpy arrays from a seed (helpers shared with
tests/test_torch_lm_families.py).  Tolerances: 1e-4 for a whole prefill
or decode step in float32, 5e-2 in bf16.  At S = 512 the reference runs
its Pallas kernel in interpret mode and the port routes the same
attention calls through K4's wrapper as on a card, with the kernel
replaced by its plain version.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_families import (ARCHS, _batch, _cfgs, _close,
                                    _ref_cache_layers, _ref_cross, _ref_tree,
                                    _to_port, _to_ref, _tree_close, _weights)

from repro import configs as ref_configs
from repro.models import transformer as RT
from repro.serve.serve_step import cast_params_for_serving as ref_cast
from repro.serve.session import seed_cache as ref_seed_cache

from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import transformer as T
from repro_torch.serve.serve_step import cast_params_for_serving
from repro_torch.serve.session import seed_cache

torch.set_num_threads(1)


# ---------------------------------------------------------- whole model ---
@functools.lru_cache(maxsize=None)
def _ref_prefill_np(arch, B, S, dtype="float32", **kw):
    """The reference's prefill of `arch`'s smoke config (weights from
    seed 0, prompts `_batch(B, S)`), as numpy."""
    rcfg = ref_configs.get_smoke_config(arch).scaled(dtype=dtype, **kw)
    rp, _ = _weights(arch)
    if dtype == "bfloat16":
        rp = ref_cast(rp, jnp.bfloat16)
    jdt = getattr(jnp, dtype)
    out = jax.jit(RT.prefill_fn(rcfg))(rp, _to_ref(_batch(rcfg, B, S), jdt))
    return jax.tree.map(np.asarray, out)


def _port_prefill(arch, B, S, dtype="float32", **kw):
    _, pcfg = _cfgs(arch, dtype=dtype, **kw)
    _, pp = _weights(arch)
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        pp = cast_params_for_serving(pp)
    with torch.inference_mode():
        return T.prefill_fn(pcfg)(pp, _to_port(_batch(pcfg, B, S), tdt))


def _check_prefill_cache(arch, rcache, pcache, tol):
    rcfg = ref_configs.get_smoke_config(arch)
    if rcfg.family == "encdec":
        assert set(pcache) == {"cross_kv"}
        _tree_close(pcache["cross_kv"], _ref_cross(rcache), tol)
        return
    assert set(pcache) == {"layers"}
    _tree_close(pcache["layers"], _ref_cache_layers(rcfg, rcache), tol)


def _seq(arch):
    """Prompt length of the whole-model cases: two SSD chunks of the
    smoke configs (16 tokens each), one for jamba's 8-layer stack."""
    return 16 if arch == "jamba-v0.1-52b" else 32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference_f32(arch):
    S = _seq(arch)
    rl, rcache = _ref_prefill_np(arch, 2, S)
    pl, pcache = _port_prefill(arch, 2, S)
    assert pl.dtype == torch.float32 and pl.shape == rl.shape
    _close(pl, rl, 1e-4)
    _check_prefill_cache(arch, rcache, pcache, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference_bf16(arch):
    S = _seq(arch)
    rl, _ = _ref_prefill_np(arch, 2, S, "bfloat16")
    pl, _ = _port_prefill(arch, 2, S, "bfloat16")
    _close(pl, rl, 5e-2)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-base"])
def test_prefill_at_512_routes_k4(arch, monkeypatch):
    """S = 512: the reference runs its Pallas kernel (interpret mode) in
    every attention; the port routes the same calls through K4's wrapper
    as on a card, once per flash-eligible call (2 self-attention layers
    for granite-moe; 2 encoder, 2 decoder and 2 cross for whisper)."""
    calls = []

    def stub(q, k, v, *, causal=True):
        calls.append((tuple(q.shape), causal))
        return flash_attention_ref(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "_route", lambda device: "kernel")
    monkeypatch.setattr(ops._k4, "flash_attention_cuda", stub)
    rl, rcache = _ref_prefill_np(arch, 1, 512)
    ops.reset_launches()
    pl, pcache = _port_prefill(arch, 1, 512)
    pcfg = configs.get_smoke_config(arch)
    assert ops.launches["flash"] == T.flash_calls(pcfg) == len(calls)
    ops.reset_launches()
    if arch == "whisper-base":
        # encoder (bidirectional), then per decoder layer self then cross
        assert [c for _, c in calls] == [False, False, True, False,
                                         True, False]
    else:
        assert all(c for _, c in calls)
    _close(pl, rl, 1e-4)
    _check_prefill_cache(arch, rcache, pcache, 1e-4)


def _ref_decode(rcfg, rp, rcache, toks, pos):
    return jax.jit(RT.decode_fn(rcfg))(rp, jnp.asarray(toks), rcache,
                                       jnp.asarray(pos))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Prefill, seed a decode cache in both packages, then two greedy
    decode steps: logits, caches and tokens equal within tolerance (the
    SSM conv state the reference keeps in bf16 after a step compares
    with the port's fp32 leaf)."""
    rcfg, pcfg = _cfgs(arch)
    rp, pp = _weights(arch)
    B, S, steps = 2, _seq(arch), 2
    rl, rpc = _ref_prefill_np(arch, B, S)
    pl, ppc = _port_prefill(arch, B, S)
    rcache = ref_seed_cache(RT.init_cache(rcfg, B, S + steps, jnp.float32),
                            jax.tree.map(jnp.asarray, rpc), S)
    pcache = seed_cache(T.init_cache(pcfg, B, S + steps, torch.float32),
                        ppc, S)
    tok = np.argmax(rl, -1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(pl.argmax(-1).numpy(), tok[:, 0])
    for i in range(steps):
        rl, rcache = _ref_decode(rcfg, rp, rcache, tok, S + i)
        with torch.inference_mode():
            pl, pcache = T.decode_fn(pcfg)(pp, torch.from_numpy(tok).long(),
                                           pcache, S + i)
        _close(pl, rl, 1e-4)
        tok = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(pl.argmax(-1).numpy(), tok[:, 0])
    _tree_close(pcache["layers"], _ref_cache_layers(rcfg, rcache), 1e-4)
    if rcfg.family == "encdec":
        _tree_close(pcache["cross_kv"], _ref_cross(rcache), 1e-4)


# -------------------------------------------------------------- convert ---
@pytest.mark.parametrize("arch", ARCHS)
def test_convert_gives_the_ports_tree(arch):
    """Each family's reference tree converts to the port's layout (the
    dense one: tests/test_torch_lm.py): the
    same leaf shapes as the port's own init, each stacked leaf split
    along its block / layer axis."""
    cfg = configs.get_smoke_config(arch)
    tree = _ref_tree(arch, 0)
    pp = lm_params_from_reference(tree)
    mine = T.init(cfg, 3)
    assert (jax.tree.map(lambda t: tuple(t.shape), pp)
            == jax.tree.map(lambda t: tuple(t.shape), mine))
    blk = RT._block_len(cfg)
    assert len(pp["layers"]) == cfg.n_layers
    last = cfg.n_layers - 1
    for path, leaf in jax.tree_util.tree_leaves_with_path(pp["layers"][last]):
        names = [p.key for p in path]
        src = tree["blocks"][f"l{last % blk}"]
        for n in names:
            src = src[n]
        np.testing.assert_array_equal(leaf.numpy(), src[last // blk])
    if cfg.family == "encdec":
        assert len(pp["encoder"]) == cfg.enc_layers
        assert len(pp["cross"]) == cfg.n_layers
        np.testing.assert_array_equal(pp["cross"][1]["attn"]["wk"]["w"],
                                      tree["cross"]["attn"]["wk"]["w"][1])
        np.testing.assert_array_equal(pp["encoder"][1]["mlp"]["up"]["w"],
                                      tree["encoder"]["mlp"]["up"]["w"][1])


def test_convert_unstacks_jamba_superblocks():
    """jamba's 8-layer superblock: layer i is block i // 8, position
    i % 8; Mamba in 7 of them, attention in the last, MoE in odd ones."""
    arch = "jamba-v0.1-52b"
    cfg = configs.get_smoke_config(arch)
    assert T._block_len(cfg) == RT._block_len(ref_configs.get_config(arch)) \
        == 8
    pp = lm_params_from_reference(_ref_tree(arch, 0))
    assert [("attn" in lp, "router" in lp.get("mlp", {}))
            for lp in pp["layers"]] == [
        (i == 7, i % 2 == 1) for i in range(8)]
    assert pp["layers"][1]["mlp"]["gate"].shape == (
        cfg.n_experts, cfg.d_model, cfg.d_expert)
    assert pp["layers"][0]["ssm"]["A_log"].shape == (cfg.ssm_heads,)


# ------------------------------------------------------------------ init ---
@pytest.mark.parametrize("arch", ARCHS)
def test_layerwise_serving_init_equals_init_then_cast(arch):
    """Drawing and casting one part at a time gives, bit for bit, the
    tree that drawing all fp32 masters and casting them gives."""
    cfg = configs.get_smoke_config(arch)
    whole = cast_params_for_serving(T.init(cfg, 11))
    parts = T.init(cfg, 11, cast=cast_params_for_serving)
    a, b = jax.tree.leaves(whole), jax.tree.leaves(parts)
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert any(x.dtype == torch.bfloat16 for x in b)
    if cfg.n_experts:
        assert parts["layers"][-1]["mlp"]["router"]["w"].dtype == \
            torch.float32
