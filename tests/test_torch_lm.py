"""Port parity, LM serving path (dense family; the others are in
tests/test_torch_lm_families*.py): `repro_torch.models`,
`serve/`, `train/checkpoint.py`, `launch/serve.py` and the copied
configs, against the reference package on the CPU.

Weights are drawn by the reference (`repro.models.transformer.init`) and
carried across with `convert.lm_params_from_reference`; prompts are the
same numpy tokens for both packages.  Tolerances: 1e-5 for single layers
and 1e-4 for whole prefills in float32 (sums in another order); bf16 is
held to 5e-2, the reference's own bf16 tolerance between its decode
and prefill paths (tests/test_serve_consistency.py).  At S = 512 both
packages route prefill attention through their flash kernel (the
reference's Pallas kernel in interpret mode, the port's K4 wrapper,
which runs its plain version on CPU tensors).
"""
import ast
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve.serve_step import cast_params_for_serving as ref_cast
from repro.serve.session import seed_cache as ref_seed_cache

from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.gateway import (Gateway, LMDecodeWorkload,
                                       RoundScheduler, Share, StepReport)
from repro_torch.serve.serve_step import cast_params_for_serving
from repro_torch.serve.session import LMSession, fake_prompts, seed_cache
from repro_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ARCH = "qwen3-1.7b"


def _smoke(dtype="float32"):
    """The qwen3-1.7b smoke config (2 layers, d 64, hd 16) in both
    packages, in `dtype`."""
    return (ref_configs.get_smoke_config(ARCH).scaled(dtype=dtype),
            configs.get_smoke_config(ARCH).scaled(dtype=dtype))


@functools.lru_cache(maxsize=None)
def _ref_weights(seed):
    """The reference's smoke weights (fp32 masters: the same for every
    compute dtype) as a numpy tree."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp = jax.jit(lambda key: RT.init(rcfg, key))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, rp)


def _weights(rcfg, seed=0):
    """Reference weights (jax arrays) and the port's copy of them."""
    assert rcfg.name == ARCH and rcfg.n_layers == 2
    np_tree = _ref_weights(seed)
    return (jax.tree.map(jnp.asarray, np_tree),
            lm_params_from_reference(np_tree))


def _tokens(B, S, vocab, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------- configs ---
def _code_dump(path: pathlib.Path) -> str:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], "value", None), ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


COPIES = [f"configs/{m}.py" for m in (
    "base", "granite_34b", "granite_moe_1b_a400m", "jamba_v0_1_52b",
    "mamba2_370m", "minitron_4b", "moonshot_v1_16b_a3b", "qwen2_vl_72b",
    "qwen3_1_7b", "qwen3_4b", "whisper_base")] + ["serve/scheduler.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    """Carried by copy: same code once docstrings are set aside."""
    assert (_code_dump(SRC / "repro_torch" / rel)
            == _code_dump(SRC / "repro" / rel))


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_config_fields_match_reference(arch):
    assert configs.ARCHS == ref_configs.ARCHS
    for get in ("get_config", "get_smoke_config"):
        port = getattr(configs, get)(arch)
        ref = getattr(ref_configs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    assert configs.supported_shapes(arch) == ref_configs.supported_shapes(arch)


# -------------------------------------------------------------- layers ---
def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_rms_norms_match_reference():
    x, scale = _x((2, 5, 64)), _x((64,), 1)
    want = RL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = L.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    xh, sh = _x((2, 5, 4, 16), 2), _x((16,), 3)
    want = RL.head_rms_norm(jnp.asarray(xh), jnp.asarray(sh), 1e-6)
    got = L.head_rms_norm(torch.from_numpy(xh), torch.from_numpy(sh))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_apply_rope_matches_reference():
    """Split-half rotation at large positions (fp32 angles)."""
    x = _x((2, 7, 4, 16))
    pos = np.array([[0, 1, 2, 3, 100, 511, 4095]] * 2, np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_swiglu_mlp_matches_reference():
    p = {n: {"w": _x(s, i)} for i, (n, s) in enumerate(
        (("gate", (64, 128)), ("up", (64, 128)), ("down", (128, 64))))}
    x = _x((2, 5, 64), 9) * 0.1
    want = RL.swiglu_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                         jnp.float32)
    got = L.swiglu_mlp(jax.tree.map(torch.from_numpy, p),
                       torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def _attn_params(rcfg, seed=0):
    rp, port = _weights(rcfg, seed)
    ra = jax.tree.map(lambda a: a[0], rp["blocks"]["l0"]["attn"])
    return ra, port["layers"][0]["attn"]


@pytest.mark.parametrize("S,flash,q_chunk", [(12, False, 0),
                                             (512, True, 0),
                                             (512, False, 128)],
                         ids=["plain", "flash", "chunked"])
def test_attention_matches_reference(S, flash, q_chunk):
    rcfg, pcfg = _smoke()
    ra, pa = _attn_params(rcfg)
    x = _x((2, S, pcfg.d_model), 4)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want = jax.jit(lambda p, x, pos: RL.attention(
        p, x, rcfg, jnp.float32, positions=pos, flash=flash,
        q_chunk=q_chunk))(ra, jnp.asarray(x), jnp.asarray(pos))
    got = L.attention(pa, torch.from_numpy(x), pcfg, torch.float32,
                      positions=torch.from_numpy(pos.copy()), flash=flash,
                      q_chunk=q_chunk)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_attention_decode_matches_reference(per_row):
    rcfg, pcfg = _smoke()
    ra, pa = _attn_params(rcfg)
    B, S = 3, 10
    x = _x((B, 1, pcfg.d_model), 5)
    ck = _x((B, S, pcfg.n_kv_heads, pcfg.head_dim), 6)
    cv = _x((B, S, pcfg.n_kv_heads, pcfg.head_dim), 7)
    pos = np.array([2, 9, 5], np.int32) if per_row else np.int32(4)
    wo, wk, wv = jax.jit(lambda *a: RL.attention_decode(
        *a, rcfg, jnp.float32))(ra, jnp.asarray(x), jnp.asarray(ck),
                                jnp.asarray(cv), jnp.asarray(pos))
    go, gk, gv = L.attention_decode(pa, torch.from_numpy(x),
                                    torch.from_numpy(ck.copy()),
                                    torch.from_numpy(cv.copy()),
                                    torch.from_numpy(np.asarray(pos)),
                                    pcfg, torch.float32)
    np.testing.assert_allclose(_np(go), _np(wo), atol=1e-5)
    np.testing.assert_allclose(_np(gk), _np(wk), atol=1e-5)
    np.testing.assert_allclose(_np(gv), _np(wv), atol=1e-5)


def test_sdpa_any_keeps_the_reference_dispatch_rule():
    q = torch.zeros(1, 512, 4, 128)
    k = torch.zeros(1, 512, 2, 128)
    assert L.flash_eligible(q, k)
    assert not L.flash_eligible(q[:, :256], k[:, :256])      # S % 512
    assert not L.flash_eligible(q, k[:, :511])                # Sq != Sk
    assert not L.flash_eligible(torch.zeros(1, 512, 4, 144),
                                torch.zeros(1, 512, 2, 144))  # hd > 128


# ---------------------------------------------------------- whole model ---
def _ref_prefill(rcfg, rp, toks):
    return jax.jit(RT.prefill_fn(rcfg))(rp, {"tokens": jnp.asarray(toks)})


def _port_prefill(pcfg, pp, toks, **kw):
    with torch.inference_mode():
        return T.prefill_fn(pcfg, **kw)(
            pp, {"tokens": torch.from_numpy(toks).long()})


@pytest.fixture(scope="module")
def prefill_512():
    """Reference and port prefills of the float32 smoke config at
    S = 512 (the flash route in both) on the same weights and tokens."""
    rcfg, pcfg = _smoke()
    rp, pp = _weights(rcfg)
    toks = _tokens(2, 512, pcfg.vocab)
    return _ref_prefill(rcfg, rp, toks), _port_prefill(pcfg, pp, toks)


def test_prefill_logits_match_reference_f32(prefill_512):
    (rl, _), (pl, _) = prefill_512
    assert pl.dtype == torch.float32 and pl.shape == (2, 256)
    np.testing.assert_allclose(_np(pl), _np(rl), atol=1e-4)


def test_prefill_cache_matches_reference_f32(prefill_512):
    (_, rc), (_, pc) = prefill_512
    assert len(pc["layers"]) == 2
    for i, lc in enumerate(pc["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _np(lc[name]), _np(rc["blocks"]["l0"][name][i]), atol=1e-4)


def test_prefill_logits_match_reference_bf16():
    rcfg, pcfg = _smoke("bfloat16")
    rp, pp = _weights(rcfg)
    toks = _tokens(2, 512, pcfg.vocab)
    rl, _ = _ref_prefill(rcfg, ref_cast(rp, jnp.bfloat16), toks)
    pl, _ = _port_prefill(pcfg, cast_params_for_serving(pp), toks)
    np.testing.assert_allclose(_np(pl), _np(rl), atol=5e-2, rtol=5e-2)


def test_greedy_tokens_match_reference_f32():
    """Prefill then three greedy decode steps: the same tokens."""
    rcfg, pcfg = _smoke()
    rp, pp = _weights(rcfg, seed=3)
    B, S, steps = 2, 8, 3
    toks = _tokens(B, S, pcfg.vocab, seed=11)
    rl, rpc = _ref_prefill(rcfg, rp, toks)
    rcache = ref_seed_cache(RT.init_cache(rcfg, B, S + steps, jnp.float32),
                            rpc, S)
    rdec = jax.jit(RT.decode_fn(rcfg))
    pl, ppc = _port_prefill(pcfg, pp, toks)
    pcache = seed_cache(T.init_cache(pcfg, B, S + steps, torch.float32),
                        ppc, S)
    pdec = T.decode_fn(pcfg)
    rtok, ptok = jnp.argmax(rl, -1)[:, None], pl.argmax(-1)[:, None]
    seq_r, seq_p = [np.asarray(rtok)], [ptok.numpy()]
    for i in range(steps):
        rl, rcache = rdec(rp, rtok.astype(jnp.int32), rcache,
                          jnp.asarray(S + i))
        with torch.inference_mode():
            pl, pcache = pdec(pp, ptok, pcache, S + i)
        np.testing.assert_allclose(_np(pl), _np(rl), atol=1e-4)
        rtok, ptok = jnp.argmax(rl, -1)[:, None], pl.argmax(-1)[:, None]
        seq_r.append(np.asarray(rtok))
        seq_p.append(ptok.numpy())
    np.testing.assert_array_equal(np.concatenate(seq_p, 1),
                                  np.concatenate(seq_r, 1))


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 5e-2),
                                       ("float32", 1e-4)])
def test_decode_matches_prefill_logits(dtype, tol):
    """Port of tests/test_serve_consistency.py: prefill the first S-1
    tokens, decode token S-1 with the cache; its logits match the full
    prefill's last-position logits."""
    pcfg = configs.get_smoke_config(ARCH).scaled(dtype=dtype)
    B, S = 2, 12
    params = cast_params_for_serving(T.init(pcfg, 0), getattr(torch, dtype))
    toks = fake_prompts(pcfg, B, S, seed=7)["tokens"]
    with torch.inference_mode():
        full, _ = T.prefill_fn(pcfg)(params, {"tokens": toks})
        _, pc = T.prefill_fn(pcfg)(params, {"tokens": toks[:, :S - 1]})
        cache = seed_cache(T.init_cache(pcfg, B, S, getattr(torch, dtype)),
                           pc, S - 1)
        dec, _ = T.decode_fn(pcfg)(params, toks[:, S - 1:], cache, S - 1)
    np.testing.assert_allclose(_np(dec), _np(full), rtol=tol, atol=tol)


def test_flash_counter_reads_n_layers_per_prefill(monkeypatch):
    """With the launch stubbed (CPU tensors routed as if on a card, the
    kernel replaced by its plain version), a prefill at S = 512 launches
    K4 once per layer; at S = 12 (not a multiple of 512) and in decode
    it launches nothing."""
    calls = []

    def stub(q, k, v, *, causal=True):
        calls.append(tuple(q.shape))
        return flash_attention_ref(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "_route", lambda device: "kernel")
    monkeypatch.setattr(ops._k4, "flash_attention_cuda", stub)
    pcfg = configs.get_smoke_config(ARCH)
    params = cast_params_for_serving(T.init(pcfg, 0))
    for S, want in ((512, pcfg.n_layers), (12, 0)):
        toks = fake_prompts(pcfg, 2, S, seed=1)["tokens"]
        ops.reset_launches()
        with torch.inference_mode():
            _, pc = T.prefill_fn(pcfg)(params, {"tokens": toks})
        assert ops.launches["flash"] == want
        ops.reset_launches()
        cache = seed_cache(T.init_cache(pcfg, 2, S + 1), pc, S)
        with torch.inference_mode():
            T.decode_fn(pcfg)(params, toks[:, :1], cache, S)
        assert ops.launches["flash"] == 0
    s = LMSession(ARCH, smoke=True, batch=1, prompt_len=512, gen=2,
                  device="cpu")
    s.start()
    s.decode_steps(2)
    s.evict(0)
    s.admit()
    assert s.metrics()["flash_launches"] == 2 * pcfg.n_layers
    # rows [B·H, S, hd]: 2 sequences × 4 query heads, 16-wide heads
    assert calls == ([(8, 512, 16)] * pcfg.n_layers
                     + [(4, 512, 16)] * 2 * pcfg.n_layers)
    ops.reset_launches()


def test_lm_params_from_reference_layout():
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp, pp = _weights(rcfg)
    assert set(pp) == {"embed", "final_norm", "lm_head", "layers"}
    assert len(pp["layers"]) == rcfg.n_layers
    lay = pp["layers"][1]
    assert lay["attn"]["wq"]["w"].shape == (64, 4 * 16)
    assert lay["attn"]["q_norm"].shape == (16,)
    np.testing.assert_array_equal(
        lay["mlp"]["down"]["w"].numpy(),
        np.asarray(rp["blocks"]["l0"]["mlp"]["down"]["w"][1]))


def test_init_matches_reference_shapes_and_scales():
    """The port's own init: the reference's tree shapes per layer, its
    scales (embed/lm_head ·0.02, dense 1/√d_in, norms 1), and the same
    weights again from the same seed."""
    rcfg, pcfg = _smoke()
    rp = _ref_weights(0)
    pp = T.init(pcfg, 5)
    ref_shapes = jax.tree.map(lambda a: a.shape, rp)
    port_shapes = lm_params_from_reference(rp)
    assert jax.tree.map(lambda t: tuple(t.shape), port_shapes) == \
        jax.tree.map(lambda t: tuple(t.shape), pp)
    assert ref_shapes["embed"]["w"] == tuple(pp["embed"]["w"].shape)
    assert float(pp["embed"]["w"].std()) == pytest.approx(0.02, rel=0.1)
    wq = pp["layers"][0]["attn"]["wq"]["w"]
    assert float(wq.std()) == pytest.approx(64 ** -0.5, rel=0.1)
    assert torch.equal(pp["layers"][1]["norm2"]["scale"], torch.ones(64))
    again = T.init(pcfg, 5)
    assert torch.equal(again["layers"][1]["mlp"]["up"]["w"],
                       pp["layers"][1]["mlp"]["up"]["w"])


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_config_inits_prefills_and_decodes(arch):
    """Port of tests/test_arch_smoke.py::test_prefill_decode_smoke for
    all ten configurations at smoke size (bf16, weights cast for
    serving): the family's prompts, a prefill, its cache seeded into a
    decode cache and two greedy steps, every logit finite; the layer
    kinds and superblock length are the reference's."""
    cfg = configs.get_smoke_config(arch)
    ref = ref_configs.get_smoke_config(arch)
    assert (T.layer_kinds(cfg), T.mlp_kinds(cfg), T._block_len(cfg)) == \
        (RT.layer_kinds(ref), RT.mlp_kinds(ref), RT._block_len(ref))
    full = configs.get_config(arch)
    assert T._block_len(full) == RT._block_len(ref_configs.get_config(arch))
    B, S = 2, 32
    params = T.init(cfg, 0, cast=cast_params_for_serving)
    batch = fake_prompts(cfg, B, S, seed=1)
    with torch.inference_mode():
        logits, pc = T.prefill_fn(cfg)(params, batch)
        assert logits.shape == (B, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
        cache = seed_cache(T.init_cache(cfg, B, S + 2), pc, S)
        tok = logits.argmax(-1)[:, None]
        for pos in (S, S + 1):
            logits, cache = T.decode_fn(cfg)(params, tok, cache, pos)
            assert logits.shape == (B, cfg.vocab)
            assert bool(torch.isfinite(logits).all())
            tok = logits.argmax(-1)[:, None]


def test_serve_steps_check_the_device(monkeypatch):
    """Steps built for a device refuse inputs on another one; the device
    is resolved first, so "cuda" and "cuda:0" name the same card."""
    from repro_torch.serve import serve_step

    pcfg = configs.get_smoke_config(ARCH)
    params = T.init(pcfg, 0)
    toks = fake_prompts(pcfg, 1, 4, seed=0)["tokens"]
    logits, _ = serve_step.make_prefill(pcfg, "cpu")(params,
                                                     {"tokens": toks})
    assert logits.shape == (1, pcfg.vocab)
    seen = []
    monkeypatch.setattr(serve_step, "resolve_device",
                        lambda d: seen.append(d) or torch.device("meta"))
    with pytest.raises(ValueError, match="prefill on meta"):
        serve_step.make_prefill(pcfg, "cuda")(params, {"tokens": toks})
    with pytest.raises(ValueError, match="decode on meta"):
        serve_step.make_decode(pcfg, "cuda")(params, toks[:, :1], None, 0)
    assert seen == ["cuda", "cuda"]


def test_cast_params_for_serving():
    tree = {"a": {"w": torch.ones(2, 3)}, "scale": torch.ones(3),
            "router": {"w": torch.ones(2, 2)},
            "layers": [{"w": torch.ones(4, 4)}]}
    out = cast_params_for_serving(tree)
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["layers"][0]["w"].dtype == torch.bfloat16
    assert out["scale"].dtype == torch.float32
    assert out["router"]["w"].dtype == torch.float32
    again = cast_params_for_serving(out)
    assert again["a"]["w"] is out["a"]["w"]


# ---------------------------------------------------------- checkpoint ---
def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = {"cache": {"layers": [{"k": torch.randn(2, 3).bfloat16()}]},
            "tokens": torch.arange(4).reshape(4, 1),
            "f": torch.randn(5)}
    ckpt.save(str(tmp_path), 3, tree)
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    like = jax.tree.map(lambda t: torch.empty_like(t, device="meta"), tree)
    back, step = ckpt.restore(str(tmp_path), like)
    assert step == 7
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {**like, "f": torch.empty(6)})


def test_checkpoint_reads_reference_bf16_leaves(tmp_path):
    """A checkpoint the reference wrote (bf16 as 2-byte records)
    restores bit-exact in the port."""
    from repro.train import checkpoint as ref_ckpt

    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    ref_ckpt.save(str(tmp_path), 1, {"k": jnp.asarray(x, jnp.bfloat16)})
    back, _ = ckpt.restore(str(tmp_path), {"k": torch.empty(3, 4)})
    assert back["k"].dtype == torch.bfloat16
    assert torch.equal(back["k"], torch.from_numpy(x).bfloat16())


# ------------------------------------------------------------- session ---
SESSION = dict(smoke=True, batch=2, prompt_len=8, gen=4, seed=0,
               device="cpu")


def test_lmsession_resume_matches_uninterrupted(tmp_path):
    """Port of tests/test_gateway.py: kill a session mid-generation;
    resuming from its checkpoint reproduces the uninterrupted run's
    remaining tokens exactly."""
    full = LMSession(ARCH, **SESSION)
    full.start()
    while full.remaining:
        full.decode_steps(4)
    ref = full.tokens_out()            # [B, 5]: prefill tok + 4 steps

    interrupted = LMSession(ARCH, **SESSION, ckpt_dir=str(tmp_path),
                            ckpt_every=2)
    interrupted.start()
    interrupted.decode_steps(2)        # checkpoint lands at step 2
    resumed = LMSession(ARCH, **SESSION, ckpt_dir=str(tmp_path))
    assert resumed.start(resume=True) == 2
    assert resumed.remaining == 2
    while resumed.remaining:
        resumed.decode_steps(1)
    np.testing.assert_array_equal(resumed.tokens_out(), ref[:, 2:])
    assert resumed.metrics()["resumed_from"] == 2


def test_lmsession_resume_without_checkpoint_prefills(tmp_path):
    s = LMSession(ARCH, smoke=True, batch=2, prompt_len=8, gen=1,
                  device="cpu", ckpt_dir=str(tmp_path))
    assert s.start(resume=True) is None
    assert s.resumed_from is None
    assert s.remaining == 1


def test_lmsession_continuous_batching_bit_exact():
    """Port of tests/test_gateway.py: evict one sequence mid-decode and
    admit a fresh one into its slot; the evicted prefix and the
    undisturbed row are bit-identical to an uninterrupted run."""
    from repro_torch.obs.metrics import MetricsRegistry

    full = LMSession(ARCH, **SESSION)
    full.start()
    while full.remaining:
        full.decode_steps(4)
    ref = full.tokens_out()

    reg = MetricsRegistry()
    s = LMSession(ARCH, **SESSION, metrics=reg)
    s.start()
    assert s.metrics()["slots_active"] == 2
    s.decode_steps(2)
    gone = s.evict(1)
    np.testing.assert_array_equal(gone, ref[1, :3])
    assert s.slots()[1]["active"] is False
    with pytest.raises(ValueError):
        s.evict(1)
    slot = s.admit(seed=12345)
    assert slot == 1
    assert s.slots()[1] == {"active": True, "pos": 8, "taken": 0,
                            "budget": 4}
    with pytest.raises(RuntimeError):
        s.admit()
    while s.remaining:
        s.decode_steps(2)
    row0 = s.evict(0)
    np.testing.assert_array_equal(row0, ref[0])
    newbie = s.evict(1)
    assert newbie.shape == (5,)
    assert not np.array_equal(newbie, ref[1])
    m = s.metrics()
    assert (m["admitted"], m["evicted"], m["slots_active"]) == (1, 3, 0)
    snap = reg.snapshot()
    assert snap["lm.admitted"] == 1
    assert snap["lm.evicted"] == 3
    assert snap["lm.slots_active"] == 0


def test_session_refuses_cuda_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMSession(ARCH, smoke=True)


# ----------------------------------------------------- gateway / launcher
class Scripted:
    """Workload fake: `items` units of work, fixed per-item seconds."""

    def __init__(self, name, items, seconds_per_item=0.0):
        self.name = name
        self.left = items
        self.spi = seconds_per_item
        self.warmed = False

    def warmup(self):
        self.warmed = True

    def ready(self):
        return self.left > 0

    def step(self, quantum):
        n = min(quantum, self.left)
        self.left -= n
        return StepReport(items=n, seconds=self.spi * n)

    def metrics(self):
        return {"left": self.left}


def test_scheduler_fairness_known_interleaving():
    a, b = Scripted("a", 4), Scripted("b", 4)
    sched = RoundScheduler({"a": Share(quantum=2, weight=1),
                            "b": Share(quantum=1, weight=2)})
    trace = sched.run([a, b])
    assert trace.interleaving() == ["a", "b", "b", "a", "b", "b"]
    assert (trace.items_of("a"), trace.items_of("b"), trace.rounds) == \
        (4, 4, 2)


def test_scheduler_priority_orders_turns():
    a, b = Scripted("a", 2), Scripted("b", 2)
    sched = RoundScheduler({"b": Share(quantum=1, priority=1)},
                           default=Share(quantum=1))
    assert sched.run([a, b]).interleaving() == ["b", "a", "b", "a"]


def test_scheduler_drains_unbalanced_workloads():
    a, b = Scripted("a", 1), Scripted("b", 5)
    trace = RoundScheduler(default=Share(quantum=2)).run([a, b])
    assert (trace.items_of("a"), trace.items_of("b")) == (1, 5)
    assert [t.contended for t in trace.turns if t.name == "a"] == [True]
    assert [t.contended for t in trace.turns if t.name == "b"][-1] is False


def test_scheduler_breaks_on_stalled_workload():
    class Stalled(Scripted):
        def step(self, quantum):
            return StepReport(items=0, seconds=0.0)

    assert RoundScheduler().run([Stalled("s", 3)]).rounds == 1


def test_gateway_report_splits_solo_and_contended():
    a = Scripted("a", 6, seconds_per_item=0.01)
    b = Scripted("b", 2, seconds_per_item=0.01)
    gw = Gateway(scheduler=RoundScheduler(default=Share(quantum=2)))
    gw.add(a)
    gw.add(b)
    gw.run()
    assert a.warmed and b.warmed
    rep = gw.report()["workloads"]["a"]
    assert rep["items"] == 6
    assert rep["turn_item_ms"]["contended"]["n"] >= 1
    assert rep["turn_item_ms"]["solo"]["n"] >= 1
    assert rep["interference_x"] == pytest.approx(1.0, rel=0.2)


def test_gateway_rejects_duplicate_names():
    gw = Gateway()
    gw.add(Scripted("a", 1))
    with pytest.raises(ValueError):
        gw.add(Scripted("a", 1))


def test_gateway_drives_lm_workload():
    s = LMSession(ARCH, smoke=True, batch=2, prompt_len=8, gen=3,
                  device="cpu")
    gw = Gateway(device=s.device)
    gw.add(LMDecodeWorkload(s), Share(quantum=2))
    gw.add(Scripted("g", 2))
    gw.run()
    rep = gw.report()["workloads"]["lm"]
    assert rep["items"] == 3 and rep["turns"] == 2
    assert s.tokens_out().shape == (2, 4)


def test_serve_cli_smoke_cpu(capsys):
    """`python -m repro_torch.launch.serve --smoke --device cpu` at
    S = 512, in process."""
    from repro_torch.launch import serve

    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--prompt-len", "512", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "[serve] prefill: 4×512 tokens" in out
    assert "[serve] decode: 4 steps × 4 seqs" in out
    assert "flash launches=0" in out     # CPU tensors take the plain path
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--resume"]) == 2


def test_serve_cli_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.parse_args(["--arch", ARCH]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH, "--smoke"])


def test_serve_module_runs_without_jax():
    """In a fresh process: import `repro_torch.launch.serve`, serve a
    smoke batch on the CPU through its `main` (an LMSession behind the
    Gateway); jax, the reference package and triton stay unloaded."""
    code = ("import sys, repro_torch.launch.serve as serve; "
            "rc = serve.main(['--arch', 'qwen3-1.7b', '--smoke', "
            "'--device', 'cpu', '--prompt-len', '16', '--gen', '2']); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')]; "
            "assert rc == 0 and not bad, (rc, bad)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[serve] sample tokens" in out.stdout
