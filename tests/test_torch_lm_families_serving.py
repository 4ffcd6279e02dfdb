"""The serving path of the non-dense LM families on the CPU: prompts,
decode-vs-prefill consistency, `LMSession` (continuous batching,
resume, the batch-1 admission prefill), the launchers' `--arch` and
`--layers`, and every configuration through init, prefill and decode.

The consistency tests port tests/test_serve_consistency.py to each
family: prefill S-1 tokens, decode token S-1 with the cache, and its
logits match the full prefill's last-position logits within 5e-2
(bf16).  MoE configs are pinned dropless (capacity_factor = n_experts)
for it, as the reference's test does.  whisper-base is the exception:
the reference's enc-dec prefill fills only the cross-attention cache
(`repro/models/transformer.py:448`), and decode's cross-attention reads
the whole max_seq cross cache unmasked (`:339`, `:410`), so its decode
does not match its prefill; the port keeps both quirks, and its test
holds the port's decode to the reference's instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_families import _batch, _close, _ref_tree, _to_port, _to_ref

from repro import configs as ref_configs
from repro.models import transformer as RT
from repro.serve.session import seed_cache as ref_seed_cache

from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import transformer as T
from repro_torch.serve import serve_step
from repro_torch.serve.serve_step import cast_params_for_serving
from repro_torch.serve.session import LMSession, fake_prompts, seed_cache

torch.set_num_threads(1)


# -------------------------------------------------------------- prompts ---
@pytest.mark.parametrize("arch,keys", [
    ("granite-moe-1b-a400m", {"tokens"}),
    ("whisper-base", {"tokens", "enc_embeds"}),
    ("qwen2-vl-72b", {"embeds", "positions3"})])
def test_fake_prompts_follow_the_family_input(arch, keys):
    cfg = configs.get_smoke_config(arch)
    b = fake_prompts(cfg, 3, 8, seed=5)
    assert set(b) == keys
    for name in keys & {"enc_embeds", "embeds"}:
        assert b[name].dtype == torch.bfloat16
        assert b[name].shape == (3, 8, cfg.d_model)
    if "positions3" in b:
        assert b["positions3"].shape == (3, 3, 8)
        assert torch.equal(b["positions3"][2, 1], torch.arange(8))
    if "tokens" in b:
        assert b["tokens"].shape == (3, 8) and int(b["tokens"].max()) < \
            cfg.vocab
    again = fake_prompts(cfg, 3, 8, seed=5)
    assert all(torch.equal(b[k], again[k]) for k in keys)


def test_make_prefill_checks_every_batch_tensor(monkeypatch):
    """A vlm batch has no tokens: the device check covers each tensor."""
    cfg = configs.get_smoke_config("qwen2-vl-72b")
    params = T.init(cfg, 0)
    batch = fake_prompts(cfg, 1, 4, seed=0)
    logits, _ = serve_step.make_prefill(cfg, "cpu")(params, batch)
    assert logits.shape == (1, cfg.vocab)
    monkeypatch.setattr(serve_step, "resolve_device",
                        lambda d: torch.device("meta"))
    with pytest.raises(ValueError, match=r"batch\['embeds'\] on cpu"):
        serve_step.make_prefill(cfg, "cuda")(params, batch)


# ---------------------------------------------------------- consistency ---
CONSISTENT = ["granite-moe-1b-a400m", "mamba2-370m", "jamba-v0.1-52b",
              "qwen2-vl-72b"]


@pytest.mark.parametrize("arch", CONSISTENT)
def test_decode_matches_prefill_logits(arch):
    """Port of tests/test_serve_consistency.py (bf16, the port's own
    weights).  qwen2-vl, whose prefill takes embeddings, gets the embed
    table's rows of the tokens and arange M-RoPE positions, so decode's
    token and broadcast position continue the same sequence."""
    cfg = configs.get_smoke_config(arch)
    if cfg.n_experts:
        cfg = cfg.scaled(capacity_factor=float(cfg.n_experts))
    B, S = 2, 12
    params = cast_params_for_serving(T.init(cfg, 0))
    toks = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab, (B, S)))

    def batch(n):
        if cfg.family != "vlm":
            return {"tokens": toks[:, :n]}
        return {"embeds": params["embed"]["w"][toks[:, :n]],
                "positions3": torch.arange(n).expand(B, 3, n)}

    with torch.inference_mode():
        full, _ = T.prefill_fn(cfg)(params, batch(S))
        _, pc = T.prefill_fn(cfg)(params, batch(S - 1))
        cache = seed_cache(T.init_cache(cfg, B, S), pc, S - 1)
        dec, _ = T.decode_fn(cfg)(params, toks[:, S - 1:], cache, S - 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-2,
                               atol=5e-2)


def test_whisper_decode_keeps_the_reference_quirks():
    """whisper-base (fp32, the reference's weights and prompts, S = 12
    tokens and frames): the port's decode of token S-1 after an S-1
    prefill equals the reference's at two cache lengths, while (a) at
    max_seq = S (no zero cross key) both differ from the full prefill,
    the self-attention cache being empty, and (b) at max_seq = 2S both
    differ from (a)'s, the S zero cross keys joining the softmax."""
    arch = "whisper-base"
    rcfg = ref_configs.get_smoke_config(arch).scaled(dtype="float32")
    pcfg = configs.get_smoke_config(arch).scaled(dtype="float32")
    tree = _ref_tree(arch, 0)
    rp, pp = jax.tree.map(jnp.asarray, tree), lm_params_from_reference(tree)
    B, S = 2, 12
    b = _batch(rcfg, B, S, seed=7)
    head = {"tokens": b["tokens"][:, :S - 1], "enc_embeds": b["enc_embeds"]}
    tail = b["tokens"][:, S - 1:]
    rfull, _ = jax.jit(RT.prefill_fn(rcfg))(rp, _to_ref(b))
    _, rpc = jax.jit(RT.prefill_fn(rcfg))(rp, _to_ref(head))
    assert set(rpc) == {"cross_kv"}
    with torch.inference_mode():
        pfull, _ = T.prefill_fn(pcfg)(pp, _to_port(b))
        _, ppc = T.prefill_fn(pcfg)(pp, _to_port(head))
    assert set(ppc) == {"cross_kv"}
    _close(pfull, rfull, 1e-4)
    dec = {}
    for max_seq in (S, 2 * S):
        rcache = ref_seed_cache(RT.init_cache(rcfg, B, max_seq, jnp.float32),
                                rpc, S - 1)
        rdec, _ = jax.jit(RT.decode_fn(rcfg))(rp, jnp.asarray(tail), rcache,
                                              jnp.asarray(S - 1))
        with torch.inference_mode():
            cache = seed_cache(T.init_cache(pcfg, B, max_seq, torch.float32),
                               ppc, S - 1)
            assert all(not lc["k"].any() for lc in cache["layers"])
            pdec, _ = T.decode_fn(pcfg)(pp, torch.from_numpy(tail).long(),
                                        cache, S - 1)
        _close(pdec, rdec, 1e-4)
        dec[max_seq] = (np.asarray(rdec), pdec.numpy())
    full = (np.asarray(rfull), pfull.numpy())
    for pkg in (0, 1):                   # the reference, then the port
        assert np.abs(dec[S][pkg] - full[pkg]).max() > 0.1        # (a)
        assert np.abs(dec[2 * S][pkg] - dec[S][pkg]).max() > 0.1  # (b)


# -------------------------------------------------------------- session ---
SESSION = dict(smoke=True, batch=2, prompt_len=8, gen=4, seed=0,
               device="cpu")
SESSION_ARCHS = ["granite-moe-1b-a400m", "mamba2-370m"]


@pytest.mark.parametrize("arch", SESSION_ARCHS)
def test_lmsession_resume_matches_uninterrupted(arch, tmp_path):
    """Resuming from a checkpoint (K/V or Mamba states) reproduces the
    uninterrupted run's remaining tokens exactly."""
    full = LMSession(arch, **SESSION)
    full.start()
    while full.remaining:
        full.decode_steps(4)
    ref = full.tokens_out()

    interrupted = LMSession(arch, **SESSION, ckpt_dir=str(tmp_path),
                            ckpt_every=2)
    interrupted.start()
    interrupted.decode_steps(2)
    resumed = LMSession(arch, **SESSION, ckpt_dir=str(tmp_path))
    assert resumed.start(resume=True) == 2
    while resumed.remaining:
        resumed.decode_steps(1)
    np.testing.assert_array_equal(resumed.tokens_out(), ref[:, 2:])


@pytest.mark.parametrize("arch", SESSION_ARCHS)
def test_lmsession_continuous_batching_bit_exact(arch):
    """Evict one sequence mid-decode and admit a fresh one (a batch-1
    prefill scattered into its slot: K/V rows or Mamba state rows); the
    evicted prefix and the undisturbed row equal the uninterrupted
    run's bit for bit."""
    full = LMSession(arch, **SESSION)
    full.start()
    while full.remaining:
        full.decode_steps(4)
    ref = full.tokens_out()

    s = LMSession(arch, **SESSION)
    s.start()
    s.decode_steps(2)
    np.testing.assert_array_equal(s.evict(1), ref[1, :3])
    assert s.admit(seed=12345) == 1
    while s.remaining:
        s.decode_steps(2)
    np.testing.assert_array_equal(s.evict(0), ref[0])
    newbie = s.evict(1)
    assert newbie.shape == (5,)
    assert not np.array_equal(newbie, ref[1])


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-72b",
                                  "jamba-v0.1-52b"])
def test_lmsession_admits_into_every_family(arch):
    """The batch-1 admission prefill for the families whose prompts are
    not plain tokens (whisper's frames, qwen2-vl's embeddings) and for
    jamba's mixed cache: a sequence admitted beside a running row
    decodes as the same admission does in a batch of one with the same
    cache length (whisper's decode reads every cell of its cross cache,
    so the length is part of its result)."""
    def admitted(batch):
        s = LMSession(arch, **{**SESSION, "batch": batch, "max_seq": 12})
        s.start()
        s.decode_steps(1)
        s.evict(0)
        assert s.admit(seed=77, gen=2) == 0
        while s.remaining:
            s.decode_steps(1)
        return s.evict(0)

    row = admitted(2)
    assert row.shape == (3,)
    np.testing.assert_array_equal(row, admitted(1))


# ------------------------------------------------------------ launchers ---
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_serve_cli_smoke_cpu(arch, capsys):
    """`launch.serve --smoke --device cpu` for each of the ten
    configurations."""
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--prompt-len", "16", "--gen", "2"]) == 0
    out = capsys.readouterr().out
    assert "[serve] prefill: 4×16 tokens" in out
    assert "[serve] decode: 2 steps × 4 seqs" in out


def test_serve_cli_cuts_the_decoder(capsys):
    """`--layers` keeps the family's layer pattern up to the cut."""
    from repro_torch.launch import serve

    seen = []
    real = LMSession.start

    def spy(self, **kw):
        seen.append(self)
        return real(self, **kw)

    LMSession.start = spy
    try:
        assert serve.main(["--arch", "whisper-base", "--smoke", "--device",
                           "cpu", "--prompt-len", "8", "--gen", "1",
                           "--layers", "1"]) == 0
    finally:
        LMSession.start = real
    cfg = seen[0].cfg
    assert (cfg.n_layers, cfg.enc_layers) == (1, 2)
    assert len(seen[0]._params["layers"]) == len(seen[0]._params["cross"]) \
        == 1


def test_gateway_serves_another_family(capsys):
    from repro_torch.launch import gateway

    run = gateway.run(gateway.parse_args([
        "--device", "cpu", "--dataset", "tiny-er", "--workload", "smoke",
        "--arch", "mamba2-370m", "--batch", "2", "--prompt-len", "16",
        "--gen", "4", "--capacity", "8192"]), log=print)
    out = capsys.readouterr().out
    assert run.rc == 0, out
    assert "lm=mamba2-370m" in out and "4/4 steps" in out
    assert run.session.tokens_out().shape == (2, 5)
