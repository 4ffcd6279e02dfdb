"""Port parity, LM training's data and gradient compression:
`train/data.py` (`SyntheticLM`, `TokenFile`) and `train/compress.py`
(`quantize_int8`, `dequantize_int8`, `compressed_all_reduce`).

The first seven cases port tests/test_data_compress.py.  The quantizer
is bit-equal to the reference's on the same arrays; `TokenFile` gives
the reference's batches on the same file; `compressed_all_reduce` over
two gloo ranks (spawned by tests/torch_ranks.py) equals the reference's
formula — Σ q as int32, MAX of the scales, ÷ world size — applied with
the reference's quantizer to the same per-rank arrays, bit for bit.

The spawned ranks import this file by name, so the JAX reference is
imported inside the tests that need it.
"""
import os

import numpy as np
import pytest
import torch
from torch_ranks import init_rank, spawn_ranks

from repro_torch.configs import ShapeConfig, get_smoke_config, input_specs
from repro_torch.train.compress import (compressed_all_reduce,
                                        dequantize_int8, quantize_int8)
from repro_torch.train.data import DataConfig, SyntheticLM, TokenFile

torch.set_num_threads(1)


# ------------------------------------------------- ports of the reference ---
def test_batch_pure_function_of_step():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=4, seed=3)
    d1, d2 = SyntheticLM(cfg), SyntheticLM(cfg)
    for step in (0, 5, 1000):
        b1, b2 = d1.batch(step), d2.batch(step)
        assert torch.equal(b1["tokens"], b2["tokens"])
        assert torch.equal(b1["labels"], b2["labels"])


def test_batches_differ_across_steps_and_seeds():
    cfg = DataConfig(vocab=512, seq_len=32, global_batch=4, seed=0)
    d = SyntheticLM(cfg)
    assert not torch.equal(d.batch(0)["tokens"], d.batch(1)["tokens"])
    d2 = SyntheticLM(DataConfig(vocab=512, seq_len=32, global_batch=4, seed=1))
    assert not torch.equal(d.batch(0)["tokens"], d2.batch(0)["tokens"])


def test_labels_are_next_tokens():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=2, seed=0)
    b = SyntheticLM(cfg).batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_family_specific_batches():
    enc = get_smoke_config("whisper-base")
    b = SyntheticLM(DataConfig(vocab=enc.vocab, seq_len=8, global_batch=2),
                    enc).batch(0)
    assert b["enc_embeds"].shape == (2, 8, enc.d_model)
    vlm = get_smoke_config("qwen2-vl-72b")
    b = SyntheticLM(DataConfig(vocab=vlm.vocab, seq_len=8, global_batch=2),
                    vlm).batch(0)
    assert b["embeds"].shape == (2, 8, vlm.d_model)
    assert b["positions3"].shape == (2, 3, 8)


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_compressed_all_reduce_single_rank_identity_with_error_feedback():
    """No process group: one rank; reduced value + residual == input."""
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(64,))
                               .astype(np.float32))}
    out, err = compressed_all_reduce(g)
    np.testing.assert_allclose((out["w"] + err["w"]).numpy(), g["w"].numpy(),
                               rtol=0, atol=1e-6)


def test_error_feedback_accumulates_to_true_sum():
    """Repeated reductions: error feedback makes the MEAN of compressed
    reductions converge to the true gradient."""
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32)) * 1e-3
    err = {"g": torch.zeros_like(g)}
    total = torch.zeros_like(g)
    N = 32
    for _ in range(N):
        out, err = compressed_all_reduce({"g": g}, error_state=err)
        total += out["g"]
    np.testing.assert_allclose((total / N).numpy(), g.numpy(), atol=5e-6)


# ------------------------------------------------ against the reference ---
def _arrays():
    """Arrays the quantizer meets: normal, tiny, all zero (the 1e-12
    floor), exact halves of a step (round half to even), one outlier."""
    rng = np.random.default_rng(4)
    halves = (np.arange(-40, 41, dtype=np.float32) + 0.5) / 127.0 * 3.0
    halves[0] = 3.0
    return [rng.normal(size=(300,)).astype(np.float32),
            (rng.normal(size=(7, 9)) * 1e-7).astype(np.float32),
            np.zeros((5,), np.float32), halves,
            np.concatenate([rng.normal(size=(50,)), [1e4]]).astype(np.float32)]


def test_quantize_bit_equal_to_reference():
    import jax.numpy as jnp

    from repro.train import compress as RC

    for i, a in enumerate(_arrays()):
        rq, rs = RC.quantize_int8(jnp.asarray(a))
        q, s = quantize_int8(torch.from_numpy(a))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq), err_msg=i)
        assert float(s) == float(rs), i
        np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                      np.asarray(RC.dequantize_int8(rq, rs)))
        # with a given scale (and a bf16 input)
        given = np.float32(0.01)
        rq, _ = RC.quantize_int8(jnp.asarray(a, jnp.bfloat16), given)
        q, _ = quantize_int8(torch.from_numpy(a).bfloat16(),
                             torch.tensor(given))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq), err_msg=i)


def test_token_file_batches_equal_reference(tmp_path):
    from repro.train.data import DataConfig as RDataConfig
    from repro.train.data import TokenFile as RTokenFile

    path = str(tmp_path / "corpus.bin")
    np.random.default_rng(9).integers(0, 50_000, 10_001, dtype=np.uint16) \
        .tofile(path)
    cfg = dict(vocab=50_000, seq_len=64, global_batch=6, seed=2)
    port, ref = TokenFile(path, DataConfig(**cfg)), RTokenFile(
        path, RDataConfig(**cfg))
    for step in (0, 1, 17):
        got, want = port.batch(step), ref.batch(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-base",
                                  "qwen2-vl-72b"])
def test_batches_have_the_input_specs_layout(arch):
    """Keys, shapes and dtypes of `configs.input_specs` for the train
    cell; tokens in [0, V) with the u³ skew (P(token < V/8) = 1/2)."""
    cfg = get_smoke_config(arch)
    b = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=64,
                               seed=1), cfg).batch(3)
    spec = input_specs(cfg, ShapeConfig("t", 16, 64, "train"))
    assert b.keys() == spec.keys()
    for k in b:
        assert b[k].shape == spec[k].shape and b[k].dtype == spec[k].dtype, k
    lab = b["labels"]
    assert int(lab.min()) >= 0 and int(lab.max()) < cfg.vocab
    low = float((lab < cfg.vocab / 8).float().mean())
    assert 0.4 < low < 0.6, low


# ------------------------------------------------------ two gloo ranks ---
def _rank_arrays(rank):
    rng = np.random.default_rng(20 + rank)
    return ({"a": rng.normal(size=(64,)).astype(np.float32),
             "b": {"c": (rng.normal(size=(3, 5)) * 40).astype(np.float32)}},
            {"a": (rng.normal(size=(64,)) * 1e-3).astype(np.float32),
             "b": {"c": (rng.normal(size=(3, 5)) * 1e-3).astype(np.float32)}})


def _reduce_rank(rank, world, rdv, out_dir):
    init_rank(rank, world, rdv)
    g, e = _rank_arrays(rank)
    tree = {"a": torch.from_numpy(g["a"]),
            "b": {"c": torch.from_numpy(g["b"]["c"]).bfloat16()}}
    err = {"a": torch.from_numpy(e["a"]), "b": {"c": torch.from_numpy(
        e["b"]["c"])}}
    out, new_e = compressed_all_reduce(tree, error_state=err)
    assert out["b"]["c"].dtype == torch.bfloat16
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             a=out["a"].numpy(), c=out["b"]["c"].float().numpy(),
             ea=new_e["a"].numpy(), ec=new_e["b"]["c"].numpy())


def test_compressed_all_reduce_two_ranks_equals_reference_formula(tmp_path):
    import jax.numpy as jnp

    from repro.train import compress as RC

    world = 2
    spawn_ranks(_reduce_rank, world, tmp_path, str(tmp_path))
    per = [_rank_arrays(r) for r in range(world)]
    want, want_e = {}, [{} for _ in range(world)]
    for key, get, dtype in (("a", lambda t: t["a"], jnp.float32),
                            ("c", lambda t: t["b"]["c"], jnp.bfloat16)):
        qs, ss = [], []
        for r, (g, e) in enumerate(per):
            g32 = jnp.asarray(get(g), dtype).astype(jnp.float32) + get(e)
            q, s = RC.quantize_int8(g32)
            qs.append(q.astype(jnp.int32))
            ss.append(s)
            want_e[r][key] = np.asarray(g32 - RC.dequantize_int8(q, s))
        total = sum(qs)
        n = jnp.asarray(float(world), jnp.float32)
        want[key] = np.asarray((total.astype(jnp.float32) * max(ss) / n)
                               .astype(dtype).astype(jnp.float32))
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(got["a"], want["a"])
        np.testing.assert_array_equal(got["c"], want["c"])
        np.testing.assert_array_equal(got["ea"], want_e[r]["a"])
        np.testing.assert_array_equal(got["ec"], want_e[r]["c"])
