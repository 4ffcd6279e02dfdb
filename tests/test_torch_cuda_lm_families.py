"""The non-dense LM families on a card: the reduced configs of moe, ssm,
hybrid, encdec and vlm prefilled and decoded on the card (K4 in every
flash-eligible attention) against the same weights and prompts on the
CPU (K4's plain version), and `LMSession` continuous batching on the
card.

The tests carry the `cuda` marker and skip without a card.  This file
imports neither JAX nor the reference package, so it also runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm_families.py
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serve.serve_step import cast_params_for_serving
from repro_torch.serve.session import LMSession, fake_prompts, seed_cache

ARCHS = ["granite-moe-1b-a400m", "mamba2-370m", "jamba-v0.1-52b",
         "whisper-base", "qwen2-vl-72b"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4 is CUDA C++; no CPU mode)")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_family_on_card_equals_cpu(arch):
    """S = 512 (the flash route), bf16: prefill logits and two greedy
    decode steps on the card within 5e-2 of the CPU's, K4 launched once
    per flash-eligible attention call, all of the wgmma kernel, and
    none in decode."""
    _need_card()
    cfg = configs.get_smoke_config(arch)
    cpu = T.init(cfg, 0, cast=cast_params_for_serving)
    card = _to(cpu, "cuda")
    B, S = 2, 512
    batch = fake_prompts(cfg, B, S, seed=3)
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        ops.reset_launches()
        with torch.inference_mode():
            logits, pc = T.prefill_fn(cfg)(params, _to(batch, dev))
            flash = (ops.launches["flash"], dict(k4.variant_launches))
            cache = seed_cache(T.init_cache(cfg, B, S + 2, device=dev), pc, S)
            tok = logits.argmax(-1)[:, None]
            steps = [logits.float().cpu()]
            for pos in (S, S + 1):
                logits, cache = T.decode_fn(cfg)(params, tok, cache, pos)
                tok = logits.argmax(-1)[:, None]
                steps.append(logits.float().cpu())
        out[dev] = (steps, flash, ops.launches["flash"])
    n = T.flash_calls(cfg)
    assert out["cpu"][1][0] == 0
    assert out["cuda"][1] == (n, {"scalar": 0, "wgmma": n})
    assert out["cuda"][2] == n               # decode launched nothing
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-2,
                                   rtol=5e-2)
    ops.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m"])
def test_continuous_batching_on_card_bit_exact(arch):
    """Evict and admit on the card: the evicted prefix and the
    undisturbed row equal an uninterrupted run's bit for bit."""
    _need_card()
    kw = dict(smoke=True, batch=2, prompt_len=512, gen=4, seed=0,
              device="cuda")
    full = LMSession(arch, **kw)
    full.start()
    while full.remaining:
        full.decode_steps(4)
    ref = full.tokens_out()
    s = LMSession(arch, **kw)
    s.start()
    s.decode_steps(2)
    np.testing.assert_array_equal(s.evict(1), ref[1, :3])
    assert s.admit(seed=99) == 1
    while s.remaining:
        s.decode_steps(2)
    np.testing.assert_array_equal(s.evict(0), ref[0])
    want = T.flash_calls(s.cfg)
    assert s.metrics()["flash_launches"] == 2 * want
