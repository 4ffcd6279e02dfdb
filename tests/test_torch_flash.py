"""Port parity, kernel K4: the flash-attention wrappers of
`repro_torch.kernels.ops` on CPU tensors — where they run the plain
PyTorch version — against the reference's Pallas kernel
(`repro.kernels.flash_attention.flash_attention_pallas`, interpret mode
on the CPU, as its own tests run it) and its oracle
(`repro.kernels.ref.flash_attention_ref`), on the reference test's
shapes with the reference test's tolerances (tests/test_flash_kernel.py:
atol 3e-2 in bf16, 2e-5 in fp32).

The CUDA kernel itself runs only on a card: the `cuda`-marked test in
tests/test_torch_cuda_kernels.py holds it against the plain version
there and skips elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models.layers import _sdpa as jax_sdpa

from repro_torch.kernels import ops

torch.set_num_threads(1)

# (BH, BK, Sq, Sk, hd, block) — tests/test_flash_kernel.py:16-22
SHAPES = [
    (4, 4, 256, 256, 64, 128),      # MHA, multi-block
    (8, 2, 256, 256, 64, 128),      # GQA group 4
    (6, 6, 128, 128, 128, 128),     # single block, hd=128
    (2, 1, 512, 512, 32, 128),      # MQA
    (3, 3, 384, 384, 64, 128),      # non-power-of-two grid
]
ATOL = {"bfloat16": 3e-2, "float32": 2e-5}


def _inputs(shape, seed):
    BH, BK, Sq, Sk, hd, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((BH, Sq, hd), (BK, Sk, hd), (BK, Sk, hd))]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_matches_pallas_and_reference_oracle(shape, causal, dtype):
    """Both packages round the same fp32 draws to the working dtype
    (round to nearest even), so the inputs are equal bit for bit."""
    q, k, v = _inputs(shape, sum(shape))
    jq, jk, jv = (jnp.asarray(a, dtype=getattr(jnp, dtype))
                  for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = ops.flash_attention_rows(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    block = shape[-1]
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal,
                                    block_q=block, block_k=block)
    oracle = jax_flash_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=ATOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=ATOL[dtype])


@pytest.mark.parametrize("B", [1, 2])
def test_model_layout_wrapper_gqa(B):
    """ops.flash_attention folds [B,S,H,hd] with the query heads of one
    KV group adjacent; it matches the reference's wrapper (Pallas) and
    the reference model's own GQA attention, at batch 1 (an admission's
    prefill, where the fold is a strided view) and batch 2."""
    rng = np.random.default_rng(1)
    S, H, K, hd = 256, 8, 2, 64
    q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
               for n in (H, K, K))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=True)
    assert got.shape == (B, S, H, hd)
    want = ref_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=True, block_q=128, block_k=128)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=1e-4)
    want = jax_sdpa(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=1e-4)


def test_softmax_stability_large_logits():
    """Scores of magnitude ~1e4 stay finite and match the Pallas kernel's
    online softmax."""
    rng = np.random.default_rng(2)
    q = (30.0 * rng.normal(size=(1, 128, 64))).astype(np.float32)
    k = (30.0 * rng.normal(size=(1, 128, 64))).astype(np.float32)
    v = rng.normal(size=(1, 128, 64)).astype(np.float32)
    got = ops.flash_attention_rows(*map(torch.from_numpy, (q, k, v)),
                                   causal=False)
    assert torch.isfinite(got).all()
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)),
                                  causal=False, block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)


def test_cpu_calls_do_not_count_launches():
    ops.reset_launches()
    q, k, v = map(torch.from_numpy, _inputs((4, 2, 64, 64, 32, 64), 0))
    ops.flash_attention_rows(q, k, v)
    assert ops.launches["flash"] == 0


@pytest.mark.parametrize("bad", ["dtype", "mixed", "contiguity", "group",
                                 "head_dim", "empty"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = map(torch.from_numpy, _inputs((4, 2, 64, 64, 32, 64), 0))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "contiguity":
        q = torch.cat([q, q], dim=2)[:, :, ::2]
    elif bad == "group":
        k, v = torch.cat([k, k[:1]]), torch.cat([v, v[:1]])
    elif bad == "head_dim":
        v = v[:, :, :16].contiguous()
    else:
        q = q[:, :0]
    with pytest.raises((TypeError, ValueError)):
        ops.flash_attention_rows(q, k, v)


def test_route_refuses_other_devices():
    assert ops._route(torch.device("cpu")) == "plain"
    assert ops._route(torch.device("cuda", 0)) == "kernel"
    assert ops._route(torch.device("meta")) == "meta"
    with pytest.raises(ValueError):
        ops._route(torch.device("mps"))
