"""The arithmetic of K4's wgmma kernel, emulated tile by tile on the CPU
(`repro_torch.kernels.ref.flash_attention_tiled_ref`: 128 x 128 tiles,
online softmax in exp2, P rounded to bf16 before P.V, causal tile skip),
against the reference's Pallas kernel
(`repro.kernels.flash_attention.flash_attention_pallas`, interpret mode
on the CPU, as its own tests run it) and its oracle
(`repro.kernels.ref.flash_attention_ref`), within the reference's bf16
tolerance (tests/test_flash_kernel.py: atol 3e-2).

The kernel itself runs only on a card (tests/test_torch_cuda_kernels.py);
this shows on the CPU that rounding P to bf16 stays inside the tolerance
the reference holds its own kernel to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref as jax_flash_ref

from repro_torch.kernels.ref import (flash_attention_ref,
                                    flash_attention_tiled_ref)

torch.set_num_threads(1)

ATOL = 3e-2
# (BH, BK, Sq, Sk, hd): the reference test's shapes
# (tests/test_flash_kernel.py:16-22), then ragged ones (lengths off the
# kernel's 128-row tiles, head dims below the 64-column boxes)
SHAPES = [(4, 4, 256, 256, 64), (8, 2, 256, 256, 64), (6, 6, 128, 128, 128),
          (2, 1, 512, 512, 32), (3, 3, 384, 384, 64), (6, 3, 100, 77, 40),
          (2, 2, 1, 130, 16), (4, 1, 65, 65, 96)]


def _inputs(shape, seed):
    """The same bf16 values in both packages: fp32 draws rounded to
    nearest even by each."""
    BH, BK, Sq, Sk, hd = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((BH, Sq, hd), (BK, Sk, hd), (BK, Sk, hd))]
    return ([jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).bfloat16() for a in arrays])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_tiled_matches_pallas(shape, causal):
    """Against the Pallas kernel at the reference test's block of 128
    (one block per axis where a ragged length does not divide)."""
    (jq, jk, jv), (q, k, v) = _inputs(shape, sum(shape))
    _, _, Sq, Sk, _ = shape
    got = flash_attention_tiled_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = flash_attention_pallas(
        jq, jk, jv, causal=causal,
        block_q=128 if Sq % 128 == 0 else Sq,
        block_k=128 if Sk % 128 == 0 else Sk)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_tiled_matches_reference_oracle(shape, causal):
    """Against the reference's plain softmax attention in fp32, and the
    port's plain version of K4."""
    (jq, jk, jv), (q, k, v) = _inputs(shape, 7 + sum(shape))
    got = flash_attention_tiled_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(
        _f32(got), _f32(jax_flash_ref(jq, jk, jv, causal=causal)), atol=ATOL)
    np.testing.assert_allclose(
        _f32(got), _f32(flash_attention_ref(q, k, v, causal=causal)),
        atol=ATOL)


def test_rounding_p_is_the_only_difference():
    """On fp32 inputs the emulation differs from the fp32 oracle by the
    rounding of P to bf16 alone: visibly, yet far inside the tolerance;
    with tiles as large as the sequence (one tile, no rescaling) the
    difference is of the same size."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 384, 64))
                                .astype(np.float32)) for _ in range(3))
    want = flash_attention_ref(q, k, v, causal=True)
    tiled = flash_attention_tiled_ref(q, k, v, causal=True)
    whole = flash_attention_tiled_ref(q, k, v, causal=True, block_q=384,
                                      block_kv=384)
    for got in (tiled, whole):
        err = float((got - want).abs().max())
        assert 1e-5 < err < 1e-2, err
    assert float((tiled - whole).abs().max()) < 1e-2
