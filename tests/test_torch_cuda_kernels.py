"""The port's CUDA kernels on a card: K1 (`level_expand.cu`) and K4
(`flash_attention.cu`) built with nvcc and held against their plain
PyTorch versions, every launch counted.

These tests carry the `cuda` marker and skip without a card.  This file
imports neither JAX nor the reference package, so it also runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref, level_expand_ref


def _need_card(kernel):
    if not torch.cuda.is_available():
        pytest.skip(f"needs an NVIDIA GPU ({kernel} is CUDA C++; no CPU "
                    "mode)")


def _csr_windows(seed, B, D, P=3, L=50, vmax=200):
    """Random CSR windows: strictly increasing rows of length 0..L (10%
    emptied), candidates, a validity mask and prefix values, on the card."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=(P, B)).astype(np.int32)
    lens[rng.random((P, B)) < 0.1] = 0
    starts = np.zeros((P, B), np.int32)
    rows, off = [], 0
    for p in range(P):
        for b in range(B):
            starts[p, b] = off
            rows.append(np.sort(rng.choice(vmax, size=lens[p, b],
                                           replace=False)).astype(np.int32))
            off += lens[p, b]
    arrays = (rng.integers(0, vmax, size=(B, D)).astype(np.int32),
              np.concatenate(rows), starts, lens,
              rng.integers(0, vmax, size=(B, 3)).astype(np.int32),
              rng.random((B, D)) < 0.8)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """K1 is bit-equal to the plain version in every mode, and each
    launch is counted."""
    _need_card("K1")
    cand, flat, starts, lens, extra, valid = _csr_windows(0, B=300, D=130)
    ops.reset_launches()
    for kw in (dict(dirs=(1, -1, 0), count=False),
               dict(dirs=(1, -1, 0), count=True),
               dict(dirs=(), count=True, neg_from=64)):
        ex = extra if kw["dirs"] else None
        got = ops.level_expand(cand, flat, starts, lens, ex, valid,
                               window=50, **kw)
        want = level_expand_ref(cand, flat, starts, lens, ex, valid,
                                window=50, **kw)
        assert torch.equal(got, want)
    assert ops.launches == {"mask": 1, "count": 1, "signed": 1,
                            "flash": 0}


# (BH, BK, Sq, Sk, hd): the reference test's shapes
# (tests/test_flash_kernel.py:16-22), then ragged ones the kernel
# bounds-checks (lengths off its 64-row tiles, hd off 16/32/64/128)
FLASH_SHAPES = [(4, 4, 256, 256, 64), (8, 2, 256, 256, 64),
                (6, 6, 128, 128, 128), (2, 1, 512, 512, 32),
                (3, 3, 384, 384, 64), (6, 3, 100, 77, 40),
                (2, 2, 1, 130, 16), (4, 1, 65, 65, 96)]
ATOL = {"bfloat16": 3e-2, "float32": 2e-5}


@pytest.mark.cuda
def test_flash_kernel_matches_plain_version():
    """K4 is within the reference's tolerances of the plain version on
    every shape, causal and bidirectional, bf16 and fp32, and each
    launch is counted."""
    _need_card("K4")
    ops.reset_launches()
    rng = np.random.default_rng(3)
    cases = [(s, c, d) for s in FLASH_SHAPES for c in (True, False)
             for d in ATOL]
    for (BH, BK, Sq, Sk, hd), causal, dtype in cases:
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .cuda().to(getattr(torch, dtype))
                   for s in ((BH, Sq, hd), (BK, Sk, hd), (BK, Sk, hd)))
        got = ops.flash_attention_rows(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        err = float((got.float() - want.float()).abs().max())
        assert err <= ATOL[dtype], ((BH, BK, Sq, Sk, hd), causal, dtype, err)
    assert ops.launches["flash"] == len(cases)


@pytest.mark.cuda
def test_flash_model_layout_on_card():
    """The model-layout wrapper at batch 1 and 2 (GQA fold, strided view
    at batch 1) matches the plain version on the card."""
    _need_card("K4")
    for B in (1, 2):
        q = torch.randn(B, 512, 8, 64, device="cuda", dtype=torch.bfloat16)
        k = torch.randn(B, 512, 2, 64, device="cuda", dtype=torch.bfloat16)
        v = torch.randn(B, 512, 2, 64, device="cuda", dtype=torch.bfloat16)
        got = ops.flash_attention(q, k, v, causal=True)
        rows = [t.transpose(1, 2).reshape(-1, 512, 64) for t in (q, k, v)]
        want = flash_attention_ref(*rows, causal=True)
        err = (got.transpose(1, 2).reshape(-1, 512, 64).float()
               - want.float()).abs().max()
        assert float(err) <= ATOL["bfloat16"]
