"""Port parity, kernel side: K1's wrapper (`repro_torch.kernels.ops.
level_expand`) on CPU tensors — where it runs the plain PyTorch version —
is bit-equal to the reference's oracle `repro.kernels.ref.
level_expand_ref` on the same random CSR windows, in mask, count and
signed mode, and once to the reference's Pallas kernel in interpret mode.

The CUDA kernel itself runs only on a card: the `cuda`-marked test in
tests/test_torch_cuda_kernels.py holds it against the plain version
there and skips elsewhere.  No tolerance:
masks are bools and counts int32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.executor import _segment_member as ref_segment_member
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref

from repro_torch.kernels import ops
from repro_torch.kernels.ref import bs_iters, segment_member

torch.set_num_threads(1)


def _csr_windows(seed, B=24, D=37, P=3, L=50, vmax=200, empty_frac=0.1):
    """Random CSR-layout data (the reference test's generator): a flat
    pool of strictly increasing rows, one per (p, b), lengths 0..L, plus
    candidates, a validity mask and prefix values for the comparisons."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=(P, B)).astype(np.int32)
    lens[rng.random((P, B)) < empty_frac] = 0
    rows = []
    starts = np.zeros((P, B), np.int32)
    off = 0
    for p in range(P):
        for b in range(B):
            starts[p, b] = off
            row = np.sort(rng.choice(vmax, size=lens[p, b], replace=False))
            rows.append(row.astype(np.int32))
            off += lens[p, b]
    flat = np.concatenate(rows) if rows else np.zeros(0, np.int32)
    cand = rng.integers(0, vmax, size=(B, D)).astype(np.int32)
    cand_valid = rng.random((B, D)) < 0.8
    extra = rng.integers(0, vmax, size=(B, 3)).astype(np.int32)
    return cand, flat, starts, lens, extra, cand_valid


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


def _both(cand, flat, starts, lens, extra, valid, **kw):
    got = ops.level_expand(*_t(cand, flat, starts, lens, extra, valid), **kw)
    want = ref_ref.level_expand_ref(cand, flat, starts, lens, extra, valid,
                                    **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("count", [False, True], ids=["mask", "count"])
def test_level_expand_matches_reference(seed, count):
    got, want = _both(*_csr_windows(seed), dirs=(1, -1, 0), count=count,
                      window=50)
    assert got.dtype == (np.int32 if count else np.bool_)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("neg_from", [0, 20, 37])
def test_level_expand_signed_matches_reference(seed, neg_from):
    cand, flat, starts, lens, _, valid = _csr_windows(seed)
    got, want = _both(cand, flat, starts, lens, None, valid, count=True,
                      neg_from=neg_from, window=50)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("P", [1, 2])
def test_level_expand_no_extras(P):
    cand, flat, starts, lens, _, valid = _csr_windows(3, P=P)
    got, want = _both(cand, flat, starts, lens, None, valid, window=50)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("count", [False, True], ids=["mask", "count"])
def test_level_expand_all_rows_empty(count):
    cand, flat, starts, lens, _, valid = _csr_windows(5, P=2)
    lens[:] = 0
    got, want = _both(cand, flat, starts, lens, None, valid, count=count,
                      window=50)
    assert not got.any()
    np.testing.assert_array_equal(got, want)


def test_level_expand_all_pad_candidates():
    """Rows of CAND_PAD candidates (and no validity mask) never match."""
    cand, flat, starts, lens, extra, _ = _csr_windows(6)
    cand[::3] = ops.CAND_PAD
    got, want = _both(cand, flat, starts, lens, extra, None, dirs=(0, 0, 1),
                      count=True, window=50)
    assert (got[::3] == 0).all()
    np.testing.assert_array_equal(got, want)


def test_level_expand_matches_pallas_interpret():
    """Once against the reference's Pallas kernel itself (interpret
    mode), on a tiny case."""
    cand, flat, starts, lens, extra, valid = _csr_windows(
        7, B=8, D=16, P=2, L=20, vmax=40)
    kw = dict(dirs=(1, 0), count=False, window=20)
    got = ops.level_expand(*_t(cand, flat, starts, lens, extra[:, :2],
                               valid), **kw)
    want = ref_ops.level_expand(cand, flat, starts, lens, extra[:, :2],
                                valid, interpret=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_member_matches_reference_portable_search():
    cand, flat, starts, lens, _, _ = _csr_windows(8)
    lo = starts[0][:, None]
    hi = lo + lens[0][:, None]
    iters = bs_iters(50)
    want = np.asarray(ref_segment_member(
        jnp.asarray(flat), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(cand), iters))
    got = segment_member(*_t(flat, lo, hi, cand), iters)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_plain_version_reads_only_inside_flat():
    """A row ending exactly at len(flat) (no sentinel pad): the settled
    binary-search lanes must not index past the array."""
    flat = torch.tensor([1, 3, 5, 7], dtype=torch.int32)
    starts = torch.tensor([[2]], dtype=torch.int32)
    lens = torch.tensor([[2]], dtype=torch.int32)
    cand = torch.tensor([[5, 6, 7, 8]], dtype=torch.int32)
    got = ops.level_expand(cand, flat, starts, lens, window=4)
    assert got.tolist() == [[True, False, True, False]]


def test_cpu_calls_do_not_count_launches():
    ops.reset_launches()
    cand, flat, starts, lens, extra, valid = _csr_windows(0)
    ops.level_expand(*_t(cand, flat, starts, lens, extra, valid),
                     dirs=(1, -1, 0), count=True, window=50)
    assert ops.launches == {"mask": 0, "count": 0, "signed": 0,
                            "membership": 0, "intersect_count": 0,
                            "flash": 0}


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "extra",
                                 "neg_from"])
def test_wrapper_rejects_bad_inputs(bad):
    cand, flat, starts, lens, extra, valid = _t(*_csr_windows(0))
    kw = dict(dirs=(1, -1, 0), window=50)
    if bad == "dtype":
        cand = cand.to(torch.int64)
    elif bad == "contiguity":
        cand = torch.cat([cand, cand], dim=1)[:, ::2]
    elif bad == "shape":
        lens = lens[:, :-1].contiguous()
    elif bad == "extra":
        extra = None
    else:
        kw["neg_from"] = 3
    with pytest.raises((TypeError, ValueError)):
        ops.level_expand(cand, flat, starts, lens, extra, valid, **kw)
