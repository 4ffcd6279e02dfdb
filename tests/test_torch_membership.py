"""Port parity, kernels K2/K3: `repro_torch.kernels.ops.sorted_membership`
and `intersect_count` on CPU tensors (the plain versions the wrappers run
there) against the reference's `repro.kernels.ops` (the Pallas kernels
in interpret mode, as `tests/test_kernels.py` runs them) and its
oracles, on the same numpy inputs.  A port of `tests/test_kernels.py`:
the 7 shapes × {int32, int16} for K2, the 7 shapes for K3, ragged
`cand_valid` / `nbr_len`, the two oracles, block-shape invariance and
duplicate candidates.  No tolerance: outputs are bit-equal.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as rops          # noqa: E402
from repro.kernels import ref as rref          # noqa: E402

from repro_torch.kernels import ops, ref       # noqa: E402

torch.set_num_threads(1)

# tests/test_kernels.py:26-34
SHAPES = [
    (1, 1, 1),
    (3, 5, 7),
    (8, 128, 128),
    (16, 256, 384),
    (9, 130, 200),
    (2, 300, 64),
    (32, 64, 512),
]


def _mk(rng, B, D, L, dtype, hi=2000):
    """tests/test_kernels.py:17-23: strictly increasing rows, candidates
    drawn from the same range."""
    nbr = np.stack(
        [np.sort(rng.choice(hi, size=L, replace=False)) for _ in range(B)]
    ).astype(dtype)
    cand = rng.integers(0, hi, size=(B, D)).astype(dtype)
    return cand, nbr


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [np.int32, np.int16], ids=["i32", "i16"])
def test_membership_matches_reference(shape, dtype):
    B, D, L = shape
    rng = np.random.default_rng(B * 1000 + D + L)
    cand, nbr = _mk(rng, B, D, L, dtype, hi=max(2048, L + 1))
    got = ops.sorted_membership(_t(cand), _t(nbr))
    _eq(got, rops.sorted_membership(jnp.asarray(cand), jnp.asarray(nbr)))
    _eq(got, rref.membership_ref(jnp.asarray(cand), jnp.asarray(nbr)))
    assert ops.launches["membership"] == 0      # CPU: the plain version


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_intersect_count_matches_reference(shape):
    B, D, L = shape
    rng = np.random.default_rng(B + D * 31 + L * 7)
    cand, nbr = _mk(rng, B, D, L, np.int32, hi=max(4096, L + 1))
    got = ops.intersect_count(_t(cand), _t(nbr))
    _eq(got, rops.intersect_count(jnp.asarray(cand), jnp.asarray(nbr)))
    _eq(got, rref.membership_ref(jnp.asarray(cand),
                                 jnp.asarray(nbr)).sum(axis=1))
    assert ops.launches["intersect_count"] == 0


def test_ragged_masks():
    rng = np.random.default_rng(0)
    B, D, L = 6, 100, 150
    cand, nbr = _mk(rng, B, D, L, np.int32)
    nbr_len = rng.integers(0, L + 1, size=B).astype(np.int32)
    nbr_len[2] = 0                               # an empty row
    cand_valid = rng.random((B, D)) < 0.7
    jargs = [jnp.asarray(a) for a in (cand, nbr, cand_valid, nbr_len)]
    targs = [_t(a) for a in (cand, nbr, cand_valid, nbr_len)]
    want = np.zeros((B, D), dtype=bool)
    for b in range(B):
        valid_nbrs = set(nbr[b, : nbr_len[b]].tolist())
        for d in range(D):
            want[b, d] = cand_valid[b, d] and cand[b, d] in valid_nbrs
    got = ops.sorted_membership(*targs)
    _eq(got, want)
    _eq(got, rops.sorted_membership(*jargs))
    cnt = ops.intersect_count(*targs)
    _eq(cnt, want.sum(axis=1).astype(np.int32))
    _eq(cnt, rops.intersect_count(*jargs))


def test_two_oracles_agree():
    rng = np.random.default_rng(3)
    cand, nbr = _mk(rng, 8, 64, 64, np.int32)
    a = ref.membership_ref(_t(cand), _t(nbr))
    b = ref.membership_ref_searchsorted(_t(cand), _t(nbr))
    assert torch.equal(a, b)
    _eq(b, rref.membership_ref_searchsorted(jnp.asarray(cand),
                                            jnp.asarray(nbr)))


def test_intersect_count_ref_keeps_the_reference_shape():
    """The reference's `intersect_count_ref` returns the int32 [B, D] hit
    matrix, not a row count; the port keeps that and names K3's plain
    version `intersect_count_plain`."""
    rng = np.random.default_rng(5)
    cand, nbr = _mk(rng, 4, 40, 30, np.int32, hi=80)
    hits = ref.intersect_count_ref(_t(cand), _t(nbr))
    _eq(hits, rref.intersect_count_ref(jnp.asarray(cand), jnp.asarray(nbr)))
    assert tuple(hits.shape) == (4, 40)
    assert torch.equal(ref.intersect_count_plain(_t(cand), _t(nbr)),
                       hits.sum(dim=1, dtype=torch.int32))


@pytest.mark.parametrize("blocks", [(8, 128, 128), (8, 128, 256),
                                    (16, 256, 128)])
def test_block_shape_invariance(blocks):
    bb, bd, bl = blocks
    rng = np.random.default_rng(9)
    cand, nbr = _mk(rng, 12, 200, 300, np.int32)
    got = ops.sorted_membership(_t(cand), _t(nbr),
                                block_b=bb, block_d=bd, block_l=bl)
    _eq(got, rops.sorted_membership(jnp.asarray(cand), jnp.asarray(nbr),
                                    block_b=bb, block_d=bd, block_l=bl))
    _eq(got, rref.membership_ref(jnp.asarray(cand), jnp.asarray(nbr)))
    cnt = ops.intersect_count(_t(cand), _t(nbr),
                              block_b=bb, block_d=bd, block_l=bl)
    _eq(cnt, rops.intersect_count(jnp.asarray(cand), jnp.asarray(nbr),
                                  block_b=bb, block_d=bd, block_l=bl))


def test_duplicate_candidates_counted_separately():
    cand = np.asarray([[5, 5, 5, 7]], dtype=np.int32)
    nbr = np.asarray([[1, 5, 9, 2**31 - 1]], dtype=np.int32)
    got = ops.intersect_count(_t(cand), _t(nbr))
    assert int(got[0]) == 3
    _eq(got, rops.intersect_count(jnp.asarray(cand), jnp.asarray(nbr)))
    _eq(ops.sorted_membership(_t(cand), _t(nbr)),
        rops.sorted_membership(jnp.asarray(cand), jnp.asarray(nbr)))


def test_edge_shapes():
    """No candidates, no rows, rows of length 0: empty or all-False
    results of the right shape and type, as the reference gives."""
    for B, D, L in ((0, 4, 3), (3, 0, 5), (2, 3, 0)):
        cand = torch.zeros((B, D), dtype=torch.int32)
        nbr = torch.zeros((B, L), dtype=torch.int32)
        m = ops.sorted_membership(cand, nbr)
        c = ops.intersect_count(cand, nbr)
        assert m.dtype == torch.bool and tuple(m.shape) == (B, D)
        assert c.dtype == torch.int32 and tuple(c.shape) == (B,)
        assert not m.any() and not c.any()


def test_wrapper_input_checks():
    cand = torch.zeros((2, 3), dtype=torch.int32)
    nbr = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.sorted_membership(cand.float(), nbr)
    with pytest.raises(ValueError):
        ops.sorted_membership(cand, nbr[:1])
    with pytest.raises(ValueError):
        ops.intersect_count(cand, nbr, nbr_len=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.sorted_membership(cand, nbr, block_l=0)
    with pytest.raises(TypeError):
        ops.sorted_membership(cand, nbr, torch.ones((2, 3), dtype=torch.int32))
