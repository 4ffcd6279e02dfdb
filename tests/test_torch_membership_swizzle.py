"""K2/K3's padded kernel, on the CPU: its shared-memory layout and its
algorithm, walked by `repro_torch.kernels.ref.membership_padded_ref`,
against the reference.

The kernel (`csrc/membership.cu`) stores tile entry i at
`shared_slot(i) = i + (i >> 5) + (i >> 10)` and searches a tile of n
entries with log2(pow2ceil(n)) power-of-two steps.  These tests check
that the map is one to one and additive where the search relies on it,
that the probes of the first search steps fall in distinct shared-memory
banks at n = 1,024 and 4,096 (where a linear row puts them all in one),
and that the twin equals the reference's `sorted_membership` /
`intersect_count` (Pallas in interpret mode, as `tests/test_kernels.py`
runs them) and its oracle on power-of-two and odd row lengths, several
tiles per row, duplicate and -1 candidates and the ragged contract
(`nbr_len` of 0, past L, negative, int64; `cand_valid`; empty rows).
Then the wrapper's kernel route, with the launch stubbed: it hands the
raw rows, `nbr_len` and `cand_valid` to the kernel and builds no padded
copy.  No tolerance: outputs are bit-equal.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as rops          # noqa: E402
from repro.kernels import ref as rref          # noqa: E402

from repro_torch.kernels import membership, ops, ref   # noqa: E402

torch.set_num_threads(1)

BANKS = 32
# tile widths the kernel stages: powers of two up to membership.TILE
# (each tile's buffer holds pow2ceil(n) slots) and the odd lengths the
# card tests use
WIDTHS = [1, 7, 32, 64, 128, 200, 1000, 1024, 4000, 4096, 9000,
          membership.TILE]


def _probes(top, level, slot):
    """Slots probed at search step `level` (0: the first) of a tile
    searched as `top` entries: pos + step - 1 for every reachable pos, a
    multiple of 2·step."""
    step = top >> (level + 1)
    return {slot(p) for p in range(step - 1, top, 2 * step)}


@pytest.mark.parametrize("n", WIDTHS)
def test_shared_slot_is_one_to_one_and_fits(n):
    """The map sends [0, pow2ceil(n)) one to one (strictly increasing)
    into a buffer of slot(top - 1) + 1 words; two buffers a group fit the
    card's 227 KB of shared memory for every tile width."""
    top = ref.pow2ceil(n)
    s = ref.shared_slot(torch.arange(top))
    assert bool((s[1:] > s[:-1]).all()) and int(s[0]) == 0
    assert len(set(s.tolist())) == top
    width = int(ref.shared_slot(top - 1)) + 1
    assert int(s.max()) < width <= top + top // 32 + top // 1024 + 1
    assert 2 * 4 * width <= 232_448


@pytest.mark.parametrize("top", [2, 32, 64, 1024, 4096, membership.TILE])
def test_shared_slot_is_additive_where_the_search_steps(top):
    """For a step 2^k and a position pos that is a multiple of 2^(k+1),
    slot(pos + step - 1) = slot(pos) + slot(step - 1) and
    slot(pos + step) = slot(pos) + slot(step): the kernel probes at a
    constant offset from a running slot and advances it by a constant."""
    slot = ref.shared_slot
    k = 0
    while (1 << k) < top:
        step = 1 << k
        pos = torch.arange(0, top, 2 * step)
        assert torch.equal(slot(pos + step - 1), slot(pos) + slot(step - 1))
        assert torch.equal(slot(pos + step), slot(pos) + slot(step))
        k += 1


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("level", range(6))
def test_first_search_steps_hit_distinct_banks(n, level):
    """At n = 1,024 and 4,096 the probes of each of the first six search
    steps (the first five the kernel's account asks for, and one more)
    lie in distinct banks, so a warp's probe of one step is served at
    once; on a linear row the probes of steps 2-5 all share one bank."""
    probes = _probes(n, level, ref.shared_slot)
    assert len({p % BANKS for p in probes}) == len(probes)
    linear = _probes(n, level, lambda i: i)
    if level >= 2:
        assert len({p % BANKS for p in linear}) == 1


def test_second_pad_term_matters_past_1024():
    """One pad word per 32 alone leaves a 4-way conflict at the fifth
    step of a 4,096-entry row; the extra word per 1,024 removes it."""
    probes = _probes(4096, 4, lambda i: i + (i >> 5))
    assert len({p % BANKS for p in probes}) == len(probes) // 4
    probes = _probes(4096, 4, ref.shared_slot)
    assert len({p % BANKS for p in probes}) == len(probes)


# ------------------------------------------------- twin vs reference ---
# (B, D, L): power-of-two and odd row lengths
SHAPES = [(3, 5, 7), (8, 128, 128), (9, 130, 200), (5, 64, 512),
          (7, 333, 1001), (4, 96, 1024), (2, 70, 4096)]
TILES = [1, 7, 64, 4096]
_want = {}


def _case(shape):
    """Strictly increasing rows of vertex ids, candidates from the same
    range with duplicates and -1s, and the reference's K2 and K3 outputs
    on them (computed once per shape).  (The reference's K3 pads D to its
    block with -1 candidates and counts them where a row holds -1, so
    rows stay non-negative here; `test_twin_minus_one_in_rows` takes
    that case against the oracle.)"""
    B, D, L = shape
    rng = np.random.default_rng(B * 7919 + D * 31 + L)
    hi = max(2048, 2 * L)
    nbr = np.stack([np.sort(rng.choice(hi, size=L, replace=False))
                    for _ in range(B)]).astype(np.int32)
    cand = rng.integers(-1, hi, size=(B, D)).astype(np.int32)
    cand[:, 1::7] = cand[:, :1]                  # duplicates
    cand[:, ::11] = -1
    if shape not in _want:
        jc, jn = jnp.asarray(cand), jnp.asarray(nbr)
        _want[shape] = (np.asarray(rops.sorted_membership(jc, jn)),
                        np.asarray(rops.intersect_count(jc, jn)),
                        np.asarray(rref.membership_ref(jc, jn)))
    return cand, nbr, _want[shape]


def _eq(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,tile", [
    (s, t) for s in SHAPES for t in TILES if t > 1 or s[2] <= 1024],
    ids=str)
def test_twin_matches_reference(shape, tile):
    """The twin, with rows cut into tiles of 1..4,096 entries (one-entry
    tiles on rows up to 1,024), equals the reference's K2 and K3 and its
    broadcast oracle."""
    cand, nbr, (want_m, want_c, oracle) = _case(shape)
    c, n = torch.from_numpy(cand), torch.from_numpy(nbr)
    m = ref.membership_padded_ref(c, n, tile=tile, count=False)
    _eq(m, want_m)
    _eq(m, oracle)
    _eq(ref.membership_padded_ref(c, n, tile=tile, count=True), want_c)


LENS = {
    "empty rows": lambda L, B: np.where(np.arange(B) % 2 == 0, 0, L),
    "past L": lambda L, B: np.full(B, L + 5),
    "negative": lambda L, B: np.arange(B) - B,
    "mixed int64": lambda L, B: np.array([0, 1, L - 1, L, L + 1, 2**40,
                                          -1, -2**40, L // 2][:B]),
    "all zero": lambda L, B: np.zeros(B, dtype=np.int64),
}


@pytest.mark.parametrize("tile", [7, 64, 4096])
@pytest.mark.parametrize("lens", list(LENS))
def test_twin_ragged_matches_reference(lens, tile):
    """nbr_len of 0, past L, negative and int64, with cand_valid: the
    twin reads the ragged contract as the reference's wrappers apply it
    (nbr_len clamped to [0, L]; invalid candidates are -1, which matches
    a -1 in a row's valid prefix)."""
    B, D, L = 9, 150, 300
    rng = np.random.default_rng(len(lens) * 101 + tile)
    cand, nbr, _ = _case((B, D, L))
    nbr_len = LENS[lens](L, B).astype(np.int64)
    valid = rng.random((B, D)) < 0.7
    jlen = np.clip(nbr_len, -2**31, 2**31 - 1).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (cand, nbr, valid, jlen)]
    want = np.zeros((B, D), dtype=bool)
    for b in range(B):
        row = set(nbr[b, :max(0, min(L, nbr_len[b]))].tolist())
        want[b] = [(c if ok else -1) in row
                   for c, ok in zip(cand[b], valid[b])]
    targs = [torch.from_numpy(a) for a in (cand, nbr, nbr_len, valid)]
    m = ref.membership_padded_ref(*targs, tile=tile, count=False)
    _eq(m, want)
    _eq(m, rops.sorted_membership(*jargs))
    cnt = ref.membership_padded_ref(*targs, tile=tile, count=True)
    _eq(cnt, rops.intersect_count(*jargs))
    _eq(cnt, want.sum(axis=1).astype(np.int32))


@pytest.mark.parametrize("tile", [1, 5, 4096])
def test_twin_minus_one_in_rows(tile):
    """An invalid candidate becomes -1 and is searched, not skipped: it
    matches a -1 in the row's valid prefix (as the plain version, which
    writes -1 over it, finds), and not one past the prefix."""
    rng = np.random.default_rng(23)
    B, D, L = 6, 60, 40
    nbr = np.sort(rng.choice(np.arange(-1, 300), size=(B, L)), axis=1)
    nbr[:, 0] = -1
    nbr = nbr.astype(np.int32)
    cand = rng.integers(-1, 300, size=(B, D)).astype(np.int32)
    valid = rng.random((B, D)) < 0.5
    nbr_len = np.array([0, 1, 2, L, 17, -4])
    targs = [torch.from_numpy(a) for a in (cand, nbr, nbr_len, valid)]
    got = ref.membership_padded_ref(*targs, tile=tile, count=False)
    want = np.zeros((B, D), dtype=bool)
    for b in range(B):
        row = set(nbr[b, :max(0, nbr_len[b])].tolist())
        want[b] = [(c if ok else -1) in row
                   for c, ok in zip(cand[b], valid[b])]
    _eq(got, want)
    assert bool(got[1:4][~targs[3][1:4]].all())      # -1 found in rows 1-3
    assert torch.equal(got, ops.sorted_membership(
        targs[0], targs[1], targs[3], targs[2]))
    _eq(ref.membership_padded_ref(*targs, tile=tile, count=True),
        want.sum(axis=1).astype(np.int32))


@pytest.mark.parametrize("tile", [1, 64])
def test_twin_runs_of_equal_entries_across_tiles(tile):
    """Runs of equal entries across tile boundaries (K2 takes rows that
    are only non-decreasing): each candidate is still decided by exactly
    one tile and found."""
    rng = np.random.default_rng(17)
    nbr = np.sort(rng.integers(0, 400, size=(6, 300)), axis=1)
    nbr[:, 100:140] = nbr[:, 100:101]
    nbr = np.sort(nbr, axis=1).astype(np.int32)
    cand = rng.integers(0, 400, size=(6, 200)).astype(np.int32)
    cand[:, :20] = nbr[:, 100:101]
    got = ref.membership_padded_ref(torch.from_numpy(cand),
                                    torch.from_numpy(nbr), tile=tile,
                                    count=False)
    _eq(got, rref.membership_ref(jnp.asarray(cand), jnp.asarray(nbr)))


# ------------------------------------------------- the kernel route ---
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16],
                         ids=["i32", "i16"])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("count", [False, True], ids=["K2", "K3"])
def test_kernel_route_passes_raw_rows(monkeypatch, count, ragged, dtype):
    """On the kernel route the wrapper hands the kernel the rows as they
    are (int32 ones by storage, int16 ones widened), nbr_len clamped to
    [0, L] as int32 [B] and cand_valid as given, and builds no padded
    [B, L] or [B, D] copy (`_stacked_rows`, `torch.where` and
    `torch.arange` are never called); the kernel's result comes back and
    the launch is counted."""
    B, D, L = 6, 40, 50
    rng = np.random.default_rng(int(count) * 4 + int(ragged) * 2
                                + (dtype == torch.int16))
    cand = torch.from_numpy(rng.integers(0, 200, size=(B, D))).to(dtype)
    nbr = torch.from_numpy(np.sort(rng.integers(0, 200, size=(B, L)),
                                   axis=1)).to(dtype)
    kw = {}
    if ragged:
        kw = dict(cand_valid=torch.from_numpy(rng.random((B, D)) < 0.6),
                  nbr_len=torch.tensor([0, -3, 7, L, L + 9, 2**40]))
    calls = []
    sentinel = torch.zeros((B,) if count else (B, D),
                           dtype=torch.int32 if count else torch.bool)

    def launch(c, n, nbr_len=None, cand_valid=None, *, count, **launch_kw):
        calls.append((c, n, nbr_len, cand_valid, count, launch_kw))
        return sentinel

    def refuse(*a, **k):
        raise AssertionError("a padded copy on the kernel route")

    monkeypatch.setattr(ops, "launches", dict.fromkeys(ops.launches, 0))
    monkeypatch.setattr(ops, "_route", lambda d: "kernel")
    monkeypatch.setattr(ops._k23, "membership_cuda", launch)
    monkeypatch.setattr(ops, "_stacked_rows", refuse)
    monkeypatch.setattr(torch, "where", refuse)
    monkeypatch.setattr(torch, "arange", refuse)
    fn = ops.intersect_count if count else ops.sorted_membership
    got = fn(cand, nbr, kw.get("cand_valid"), kw.get("nbr_len"))
    launched = dict(ops.launches)
    monkeypatch.undo()

    assert got is sentinel and len(calls) == 1
    c, n, nbr_len, cand_valid, was_count, launch_kw = calls[0]
    assert was_count == count and launch_kw == {}
    assert c.dtype == n.dtype == torch.int32
    assert c.is_contiguous() and n.is_contiguous()
    assert tuple(c.shape) == (B, D) and tuple(n.shape) == (B, L)
    assert torch.equal(c, cand.to(torch.int32))
    assert torch.equal(n, nbr.to(torch.int32))
    if dtype == torch.int32:
        assert c.data_ptr() == cand.data_ptr()
        assert n.data_ptr() == nbr.data_ptr()
    if ragged:
        assert cand_valid is kw["cand_valid"]
        assert nbr_len.dtype == torch.int32 and nbr_len.is_contiguous()
        assert nbr_len.tolist() == [0, 0, 7, L, L, L]
    else:
        assert nbr_len is None and cand_valid is None
    assert launched == {**dict.fromkeys(launched, 0),
                        "intersect_count" if count else "membership": 1}
    # what the kernel would return on those arguments equals the plain
    # route's answer
    twin = ref.membership_padded_ref(c, n, nbr_len, cand_valid,
                                     tile=membership.TILE, count=count)
    assert torch.equal(twin, fn(cand, nbr, kw.get("cand_valid"),
                                kw.get("nbr_len")))
