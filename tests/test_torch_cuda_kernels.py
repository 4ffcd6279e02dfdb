"""The port's CUDA kernels on a card: K1 (`level_expand.cu`), K2/K3
(`membership.cu`) and K4 (`flash_attention.cu`) built with nvcc and held
against their plain PyTorch versions, every launch counted.

These tests carry the `cuda` marker and skip without a card.  This file
imports neither JAX nor the reference package, so it also runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import membership, ops
from repro_torch.kernels.ref import (flash_attention_ref,
                                    intersect_count_plain, level_expand_ref,
                                    membership_ref_searchsorted)


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
                            "membership": 0, "intersect_count": 0,
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


# bf16 shapes of the wgmma kernel (BH, BK, Sq, Sk, hd, causal): the
# qwen3-1.7b serving shape, multi-query attention with granite-34b's 48
# query heads over one KV head, lengths off the 128-row tiles, and a
# bidirectional one at hd 64
WGMMA_CASES = [(64, 32, 2048, 2048, 128, True), (48, 1, 1024, 1024, 128, True),
               (6, 3, 1000, 777, 128, True), (8, 8, 2048, 2048, 64, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_flash_wgmma_kernel_shapes(case):
    """The wgmma kernel at serving-size, MQA, ragged and bidirectional
    shapes: within the bf16 tolerance of the plain version, launched
    (and counted) as the wgmma variant, and bit-equal over two launches."""
    _need_card("K4")
    from repro_torch.kernels import flash_attention as k4

    BH, BK, Sq, Sk, hd, causal = case
    g = torch.Generator(device="cuda").manual_seed(sum(case))
    q, k, v = (torch.randn(s, generator=g, device="cuda").bfloat16()
               for s in ((BH, Sq, hd), (BK, Sk, hd), (BK, Sk, hd)))
    ops.reset_launches()
    got = ops.flash_attention_rows(q, k, v, causal=causal)
    again = ops.flash_attention_rows(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATOL["bfloat16"], (case, err)
    assert torch.equal(got, again)
    assert ops.launches["flash"] == 2
    assert k4.variant_launches == {"scalar": 0, "wgmma": 2}


@pytest.mark.cuda
def test_flash_variant_rule_and_counters():
    """The source's static rule: bf16 with hd % 8 == 0 launches the wgmma
    kernel, fp32 and other head dims the scalar one, each counted; a
    forced variant that does not take the inputs and a misaligned pointer
    raise instead of falling back."""
    _need_card("K4")
    from repro_torch.kernels import flash_attention as k4

    cases = [(torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 40, "wgmma"),
             (torch.float32, 64, "scalar"), (torch.bfloat16, 12, "scalar"),
             (torch.float32, 12, "scalar")]
    for dtype, hd, variant in cases:
        assert k4.variant_of(dtype, hd) == variant
        q, k, v = (torch.randn(2, 130, hd, device="cuda", dtype=dtype)
                   for _ in range(3))
        ops.reset_launches()
        got = ops.flash_attention_rows(q, k, v, causal=True)
        want = flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
        assert float((got.float() - want.float()).abs().max()) <= ATOL[dname]
        assert k4.variant_launches == {n: int(n == variant)
                                       for n in k4.VARIANTS}, (dtype, hd)
    q = torch.randn(1, 64, 64, device="cuda")
    with pytest.raises(RuntimeError, match="wgmma"):
        k4.flash_attention_cuda(q, q, q, variant="wgmma")
    flat = torch.randn(64 * 64 + 1, device="cuda", dtype=torch.bfloat16)
    q = flat[1:].view(1, 64, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k4.flash_attention_cuda(q, q, q)


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


# K2/K3: the reference test's shapes (tests/test_kernels.py:26-34), then
# rows longer than one shared tile (membership.TILE = 4,096 int32)
MEMBERSHIP_SHAPES = [(1, 1, 1), (3, 5, 7), (8, 128, 128), (16, 256, 384),
                     (9, 130, 200), (2, 300, 64), (32, 64, 512),
                     (4, 700, 9000), (1, 1, 5000)]


def _rows(seed, B, D, L, dtype=np.int32, hi=None):
    """Strictly increasing rows and candidates from the same range."""
    rng = np.random.default_rng(seed)
    hi = hi or max(2048, 2 * L)
    nbr = np.stack([np.sort(rng.choice(hi, size=L, replace=False))
                    for _ in range(B)]).astype(dtype)
    cand = rng.integers(0, hi, size=(B, D)).astype(dtype)
    return rng, cand, nbr


def _both(cand, nbr, **kw):
    """(mask, count) from the kernels and from the plain versions."""
    got = (ops.sorted_membership(cand, nbr, **kw),
           ops.intersect_count(cand, nbr, **kw))
    c32, n32 = ops._stacked_rows(cand, nbr, kw.get("cand_valid"),
                                 kw.get("nbr_len"), (1, 1, 1))
    want = (membership_ref_searchsorted(c32, n32),
            intersect_count_plain(c32, n32))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int16], ids=["i32", "i16"])
def test_membership_kernels_match_plain_version(dtype):
    """K2 and K3 are bit-equal to the plain versions on the reference
    shapes and rows past one shared tile, int32 and int16 inputs, and
    each launch is counted."""
    _need_card("K2/K3")
    ops.reset_launches()
    for i, (B, D, L) in enumerate(MEMBERSHIP_SHAPES):
        hi = 30000 if dtype == np.int16 else None
        _, cand, nbr = _rows(i, B, D, L, dtype, hi)
        (m, c), (wm, wc) = _both(torch.from_numpy(cand).cuda(),
                                 torch.from_numpy(nbr).cuda())
        assert torch.equal(m, wm), (B, D, L)
        assert torch.equal(c, wc), (B, D, L)
    n = len(MEMBERSHIP_SHAPES)
    assert (ops.launches["membership"], ops.launches["intersect_count"]) \
        == (n, n)


@pytest.mark.cuda
def test_membership_kernels_ragged_and_duplicates():
    """Ragged cand_valid / nbr_len (empty rows included), duplicate
    candidates counted separately, and rows whose valid prefix ends
    inside a tile."""
    _need_card("K2/K3")
    for B, D, L in ((6, 100, 150), (5, 333, 9000)):
        rng, cand, nbr = _rows(11, B, D, L)
        nbr_len = rng.integers(0, L + 1, size=B).astype(np.int32)
        nbr_len[0] = 0
        valid = rng.random((B, D)) < 0.7
        dev = [torch.from_numpy(a).cuda() for a in (cand, nbr, valid,
                                                    nbr_len)]
        (m, c), (wm, wc) = _both(dev[0], dev[1], cand_valid=dev[2],
                                 nbr_len=dev[3])
        assert torch.equal(m, wm) and torch.equal(c, wc)
        assert int(c[0]) == 0
    cand = torch.tensor([[5, 5, 5, 7]], dtype=torch.int32, device="cuda")
    nbr = torch.tensor([[1, 5, 9, 2**31 - 1]], dtype=torch.int32,
                       device="cuda")
    assert int(ops.intersect_count(cand, nbr)[0]) == 3
    assert ops.sorted_membership(cand, nbr).tolist() == [[True] * 3 + [False]]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1, 7, 64, 128, 4096])
def test_membership_kernel_tile_invariance(tile):
    """The shared-memory tile width (and the wrapper's block sizes) never
    change the result: rows of 300 entries searched in 1-300 tiles,
    rows with runs of equal entries across tile boundaries."""
    _need_card("K2/K3")
    rng, cand, nbr = _rows(21, 12, 200, 300)
    nbr[:, 100:140] = nbr[:, 100:101]            # a run of equal entries
    nbr = np.sort(nbr, axis=1)
    cand[:, :20] = nbr[:, 100:101]
    c_d, n_d = torch.from_numpy(cand).cuda(), torch.from_numpy(nbr).cuda()
    want_m = membership_ref_searchsorted(c_d, n_d)
    for count in (False, True):
        got = membership.membership_cuda(c_d, n_d, count=count, tile=tile)
        want = (want_m.sum(dim=1, dtype=torch.int32) if count else want_m)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (tile, count)
    for bb, bd, bl in ((8, 128, 128), (8, 128, 256), (16, 256, 128)):
        assert torch.equal(ops.sorted_membership(
            c_d, n_d, block_b=bb, block_d=bd, block_l=bl), want_m)


# The padded kernel (`membership_cuda`, behind the wrappers) on phase
# 10's cases: rows of 1,000 / 1,024 / 4,096 entries, D and L off
# multiples of 4 (the 4-byte path), ragged rows with nbr_len past L,
# negative, int64 and all zero, -1 in the rows.
PADDED_CASES = [(64, 1024, 1000), (64, 1024, 1024), (16, 512, 4096),
                (7, 333, 1001), (9, 130, 200), (3, 5, 7), (4, 700, 9000)]


def _ragged(rng, B, D, L, dtype=np.int32):
    lens = rng.integers(-3, L + 4, size=B).astype(dtype)
    lens[0], lens[-1] = 0, L + 10**3
    return [torch.from_numpy(a).cuda()
            for a in (lens, rng.random((B, D)) < 0.7)]


def _first_version(cand, nbr, **kw):
    """The first version (a block per row, linear tile) on the wrapper's
    former padded copies."""
    c32, n32 = ops._stacked_rows(cand, nbr, kw.get("cand_valid"),
                                 kw.get("nbr_len"), (1, 1, 1))
    return (membership.membership_linear_cuda(c32, n32, count=False),
            membership.membership_linear_cuda(c32, n32, count=True))


@pytest.mark.cuda
@pytest.mark.parametrize("case", PADDED_CASES, ids=str)
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_padded_kernel_matches_plain_and_first_version(case, ragged):
    """The padded kernel is bit-equal to the plain version and to the
    first version on the same tensors, full or ragged (the wrapper hands
    nbr_len and cand_valid to the kernel, no padded copy), and every
    launch is counted per kernel."""
    _need_card("K2/K3")
    B, D, L = case
    rng, cand, nbr = _rows(sum(case), B, D, L)
    cand[:, ::5] = -1                            # -1 is a candidate too
    nbr[:, 0] = -1
    c_d, n_d = torch.from_numpy(cand).cuda(), torch.from_numpy(nbr).cuda()
    kw = {}
    if ragged:
        nbr_len, valid = _ragged(rng, B, D, L, np.int64)
        kw = dict(cand_valid=valid, nbr_len=nbr_len)
    ops.reset_launches()
    (m, c), (wm, wc) = _both(c_d, n_d, **kw)
    assert torch.equal(m, wm) and torch.equal(c, wc), case
    assert membership.kernel_launches == {"padded": 2, "linear": 0}
    fm, fc = _first_version(c_d, n_d, **kw)
    assert torch.equal(m, fm) and torch.equal(c, fc), case


@pytest.mark.cuda
@pytest.mark.parametrize("nbr_len", ["int64", "int32", "zero"])
def test_padded_kernel_row_lengths(nbr_len):
    """nbr_len is clamped to [0, L] as `pos < nbr_len` implies, whatever
    its integer type; all-zero lengths leave every candidate a miss."""
    _need_card("K2/K3")
    rng, cand, nbr = _rows(31, 12, 200, 300)
    lens = np.array([0, 1, 299, 300, 301, 10**6, -1, -10**6, 2**40,
                     -2**40, 150, 7], dtype=np.int64)
    if nbr_len == "int32":
        lens = lens.clip(-2**31, 2**31 - 1).astype(np.int32)
    elif nbr_len == "zero":
        lens[:] = 0
    c_d, n_d = torch.from_numpy(cand).cuda(), torch.from_numpy(nbr).cuda()
    (m, c), (wm, wc) = _both(c_d, n_d, nbr_len=torch.from_numpy(lens).cuda())
    assert torch.equal(m, wm) and torch.equal(c, wc)
    if nbr_len == "zero":
        assert not m.any() and not c.any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 256, 384), (64, 1024, 1024)],
                         ids=str)
def test_padded_kernel_misaligned_views(shape):
    """cand (and cand_valid) views whose data_ptr lies 4 bytes (1 byte)
    off a 16-byte boundary take the kernel's 4-byte path and give the
    same result as aligned copies."""
    _need_card("K2/K3")
    B, D, L = shape
    rng, cand, nbr = _rows(41, B, D, L)
    valid = rng.random((B, D)) < 0.7

    def off(a, k):
        t = torch.from_numpy(np.ascontiguousarray(a)).cuda()
        buf = torch.empty(t.numel() + k, dtype=t.dtype, device="cuda")
        v = buf[k:].view(t.shape)
        v.copy_(t)
        return v

    c_off, v_off = off(cand, 1), off(valid, 1)
    assert c_off.data_ptr() % 16 == 4 and v_off.data_ptr() % 4 == 1
    n_d = torch.from_numpy(nbr).cuda()
    want = _both(torch.from_numpy(cand).cuda(), n_d,
                 cand_valid=torch.from_numpy(valid).cuda())[1]
    got = _both(c_off, n_d, cand_valid=v_off)[0]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = (ops.sorted_membership(c_off, off(nbr, 1)),
           ops.intersect_count(c_off, off(nbr, 1)))
    torch.cuda.synchronize()
    want = _both(torch.from_numpy(cand).cuda(), n_d)[1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1, 7, 64, 4096, membership.TILE])
def test_padded_kernel_tile_and_group_invariance(tile):
    """Neither the tile width nor the group size (a warp or a block per
    row, forced) changes the padded kernel's result: rows of 300 entries
    in 1-300 tiles, runs of equal entries across tile boundaries, ragged
    rows whose valid prefix ends inside a tile."""
    _need_card("K2/K3")
    rng, cand, nbr = _rows(21, 12, 200, 300)
    nbr[:, 100:140] = nbr[:, 100:101]
    nbr = np.sort(nbr, axis=1)
    cand[:, :20] = nbr[:, 100:101]
    nbr_len, valid = _ragged(rng, 12, 200, 300)
    c_d, n_d = torch.from_numpy(cand).cuda(), torch.from_numpy(nbr).cuda()
    for lens, ok in ((None, None), (nbr_len, valid)):
        c32, n32 = ops._stacked_rows(c_d, n_d, ok, lens, (1, 1, 1))
        want_m = membership_ref_searchsorted(c32, n32)
        if lens is not None:
            lens = lens.clamp(0, 300)            # as the wrapper passes it
        for count in (False, True):
            want = want_m.sum(dim=1, dtype=torch.int32) if count else want_m
            for group in (0, 32, 256):
                got = membership.membership_cuda(c_d, n_d, lens, ok,
                                                 count=count, tile=tile,
                                                 group=group)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (tile, group, count)


@pytest.mark.cuda
def test_padded_kernel_launch_failures_raise(monkeypatch, tmp_path):
    """No fallback: a tile out of range is refused, a launch the source
    refuses (a group size it has no kernel for) raises, and a source
    that does not build raises."""
    _need_card("K2/K3")
    _, cand, nbr = _rows(51, 4, 64, 128)
    c_d, n_d = torch.from_numpy(cand).cuda(), torch.from_numpy(nbr).cuda()
    with pytest.raises(ValueError):
        membership.membership_cuda(c_d, n_d, count=False,
                                   tile=membership.TILE + 1)
    with pytest.raises(ValueError):
        membership.membership_linear_cuda(c_d, n_d, count=False,
                                          tile=membership.LINEAR_TILE + 1)
    with pytest.raises(RuntimeError):
        membership.membership_cuda(c_d, n_d, count=True, group=64)
    broken = tmp_path / "membership_broken.cu"
    broken.write_text("extern \"C\" int membership_launch( {\n")
    monkeypatch.setattr(membership, "SOURCE", broken)
    monkeypatch.setattr(membership, "_lib", None)
    with pytest.raises(RuntimeError):
        membership.membership_cuda(c_d, n_d, count=False)


# ------------------------------------------- K1, row-sourced count mode ---
def rows_case(seed, B, P, *, width, window, L, Q=0, label=False,
              vmax=None, own_frac=0.75):
    """numpy inputs of `ops.level_expand_rows`, shaped as the executor
    gives them: a pool of strictly increasing rows (some empty, some of
    exactly `L` entries, some longer than `window`, some spanning the
    whole value range) in one flat array with the sentinel pad; each
    frontier row picks P of them, and its candidates are the row of the
    predecessor `own[b]` (a random subset of it in a separate array when
    `label`), or, where own[b] = -1, any pool row.  Empty candidate rows,
    comparisons (>, <, !=) whose ranges are empty, partial or whole, and
    Q prefix columns holding common members, members of the candidate
    row, random values and duplicates.  `width` <= `window`, so a row's
    first `width` entries lie in its first `window` ones."""
    from repro_torch.kernels.ops import NBR_PAD, flat_gather_pad

    rng = np.random.default_rng(seed)
    vmax = vmax or 3 * L
    n_rows = max(8, B // 3)
    lens_pool = rng.integers(0, L + 1, size=n_rows)
    lens_pool[rng.random(n_rows) < 0.1] = 0
    lens_pool[:3] = [L, L - 1, min(L + 1, vmax)]
    rows = []
    for r, n in enumerate(lens_pool):
        row = np.sort(rng.choice(vmax, size=int(n), replace=False))
        if r % 5 == 4 and n >= 2:                  # spans the value range
            row[0], row[-1] = 0, vmax - 1
            row = np.unique(row)
        rows.append(row.astype(np.int32))
    offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    flat = np.concatenate(rows + [np.full(flat_gather_pad(), NBR_PAD,
                                          np.int32)]).astype(np.int32)
    pick = rng.integers(0, n_rows, size=(P, B))
    starts = offs[pick].astype(np.int32)
    lens = np.array([[len(rows[r]) for r in pr] for pr in pick], np.int32)
    own = np.where(rng.random(B) < own_frac, rng.integers(0, P, size=B),
                   -1).astype(np.int32)
    src_rows = [rows[pick[o, b]] if o >= 0 else rows[rng.integers(n_rows)]
                for b, o in enumerate(own)]
    if label:                 # labeled subsets of the searched prefix
        src_rows = [r[:window][rng.random(min(len(r), window)) < 0.6]
                    for r in src_rows]
    src_rows = [r if rng.random() > 0.05 else r[:0] for r in src_rows]
    if label or (own < 0).any():
        coffs = np.concatenate([[0], np.cumsum([len(r) for r in src_rows])])
        csrc = np.concatenate(src_rows + [np.full(flat_gather_pad(),
                                                  NBR_PAD, np.int32)])
        cstart = coffs[:-1]
    else:
        csrc, cstart = flat, starts[own, np.arange(B)]
    clen = np.array([len(r) for r in src_rows], np.int32)
    extra = rng.integers(0, vmax, size=(B, 3)).astype(np.int32)
    extra[rng.random(B) < 0.1, 0] = vmax          # > empties the range
    extra[rng.random(B) < 0.1, 1] = vmax          # < keeps all of it
    extra[rng.random(B) < 0.1, 0] = -1            # > keeps all of it
    neg = rng.integers(0, vmax, size=(B, Q)).astype(np.int32)
    for b in range(B):
        inter = src_rows[b]
        for p in range(P):
            inter = np.intersect1d(inter, rows[pick[p, b]])
        if Q and len(inter):
            neg[b, 0] = rng.choice(inter)
        if Q > 1 and len(src_rows[b]):
            neg[b, 1] = rng.choice(src_rows[b])
        if Q > 2:
            neg[b, 2] = neg[b, 0]                  # a duplicate
    return dict(csrc=csrc.astype(np.int32), cstart=cstart.astype(np.int32),
                clen=clen, flat=flat, starts=starts, lens=lens, own=own,
                extra=extra, neg=neg, width=width, window=window)


def _rows_on_card(case):
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).cuda()
                if isinstance(v, np.ndarray) else v) for k, v in case.items()}


def _rows_both(c, dirs, signed, own=True, **launch):
    """(kernel, plain version) of the row-sourced entry on one case;
    `launch` given = the CUDA launcher with those launch shapes, else
    the public wrapper."""
    from repro_torch.kernels import intersect
    from repro_torch.kernels.ref import level_expand_rows_ref

    args = (c["csrc"], c["cstart"], c["clen"], c["flat"], c["starts"],
            c["lens"], c["own"] if own else None,
            c["extra"][:, :len(dirs)].contiguous() if dirs else None,
            c["neg"] if signed else None)
    kw = dict(dirs=dirs, width=c["width"], window=c["window"])
    got = (intersect.level_rows_cuda(*args, **kw, **launch) if launch
           else ops.level_expand_rows(*args, **kw))
    want = level_expand_rows_ref(*args, **kw)
    torch.cuda.synchronize()
    return got, want


# (group, P, labeled, Q, width, L): every group size of the kernel, rows
# longer than a shared tile at the smallest tiles, rows of several
# candidate chunks (width > 16 x group), P = 1 (own row and prefix
# columns only) to 4
ROWS_CASES = [(8, 2, False, 0, 100, 180), (8, 1, False, 4, 128, 130),
              (32, 3, True, 4, 300, 380), (256, 2, False, 4, 1000, 1100),
              (256, 4, True, 0, 2100, 2200), (8, 4, False, 4, 64, 90),
              (8, 2, True, 4, 300, 700), (32, 3, False, 4, 1200, 1300)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROWS_CASES,
                         ids=lambda c: f"G{c[0]}-P{c[1]}"
                         f"{'-lab' if c[2] else ''}-Q{c[3]}")
def test_rows_kernel_matches_plain_version(case):
    """The row-sourced kernel is bit-equal to its plain version in count
    and signed mode: every comparison set (ranges empty, partial, whole),
    own given and not (-1 rows included), window below some row lengths,
    empty candidate and predecessor rows, rows of exactly a tile and
    longer (tile_per_lane 1..32), B not a multiple of the rows per block,
    and a grid capped so each group walks many rows."""
    _need_card("K1")
    group, P, label, Q, width, L = case
    c = _rows_on_card(rows_case(group + P, 333, P, width=width,
                                window=width + 40, L=L, Q=Q, label=label))
    for dirs in ((), (1,), (1, -1, 0), (0, 0)):
        for signed in ((False, True) if Q else (False,)):
            for own in (True, False):
                for tpl, mb in ((32, 0), (1, 3), (2, 1)):
                    got, want = _rows_both(c, dirs, signed, own, group=group,
                                           tile_per_lane=tpl, max_blocks=mb)
                    assert torch.equal(got, want), (dirs, signed, own, tpl,
                                                    mb)


@pytest.mark.cuda
def test_rows_kernel_edges_relaunch_and_counters():
    """Exactly-one-tile rows (tile_per_lane * group entries), all rows
    empty, relaunches bit-equal, and the public wrapper counting one
    `count` or `signed` launch per call (none for B = 0)."""
    _need_card("K1")
    c = _rows_on_card(rows_case(5, 200, 2, width=128, window=200, L=192,
                                Q=3))
    got, want = _rows_both(c, (1, -1, 0), True, group=8, tile_per_lane=24)
    assert torch.equal(got, want)
    again, _ = _rows_both(c, (1, -1, 0), True, group=8, tile_per_lane=24)
    assert torch.equal(again, got)
    empty = dict(c, lens=torch.zeros_like(c["lens"]))
    got, want = _rows_both(empty, (), True, group=8)
    assert torch.equal(got, want)
    ops.reset_launches()
    for signed in (False, True, True):
        got, want = _rows_both(c, (0,), signed)
        assert torch.equal(got, want)
    zero = {k: (v[..., :0].contiguous() if k in ("starts", "lens") else
                v[:0].contiguous() if k in ("cstart", "clen", "own", "extra",
                                            "neg") else v)
            for k, v in c.items()}
    assert _rows_both(zero, (), False)[0].shape == (0,)
    assert ops.launches == {"mask": 0, "count": 1, "signed": 2,
                            "membership": 0, "intersect_count": 0,
                            "flash": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "contiguity", "device", "own"])
def test_rows_wrapper_refuses_bad_inputs_on_card(bad):
    _need_card("K1")
    c = _rows_on_card(rows_case(6, 40, 2, width=32, window=40, L=40, Q=2))
    if bad == "dtype":
        c["clen"] = c["clen"].to(torch.int64)
    elif bad == "contiguity":
        c["lens"] = torch.cat([c["lens"], c["lens"]], 1)[:, ::2]
    elif bad == "device":
        c["cstart"] = c["cstart"].cpu()
    else:
        c["own"][7] = 2
    with pytest.raises((TypeError, ValueError)):
        _rows_both(c, (1,), True)


# ------------------------------------ K1, mask mode with the compaction ---
def compact_both(c, dirs, own=True, *, C, offset0=0, **launch):
    """(kernel, plain version) of the mask-and-compact entry on one card
    case `c` (a `rows_case` on the card), each as (parent[:C],
    newcol[:C], offset) after one call into its own buffers (both
    filled with -7) behind an int64 offset of `offset0`; `launch` given
    = the CUDA launcher with those launch shapes, else the public
    wrapper."""
    from repro_torch.kernels import intersect
    from repro_torch.kernels.ref import level_expand_compact_ref

    B = c["cstart"].numel()
    rows = (torch.arange(B, dtype=torch.int32, device="cuda") * 5 + 2)
    out = []
    for which in ("kernel", "plain"):
        parent = torch.full((C + 1,), -7, dtype=torch.int32, device="cuda")
        newcol = torch.full((C + 1,), -7, dtype=torch.int32, device="cuda")
        offset = torch.tensor(offset0, dtype=torch.int64, device="cuda")
        args = (c["csrc"], c["cstart"], c["clen"], c["flat"], c["starts"],
                c["lens"], c["own"] if own else None,
                c["extra"][:, :len(dirs)].contiguous() if dirs else None,
                rows, offset, parent, newcol)
        kw = dict(dirs=dirs, width=c["width"], window=c["window"])
        if which == "plain":
            level_expand_compact_ref(*args, **kw)
        elif launch:
            intersect.level_compact_cuda(*args, **kw, **launch)
        else:
            ops.level_expand_compact(*args, **kw)
        out.append((parent[:C], newcol[:C], int(offset)))
    torch.cuda.synchronize()
    return out


def _survivors(c, dirs, own=True):
    from repro_torch.kernels.ref import level_expand_rows_ref

    return int(level_expand_rows_ref(
        c["csrc"], c["cstart"], c["clen"], c["flat"], c["starts"], c["lens"],
        c["own"] if own else None,
        c["extra"][:, :len(dirs)].contiguous() if dirs else None, None,
        dirs=dirs, width=c["width"], window=c["window"]).sum())


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got[:2], want[:2])) \
        and got[2] == want[2]


# (group, P, labeled, width, L): every group size, rows longer than a
# shared tile at the smallest tiles, rows of several candidate chunks
# (width > 16 x group), P = 1 (own row only) to 4; group 0 takes the
# source's mask rule (`level_compact_group`)
COMPACT_CASES = [(8, 2, False, 100, 180), (8, 1, True, 128, 130),
                 (32, 3, True, 300, 380), (32, 4, False, 1200, 1300),
                 (256, 2, False, 1000, 1100), (256, 4, True, 2100, 2200),
                 (0, 3, False, 128, 200), (0, 2, True, 1000, 1100)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", COMPACT_CASES,
                         ids=lambda c: f"G{c[0]}-P{c[1]}"
                         f"{'-lab' if c[2] else ''}-W{c[3]}")
def test_compact_kernel_matches_plain_version(case):
    """The mask-and-compact kernels are bit-equal to their plain version
    over parent[:C], newcol[:C] and the offset: every comparison set,
    own given and not, empty candidate and predecessor rows, pairs all
    kept, totals past C, an offset that starts just below C, tiles of
    1-32 int32 per lane and capped grids."""
    _need_card("K1")
    group, P, label, width, L = case
    c = _rows_on_card(rows_case(40 + group + P, 333, P, width=width,
                                window=width + 40, L=L, label=label))
    for dirs in ((), (1,), (1, -1, 0), (0, 0)):
        for own in (True, False):
            T = _survivors(c, dirs, own)
            half = max(T // 2, 1)
            for C, off0 in ((T + 10, 0), (half, 3), (half, max(half - 4, 0))):
                for tpl, mb in ((32, 0), (1, 3), (2, 1)):
                    got, want = compact_both(
                        c, dirs, own, C=C, offset0=off0, group=group,
                        tile_per_lane=tpl, max_blocks=mb)
                    assert want[2] == off0 + T
                    assert _same(got, want), (dirs, own, C, off0, tpl, mb)


@pytest.mark.cuda
def test_compact_kernel_offsets_relaunch_and_counters():
    """An offset above 2^31 - C (every pair dropped, the offset still
    advanced by the total in int64), all rows empty, relaunches
    bit-equal, and the counters: `ops.launches["mask"]` one per call and
    each of the entry's three kernels one per call
    (`intersect.compact_launches`), none for B = 0."""
    from repro_torch.kernels import intersect

    _need_card("K1")
    c = _rows_on_card(rows_case(8, 200, 2, width=128, window=200, L=192))
    T = _survivors(c, (1, -1, 0))
    got, want = compact_both(c, (1, -1, 0), C=T, offset0=2**31 - T + 9)
    assert _same(got, want) and got[2] == 2**31 + 9
    first, _ = compact_both(c, (1, -1, 0), C=T // 2, offset0=1, group=8,
                            tile_per_lane=24)
    again, _ = compact_both(c, (1, -1, 0), C=T // 2, offset0=1, group=8,
                            tile_per_lane=24)
    assert _same(first, again)
    empty = dict(c, lens=torch.zeros_like(c["lens"]))
    got, want = compact_both(empty, (), C=50, offset0=7, group=32)
    assert _same(got, want) and got[2] == 7
    ops.reset_launches()
    for _ in range(3):
        got, want = compact_both(c, (0,), C=T + 1)
        assert _same(got, want)
    zero = {k: (v[..., :0].contiguous() if k in ("starts", "lens") else
                v[:0].contiguous() if k in ("cstart", "clen", "own", "extra")
                else v) for k, v in c.items()}
    got, want = compact_both(zero, (), C=4, offset0=2)
    assert got[2] == want[2] == 2
    assert ops.launches == {"mask": 3, "count": 0, "signed": 0,
                            "membership": 0, "intersect_count": 0,
                            "flash": 0}
    assert intersect.compact_launches == {"rows": 3, "scan": 3, "emit": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["offset_dtype", "offset_shape",
                                 "contiguity", "device", "own", "newcol"])
def test_compact_wrapper_refuses_bad_inputs_on_card(bad):
    _need_card("K1")
    c = _rows_on_card(rows_case(9, 40, 2, width=32, window=40, L=40))
    rows = torch.arange(40, dtype=torch.int32, device="cuda")
    offset = torch.zeros((), dtype=torch.int64, device="cuda")
    parent = torch.zeros(101, dtype=torch.int32, device="cuda")
    newcol = torch.zeros(101, dtype=torch.int32, device="cuda")
    if bad == "offset_dtype":
        offset = offset.to(torch.int32)
    elif bad == "offset_shape":
        offset = offset.reshape(1)
    elif bad == "contiguity":
        c["lens"] = torch.cat([c["lens"], c["lens"]], 1)[:, ::2]
    elif bad == "device":
        rows = rows.cpu()
    elif bad == "own":
        c["own"][7] = 2
    else:
        newcol = newcol[:-1]
    with pytest.raises((TypeError, ValueError)):
        ops.level_expand_compact(
            c["csrc"], c["cstart"], c["clen"], c["flat"], c["starts"],
            c["lens"], c["own"], c["extra"][:, :1].contiguous(), rows,
            offset, parent, newcol, dirs=(1,), width=32, window=40)
