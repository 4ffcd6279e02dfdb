"""Plain PyTorch versions of the port's kernels (the `ref.py` contract).

Counterpart of `repro/kernels/ref.py`.  These run wherever the tensors
lie and are what `kernels/ops.py` uses for CPU tensors; on the card
they are only the yardstick the CUDA kernels are held against
(`chip_smoke.py`: K1, K2 and K3 bit-equal, K4 within the reference's
tolerances).

The reference's oracle gathers each predecessor window and
broadcast-compares it with every candidate, an O(B·D·W) cube; at the
executor's shapes (B = 32768, D = W = 1917) that cube does not fit in
any memory, so membership here is a vectorized binary search over each
sorted CSR row instead.  On rows that are strictly increasing (the
contract both versions share) the two are the same function.
"""
from __future__ import annotations

import math

import torch


def membership_ref(cand: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """mask[b, d] = cand[b, d] ∈ nbr[b, :] — the O(B·D·L) broadcast
    compare of the reference's oracle; small sizes only (tests)."""
    return (cand[:, :, None] == nbr[:, None, :]).any(dim=-1)


def membership_ref_searchsorted(cand: torch.Tensor,
                                nbr: torch.Tensor) -> torch.Tensor:
    """mask[b, d] = cand[b, d] ∈ nbr[b, :] by a binary search of each
    candidate in its row (rows non-decreasing): O(B·D) memory.  The plain
    version of K2, which `ops.sorted_membership` runs for CPU tensors."""
    if nbr.shape[1] == 0:
        return torch.zeros(cand.shape, dtype=torch.bool, device=cand.device)
    idx = torch.searchsorted(nbr, cand)
    idx = idx.clamp(max=nbr.shape[1] - 1)
    return torch.gather(nbr, 1, idx) == cand


def intersect_count_ref(cand: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """The reference's `intersect_count_ref`, kept as it is: the int32
    [B, D] hit matrix (not a row count; see `intersect_count_plain`)."""
    return membership_ref(cand, nbr).to(torch.int32)


def intersect_count_plain(cand: torch.Tensor,
                          nbr: torch.Tensor) -> torch.Tensor:
    """cnt[b] = #{d : cand[b, d] ∈ nbr[b, :]} (int32; duplicate
    candidates count separately) — the plain version of K3."""
    return membership_ref_searchsorted(cand, nbr).sum(dim=1,
                                                      dtype=torch.int32)


def shared_slot(i):
    """K2/K3's shared-memory slot of tile entry i (int or int tensor):
    one pad word per 32 entries and one more per 1,024
    (`csrc/membership.cu`, `mb_slot`)."""
    return i + (i >> 5) + (i >> 10)


def pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def membership_padded_ref(cand: torch.Tensor, nbr: torch.Tensor,
                          nbr_len: torch.Tensor | None = None,
                          cand_valid: torch.Tensor | None = None, *,
                          tile: int, count: bool) -> torch.Tensor:
    """The padded K2/K3 kernel's algorithm walked in torch, for the CPU
    tests (no path calls it).  Per row b: n_b = clamp(nbr_len[b], 0, L)
    valid entries, cut into tiles of `tile` (an empty row is one empty
    tile); invalid candidates become -1.  Tile t of n entries lands at
    `shared_slot(i)` of a buffer whose slots of [n, top) hold INT32_MAX,
    top = pow2ceil(n); the search runs log2(top) steps of 2^k < top,
    probing the running slot plus shared_slot(2^k - 1) and advancing it
    by shared_slot(2^k) when the probe is below c, then reads the slot
    it reached.  Tile t decides the candidates it owns: c > the previous
    tile's last entry (unless t = 0) and c <= its own last entry (unless
    t is the row's last tile); every candidate is owned exactly once.
    Returns bool [B, D], or int32 [B] row counts with `count`."""
    cand = cand.to(torch.int32)
    nbr = nbr.to(torch.int32)
    B, D = cand.shape
    L = nbr.shape[1]
    if cand_valid is not None:
        cand = torch.where(cand_valid, cand, -1)
    if nbr_len is None:
        n_b = torch.full((B,), L, dtype=torch.int64)
    else:
        n_b = nbr_len.to(torch.int64).clamp(0, L)
    n_tiles = torch.where(n_b == 0, 1, (n_b + tile - 1) // tile)
    found = torch.zeros((B, D), dtype=torch.bool)
    owners = torch.zeros((B, D), dtype=torch.int64)
    prev_last = torch.zeros((B,), dtype=torch.int32)
    int_max = torch.iinfo(torch.int32).max
    for t in range(int(n_tiles.max()) if B else 0):
        live = t < n_tiles
        n = (n_b - t * tile).clamp(0, tile)
        top = torch.tensor([pow2ceil(max(int(v), 1)) for v in n])
        # slots past a row's top hold what an earlier item left there:
        # INT32_MIN, which would derail any search that read it
        buf = torch.full((B, shared_slot(int(top.max()))),
                         torch.iinfo(torch.int32).min, dtype=torch.int32)
        rows = torch.arange(B)[:, None]
        i = torch.arange(int(top.max()))[None, :]
        put = i < top[:, None]
        buf[rows.expand_as(put)[put], shared_slot(i).expand_as(put)[put]] = \
            int_max
        src = (t * tile + i).clamp(max=max(L - 1, 0))
        put = i < n[:, None]
        buf[rows.expand_as(put)[put], shared_slot(i).expand_as(put)[put]] = \
            nbr[rows.expand_as(put), src.expand_as(put)][put]
        p = torch.zeros((B, D), dtype=torch.int64)
        for k in reversed(range(int(top.max()).bit_length())):
            step = 1 << k
            active = (2 * step <= top)[:, None]
            v = torch.gather(buf, 1, p + shared_slot(step - 1))
            p = p + torch.where(active & (v < cand), shared_slot(step), 0)
        hit = torch.gather(buf, 1, p) == cand
        last = torch.where(n > 0, torch.gather(
            buf, 1, shared_slot((n - 1).clamp(min=0))[:, None])[:, 0], 0)
        own = live[:, None] \
            & ((t == 0) | (cand > prev_last[:, None])) \
            & ((t == n_tiles - 1)[:, None] | (cand <= last[:, None]))
        found |= own & hit
        owners += own
        prev_last = torch.where(live, last, prev_last)
    if not bool((owners == 1).all()):
        raise AssertionError("a candidate owned by no tile or by several")
    return found.sum(dim=1, dtype=torch.int32) if count else found


def bs_iters(window: int) -> int:
    """Binary-search steps that settle any segment of length ≤ window."""
    return max(1, math.ceil(math.log2(max(window, 2))) + 1)


def segment_member(flat: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   target: torch.Tensor, iters: int) -> torch.Tensor:
    """Vectorized binary search: is `target` in sorted flat[lo:hi)?

    lo/hi/target broadcast together; `iters` must be
    ≥ ceil(log2(max segment length)) + 1.  An active probe lies inside
    [lo, hi) ⊂ [0, len(flat)); settled lanes (lo == hi, possibly at
    len(flat)) and the final read are clamped, so no index ever leaves
    `flat` — JAX clamps silently, CUDA torch would assert."""
    lo, hi, target = torch.broadcast_tensors(lo, hi, target)
    hi0 = hi
    last = flat.shape[0] - 1
    for _ in range(iters):
        mid = (lo + hi) // 2
        val = flat[mid.clamp(max=last)]
        active = lo < hi
        go_right = active & (val < target)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return (lo < hi0) & (flat[lo.clamp(max=last)] == target)


def level_expand_ref(
    cand: torch.Tensor,                      # [B, D] int32
    flat: torch.Tensor,                      # [F] int32 flat CSR indices
    starts: torch.Tensor,                    # [P, B] int32 row offsets
    lens: torch.Tensor,                      # [P, B] int32 row lengths
    extra: torch.Tensor | None = None,       # [B, E] int32
    cand_valid: torch.Tensor | None = None,  # [B, D] bool
    *,
    dirs: tuple = (),
    count: bool = False,
    neg_from: int | None = None,
    window: int,
) -> torch.Tensor:
    """Plain version of the fused level-expansion kernel
    (kernels/csrc/level_expand.cu): membership of each candidate in the
    first min(lens[p, b], window) entries of every predecessor row, the
    restriction / injectivity comparisons against `extra` (dirs[e] ∈
    {+1: >, -1: <, 0: !=}), then the mask — or, with `count=True`, its
    int32 row sum where columns ≥ `neg_from` count −1."""
    mask = (torch.ones(cand.shape, dtype=torch.bool, device=cand.device)
            if cand_valid is None else cand_valid.clone())
    iters = bs_iters(window)
    for p in range(starts.shape[0]):
        lo = starts[p][:, None]
        hi = lo + lens[p].clamp(max=window)[:, None]
        mask &= segment_member(flat, lo, hi, cand, iters)
    for e, d in enumerate(dirs):
        ev = extra[:, e][:, None]
        if d > 0:
            mask &= cand > ev
        elif d < 0:
            mask &= cand < ev
        else:
            mask &= cand != ev
    if not count:
        return mask
    if neg_from is not None:
        col = torch.arange(cand.shape[1], device=cand.device)
        w = torch.where(col < neg_from, 1, -1).to(torch.int32)
        return (mask.to(torch.int32) * w[None, :]).sum(
            dim=1, dtype=torch.int32)
    return mask.sum(dim=1, dtype=torch.int32)


def gather_window(src: torch.Tensor, start: torch.Tensor,
                  length: torch.Tensor, width: int):
    """Each row's candidate window, as the executor gathers it:
    cand[b, d] = src[start[b] + d] for d < width, indices clamped to the
    array's end, and ok[b, d] = d < length[b]."""
    cols = torch.arange(width, dtype=torch.int32, device=src.device)
    idx = (start[:, None] + cols[None, :]).clamp_(max=src.shape[0] - 1)
    return src[idx], cols[None, :] < length[:, None]


def level_expand_rows_ref(
    csrc: torch.Tensor,                      # [F'] int32 candidate rows
    cstart: torch.Tensor,                    # [B] int32 row offsets
    clen: torch.Tensor,                      # [B] int32 row lengths
    flat: torch.Tensor,                      # [F] int32 flat CSR indices
    starts: torch.Tensor,                    # [P, B] int32
    lens: torch.Tensor,                      # [P, B] int32
    own: torch.Tensor | None = None,         # [B] int32
    extra: torch.Tensor | None = None,       # [B, E] int32
    neg: torch.Tensor | None = None,         # [B, Q] int32
    *,
    dirs: tuple = (),
    width: int,
    window: int,
) -> torch.Tensor:
    """Plain version of K1's row-sourced count and signed mode
    (`level_rows_kernel`, kernels/csrc/level_expand.cu): the candidate
    window gathered at `width`, the prefix columns `neg` appended in
    signed mode, then `level_expand_ref` in count mode with neg_from =
    width.  `own` is the caller's promise that row own[b] holds every
    candidate; this version searches that row all the same."""
    cand, ok = gather_window(csrc, cstart, clen, width)
    neg_from = None
    if neg is not None:
        cand = torch.cat([cand, neg], dim=1)
        ok = torch.cat([ok, torch.ones(neg.shape, dtype=torch.bool,
                                       device=ok.device)], dim=1)
        neg_from = width
    return level_expand_ref(cand, flat, starts, lens, extra, ok, dirs=dirs,
                            count=True, neg_from=neg_from, window=window)


def compact_pairs(mask: torch.Tensor, cand: torch.Tensor,
                  rows: torch.Tensor, offset: torch.Tensor,
                  parent: torch.Tensor, newcol: torch.Tensor) -> None:
    """The executor's stream compaction (the reference's
    `repro/core/executor.py:390-398`), in place: the pairs (rows[b],
    cand[b, d]) with mask[b, d], in (row, column) order, go to `parent` /
    `newcol` (int32 [C + 1]) at offset, offset + 1, ...; positions at or
    past C land in the sentinel slot C, whose content is free; `offset`
    (an int64 0-d tensor) advances by the total, dropped pairs
    included."""
    C = parent.shape[0] - 1
    flat_mask = mask.reshape(-1)
    if flat_mask.numel() == 0:
        return
    pos = torch.cumsum(flat_mask, 0, dtype=torch.int64) - 1
    out_idx = torch.where(flat_mask, (offset + pos).clamp(max=C), C)
    parent[out_idx] = rows[:, None].expand(mask.shape).reshape(-1)
    newcol[out_idx] = cand.reshape(-1)
    offset += pos[-1] + 1


def level_expand_compact_ref(
    csrc: torch.Tensor,                      # [F'] int32 candidate rows
    cstart: torch.Tensor,                    # [B] int32 row offsets
    clen: torch.Tensor,                      # [B] int32 row lengths
    flat: torch.Tensor,                      # [F] int32 flat CSR indices
    starts: torch.Tensor,                    # [P, B] int32
    lens: torch.Tensor,                      # [P, B] int32
    own: torch.Tensor | None,                # [B] int32
    extra: torch.Tensor | None,              # [B, E] int32
    rows: torch.Tensor,                      # [B] int32 frontier rows
    offset: torch.Tensor,                    # 0-d int64, advanced
    parent: torch.Tensor,                    # [C + 1] int32, written
    newcol: torch.Tensor,                    # [C + 1] int32, written
    *,
    dirs: tuple = (),
    width: int,
    window: int,
) -> None:
    """Plain version of K1's mask-and-compact entry
    (`level_compact_launch`, kernels/csrc/level_expand.cu): exactly the
    composition it replaced on the executor's mask levels — the
    candidate window gathered at `width`, `level_expand_ref` in mask
    mode, then `compact_pairs`.  `own` is the caller's promise that row
    own[b] holds every candidate; this version searches that row all the
    same."""
    cand, ok = gather_window(csrc, cstart, clen, width)
    mask = level_expand_ref(cand, flat, starts, lens, extra, ok, dirs=dirs,
                            window=window)
    compact_pairs(mask, cand, rows, offset, parent, newcol)


# ------------------------------------------------------------ attention ---
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: float | None = None) -> torch.Tensor:
    """Plain version of the flash kernel (kernels/csrc/flash_attention.cu):
    softmax attention in fp32, output in q's dtype.

    q [BH, Sq, hd]; k/v [BK, Sk, hd] with BH % BK == 0 (GQA groups:
    query row i reads K/V row i // (BH // BK))."""
    BH, Sq, hd = q.shape
    g = BH // k.shape[0]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    s = torch.einsum("bqh,bkh->bqk", q.float(), kf) * sm_scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(qi < ki, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", w, vf).to(q.dtype)


LOG2E = 1.4426950408889634
NEG_INF = -1e30


def flash_attention_tiled_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              sm_scale: float | None = None,
                              block_q: int = 128,
                              block_kv: int = 128) -> torch.Tensor:
    """Tile-by-tile emulation of the arithmetic of K4's wgmma kernel
    (kernels/csrc/flash_attention.cu, `wgmma::flash_fwd`), for tests
    only; never on the serving path.

    Query tiles of `block_q` rows walk key tiles of `block_kv` keys, in
    fp32: scores q.k scaled by sm_scale·log2(e), masked (causal: key >
    query) to the finite NEG_INF, an online softmax in exp2 (running
    max m, sum l, accumulator rescaled by exp2(m_old - m_new)), and P
    rounded to bf16 before P.V, as the kernel feeds P to the tensor
    cores; key tiles wholly above the causal diagonal are skipped; o =
    acc / max(l, 1e-30) in q's dtype.  Same layout and GQA rule as
    `flash_attention_ref`.  The kernel's sums run in another order, so
    the two agree to rounding, not bit for bit."""
    BH, Sq, hd = q.shape
    BK, Sk, _ = k.shape
    g = BH // BK
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    # the kernel's host code forms the factor in fp32
    c = float(torch.tensor(sm_scale, dtype=torch.float32)
              * torch.tensor(LOG2E, dtype=torch.float32))
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    out = torch.empty_like(q)
    n_kv = -(-Sk // block_kv)
    for q0 in range(0, Sq, block_q):
        qt = qf[:, q0:q0 + block_q]
        rows = qt.shape[1]
        m = torch.full((BH, rows), NEG_INF, device=q.device)
        l = torch.zeros((BH, rows), device=q.device)
        acc = torch.zeros((BH, rows, hd), device=q.device)
        n_kt = n_kv
        if causal:
            n_kt = min(n_kt, (q0 + block_q - 1) // block_kv + 1)
        qi = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        for k0 in range(0, n_kt * block_kv, block_kv):
            kt, vt = kf[:, k0:k0 + block_kv], vf[:, k0:k0 + block_kv]
            s = torch.einsum("bqh,bkh->bqk", qt, kt) * c
            if causal:
                ki = torch.arange(k0, k0 + kt.shape[1],
                                  device=q.device)[None, :]
                s = s.masked_fill(ki > qi, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqk,bkh->bqh", p.bfloat16().float(), vt)
            m = m_new
        out[:, q0:q0 + rows] = (acc / l.clamp(min=1e-30)[..., None]
                                ).to(q.dtype)
    return out
