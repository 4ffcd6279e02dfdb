#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero without them, and when
run outside a checkout of this repository.  Phases, one line each:

 1. the card's name and power limit (`nvidia-smi`), then K1
    (`src/repro_torch/kernels/csrc/level_expand.cu`), K2/K3
    (`csrc/membership.cu`) and K4 (`csrc/flash_attention.cu` with
    `csrc/hopper.cuh`) built with nvcc for sm_90a from the checkout's
    sources, one nvcc per source, started together; each build's
    seconds and each kernel's ptxas registers and spills (K4's wgmma
    kernel and the padded K2/K3 kernel must not spill);
 2. K1's gathered-window entry against its plain PyTorch version on
    the card, bit-equal, on windows of the wiki-vote-syn CSR at main-path
    shapes (B = 32768, D ∈ {128, 1024, 1917}, P ∈ {1, 2, 3}) in mask,
    count and signed mode;
    then K1's row-sourced entry (`ops.level_expand_rows`, count and
    signed mode, the candidates read from their CSR row in the kernel)
    against its plain version, bit-equal, on rows of the same CSR at the
    same shapes, with and without `own` and the comparisons; then K1's
    mask-and-compact entry (`ops.level_expand_compact`: mask mode with
    the level's stream compaction in the kernels) against its plain
    version, bit-equal over parent[:C], newcol[:C] and the offset, at
    P = 1–4, CSR and labeled, offsets near C and past 2^31 - C, every
    group size, a relaunch (`phase2_compact`);
 3. `repro_torch.launch.mine` on tiny-er for P1–P6, enum and --use-iep
    (plus the graphzero IEP plans of P1 and P4, which fold a tail);
    counts held to the reference oracle's values;
 4. full size, wiki-vote-syn (8,192 vertices, 79,597 edges): the
    triangle count on both paths; P1 on the kernel path under the
    graphpi plan, the graphzero plan with and without its IEP tail and
    the naive plan (÷ |Aut|); both paths on the roots v0 ∈ [96, 112),
    and that slice on the kernel path under torch.profiler with the
    graphpi and the graphzero IEP plans (device kernel time against
    unprofiled wall, K1's time per kernel, top kernels; the
    gathered-window kernel must not run there), then under the graphpi
    plan with the mask levels run by the composition the
    mask-and-compact entry replaced and by the entry, alternated, in
    one process (`k1_mask_walls`).  Then small-rmat: P1 under
    the graphpi, graphzero and naive plans, enum and IEP, on both paths;
 5. K1's launches in the named main-path runs: mask and count in the
    wiki-vote-syn P1 graphpi count, signed in the graphzero IEP count;
 6. K1's time per launch on the largest real main-path launch of each
    mode (mask mode also on the largest of each bucket width), beside
    its plain version's and the card's bound, and the composition it
    replaced, all bit-equal on the same rows: for mask mode the window
    gather, the gathered-window kernel and the compaction, each also
    timed alone; for count and signed mode the gathered window, the
    prefix columns concatenated and the gathered-window kernel.  Then
    the largest launch of each mode and bucket width at every group
    size (`group_sweep`, `compact_sweep`; `k1_rows_sweep` runs them on
    the root slice's launches alone).

 7. K4 against its plain PyTorch version on the card: the reference
    test's shapes, causal and bidirectional, bf16 and fp32, within the
    reference's tolerances (3e-2 / 2e-5), then in bf16 the qwen3-1.7b
    serving shape (q [64, 2048, 128] over k/v [32, 2048, 128], causal),
    48 query heads over one KV head at S = 1,024, a ragged
    (6, 3, 1000, 777, 128) and a bidirectional (8, 8, 2048, 2048, 64);
    each case launches the kernel the source's rule names (bf16: wgmma,
    fp32: scalar) and each bf16 case twice, bit-equal;
 8. qwen3-1.7b at full width and depth (random weights from seed 0)
    through `repro_torch.launch.serve.main`: batch 4, a 2,048-token
    prompt, 16 generated tokens; then a second session with the same
    seed that evicts slot 2 after 4 steps and admits a new sequence
    (its undisturbed rows must equal the served run's tokens); then
    the kernel-path prefill's logits against the plain-attention
    path's on the same weights and prompts (limits PREFILL_MAX_ABS and
    PREFILL_MEAN_ABS below, with their reasons), every K4 launch of the
    wgmma kernel; and a torch.profiler
    window over one batch prefill and 4 decode steps (device kernel
    time against unprofiled wall time, top kernels);
 9. K4's time per launch at the serving shape, in one process on the
    same tensors: the wgmma kernel, the scalar kernel it replaced (bf16),
    the plain version and PyTorch's `scaled_dot_product_attention` (the
    library yardstick; the port never calls it), with TFLOP/s and the
    share of the card's bound.

10. K2 and K3 (`csrc/membership.cu`: the padded kernel behind
    `ops.sorted_membership` / `ops.intersect_count`, which reads the
    ragged contract itself) against their plain PyTorch versions and
    against the first version (`membership_linear_cuda`) on the card,
    bit-equal: the reference test's shapes in int32 and int16, rows
    longer than one shared tile, rows of 1,000 / 1,024 / 4,096 entries,
    D and L off multiples of 4, ragged `cand_valid` / `nbr_len` (empty
    rows; nbr_len past L, negative, int64, all zero), -1 in the rows,
    pointers 4 bytes off a 16-byte boundary, shared-tile widths, forced
    warp / block groups and block sizes that must not change the result,
    duplicate candidates;
11. K2's and K3's time per launch at the reference benchmark's shapes,
    at B = 65,536, D = 1,024 and L = 1,000 / 1,024 / 4,000 / 4,096: the
    padded kernel, the first version, the plain version and the card's
    bound on the same tensors (the small shapes also by torch.profiler's
    device time); first the first version alone at the last four shapes
    and `cand.clone()` + `nbr.clone()` as a yardstick
    (`membership_step0`); at 65,536 x 1,024 x 1,024 also each group size
    forced, and ragged rows through `ops` beside the first version
    behind the wrapper's former padded copies;
12. the per-predecessor composition of `benchmarks/kernel_intersect.py`
    (a gathered window and one K2 launch per predecessor, K3 for the
    last one in count mode) against the fused K1, bit-equal, both timed;
    every K2/K3 launch there is the padded kernel
    (`membership.kernel_launches`);
13. the query engine on small-rmat: duplicate P1 tickets coalesced into
    one execution, an isomorphic re-query served from the cache, a count
    preempted after every dispatch equal to the uninterrupted one.
14. the graph serving front door, through the launchers a user runs:
    `repro_torch.launch.gateway` (graph tenant only) on wiki-vote-syn
    with a plan store in a temporary directory — P1, an isomorphic P1
    (coalesced with it, `--graph-quantum 2`) and the triangle, counts
    held to WIKI_P1 and WIKI_TRIANGLES — cold, then restarted on the
    same store by load-through (no search, persist hits) and with
    `--warm-from-disk` (no search, preloads, no miss), each query's
    latency and each count's dispatches printed; `launch.plan_warmup`
    for P1-P6 on tiny-er, run twice (the rerun searches nothing); a live
    engine on wiki-vote-syn: two epochs of 256 seeded inserts and 256
    deletes, then a compaction, the triangles counted after each and P1
    after the last, each count equal to a from-scratch count of the
    rebuilt CSR, every epoch swap a `Matcher.rebind`, no re-search; an
    RPC server process (`--live --listen 0 --port-file`) on small-rmat
    and two client processes, one after the other (two tenants), whose
    trace holds one mutate line, the counts equal to a direct engine's
    over the same epochs, the round trip timed, the server ending on
    `shutdown` with exit code 0; and graph + LM through
    `launch.gateway --full-lm` (qwen3-1.7b, batch 2, a 512-token
    prompt, 8 steps beside small-rmat P1/P2), its greedy tokens equal to
    `launch.serve`'s with the same seed, 28 wgmma launches of K4 in the
    prefill, the solo and contended turn times printed.

Every count of phases 3–4 sets K1's launch counters to 0 just before it
and reads them just after; a kernel-path count must launch exactly the
modes its plan needs, a portable-path count none, and each mask launch
must be one launch of each mask-and-compact kernel
(`intersect.compact_launches`).  In phase 8 K4's
counter is set to 0 just before each batch prefill, admission and
decode call and read just after: n_layers (28) launches per prefill
and per admission, all of the wgmma kernel, none in decode.
In phase 12 K2's and K3's counters are set to 0 just before the
composed runs and read just after; in phase 13 K1's, around each round
of the engine, must show exactly the plan's modes; in phase 14 K1's,
around each gateway run and each live count, must show exactly the
modes of the plans run (none for a memoized count), and K4's, around
each prefill and decode call, 28 per prefill and none in decode.

Counts are integers and every comparison of phases 2–6 and 10–14 is
exact (no tolerance).  The last two lines are the kernels record (K1's
three modes and its gathered-window entry, K2 and K3 with the first
version's time as `linear_ms`, K4 with its kernel `variant` and
`tflops`; `front_door_launches`: K1's launches per mode in phase 14's
cold serve and K4's per prefill of its graph + LM run) and the device
record (JSON).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Reference counts on tiny-er (256 vertices, 1,991 edges), from the JAX
# package's brute-force oracle (repro.core.oracle.count_embeddings_oracle).
TINY_ER_ORACLE = {"P1": 27_358, "P2": 87_724, "P3": 1_112_189,
                  "P4": 4_225, "P5": 281}
# wiki-vote-syn triangle count, the JAX package's executor on the CPU.
WIKI_TRIANGLES = 705_626
# P1 (house) on wiki-vote-syn: first counted by this port on an H100
# (chip_smoke.py: the kernel and portable paths of the graphpi plan and
# the kernel path of the graphzero IEP plan agreed); no reference count
# exists at this size.
WIKI_P1 = 28_141_992_173
WIKI_CAPACITY = 1 << 20
WIKI_ROOTS = (96, 112)            # ~2.5% of P1's frontier rows
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM float32 outside the tensor cores (data sheet): K1's integer
# compares run on the same cores, whose int32 rate is no higher, so
# operations over this rate are still a least time.
CORE_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"[smoke] FAIL: {msg}")


# ------------------------------------------------------------ phase 2 --
def kernel_cases(arrays, rng, B, D, P):
    """Windows of a real CSR at one main-path shape: candidates are the
    D-wide window of a degree-biased base vertex (padding columns
    invalid, 10% more dropped), predecessors are the base and its random
    neighbours, 5% of the predecessor rows are emptied and 5% of the
    candidate rows are all CAND_PAD."""
    import numpy as np
    import torch

    from repro_torch.kernels.ops import CAND_PAD

    dev = arrays.flat.device
    indptr = arrays.indptr.cpu().numpy()
    deg = arrays.degrees.cpu().numpy()
    nnz = int(indptr[-1])
    flat_h = arrays.flat.cpu().numpy()
    base = flat_h[rng.integers(0, nnz, B)]
    pos = indptr[base][:, None] + np.arange(D)[None, :]
    cand = flat_h[np.minimum(pos, len(flat_h) - 1)]
    valid = (np.arange(D)[None, :] < deg[base][:, None]) \
        & (rng.random((B, D)) < 0.9)
    cand[rng.random(B) < 0.05] = CAND_PAD
    us = [base]
    for _ in range(P - 1):
        pick = indptr[base] + (rng.random(B) * np.maximum(deg[base], 1)
                               ).astype(np.int64)
        us.append(np.where(deg[base] > 0, flat_h[pick], base))
    us = np.stack(us)
    starts = indptr[us].astype(np.int32)
    lens = deg[us].astype(np.int32)
    lens[rng.random((P, B)) < 0.05] = 0
    extra = flat_h[rng.integers(0, nnz, (B, 3))]

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return (t(cand), t(starts), t(lens), t(extra),
            t(valid, torch.bool))


def phase2(arrays, W, errs):
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import level_expand_ref

    rng = np.random.default_rng(20260)
    n_cases = 0
    for D in (128, 1024, 1917):
        for P in (1, 2, 3):
            cand, starts, lens, extra, valid = kernel_cases(
                arrays, rng, 32768, D, P)
            modes = [
                dict(dirs=(1, -1, 0), extra=extra, count=False),
                dict(dirs=(1, -1, 0), extra=extra, count=True),
                dict(dirs=(), extra=None, count=True, neg_from=D // 2),
                dict(dirs=(), extra=None, count=True, neg_from=D),
                dict(dirs=(), extra=None, count=True, neg_from=0),
            ]
            for kw in modes:
                args = (cand, arrays.flat, starts, lens, kw["extra"], valid)
                opts = dict(dirs=kw["dirs"], count=kw["count"],
                            neg_from=kw.get("neg_from"), window=W)
                got = ops.level_expand(*args, **opts)
                want = level_expand_ref(*args, **opts)
                torch.cuda.synchronize()
                err = (got.to(torch.int64) - want.to(torch.int64)).abs()
                errs.append(float(err.max()) if err.numel() else 0.0)
                check(torch.equal(got, want),
                      f"K1 != plain at B=32768 D={D} P={P} {opts}")
                n_cases += 1
    return n_cases


def rows_cases(arrays, rng, B, D, P, label=False):
    """Rows of a real CSR for the row-sourced entries at one main-path
    shape: each frontier row's candidates are the CSR row of a
    degree-biased base vertex (bucket width D), its predecessors the base
    (own = 0) and random neighbours of it; 5% of the predecessor rows
    are emptied (an emptied base row empties the candidate row too),
    three prefix values for comparisons and four prefix columns (the
    base, a neighbour, a random vertex, the neighbour again).  `label`:
    the candidates are a random 60% of the base's row, in an array of
    their own (`csrc`), as a labeled position's per-label rows are."""
    import numpy as np
    import torch

    dev = arrays.flat.device
    indptr = arrays.indptr.cpu().numpy()
    deg = arrays.degrees.cpu().numpy()
    nnz = int(indptr[-1])
    flat_h = arrays.flat.cpu().numpy()
    base = flat_h[rng.integers(0, nnz, B)]
    us = [base]
    for _ in range(P - 1):
        pick = indptr[base] + (rng.random(B) * np.maximum(deg[base], 1)
                               ).astype(np.int64)
        us.append(np.where(deg[base] > 0, flat_h[pick], base))
    us = np.stack(us)
    starts = indptr[us].astype(np.int32)
    lens = deg[us].astype(np.int32)
    lens[rng.random((P, B)) < 0.05] = 0
    extra = flat_h[rng.integers(0, nnz, (B, 3))]
    neg = np.stack([base, us[-1], rng.integers(0, len(deg) - 1, B),
                    us[-1]], axis=1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=dev)

    out = dict(csrc=arrays.flat, cstart=t(starts[0]), clen=t(lens[0]),
               starts=t(starts), lens=t(lens), own=t(np.zeros(B)),
               extra=t(extra), neg=t(neg))
    if label:
        n = lens[0].astype(np.int64)
        pos = np.repeat(starts[0].astype(np.int64) - np.cumsum(n) + n, n) \
            + np.arange(int(n.sum()))
        keep = rng.random(pos.shape[0]) < 0.6
        kept = np.bincount(np.repeat(np.arange(B), n)[keep], minlength=B)
        out.update(csrc=t(flat_h[pos[keep]]),
                   cstart=t(np.cumsum(kept) - kept), clen=t(kept))
    return out


def phase2_rows(arrays, W, errs):
    """The row-sourced entry (count and signed mode) against its plain
    version, bit-equal, at the main-path shapes: with and without `own`,
    with and without the comparisons (>, <, !=)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import level_expand_rows_ref

    rng = np.random.default_rng(20261)
    n_cases = 0
    for D in (128, 1024, 1917):
        for P in (1, 2, 3):
            c = rows_cases(arrays, rng, 32768, D, P)
            for dirs in ((), (1, -1, 0)):
                for signed in (False, True):
                    for own in (c["own"], None):
                        args = (c["csrc"], c["cstart"], c["clen"],
                                arrays.flat, c["starts"], c["lens"], own,
                                c["extra"] if dirs else None,
                                c["neg"] if signed else None)
                        kw = dict(dirs=dirs, width=D, window=W)
                        got = ops.level_expand_rows(*args, **kw)
                        want = level_expand_rows_ref(*args, **kw)
                        torch.cuda.synchronize()
                        errs.append(float((got.to(torch.int64) - want.to(
                            torch.int64)).abs().max()))
                        check(torch.equal(got, want),
                              f"K1 rows != plain at B=32768 D={D} P={P} "
                              f"dirs={dirs} signed={signed} "
                              f"own={own is not None}")
                        n_cases += 1
    return n_cases


def compact_run(c, flat, own, dirs, W, width, C, offset0, **launch):
    """One call of the mask-and-compact entry on case `c` and of its
    plain version, each into its own `parent` / `newcol` [C + 1] (both
    filled with -7) behind an int64 offset of `offset0`; `launch` given =
    the CUDA launcher with those launch shapes, else the public wrapper.
    Returns ((parent[:C], newcol[:C], offset) of the kernel, the same of
    the plain version)."""
    import torch

    from repro_torch.kernels import intersect, ops
    from repro_torch.kernels.ref import level_expand_compact_ref

    dev = flat.device
    B = c["cstart"].numel()
    rows = torch.arange(B, dtype=torch.int32, device=dev) * 3 + 1
    out = []
    for fn in ("kernel", "plain"):
        parent = torch.full((C + 1,), -7, dtype=torch.int32, device=dev)
        newcol = torch.full((C + 1,), -7, dtype=torch.int32, device=dev)
        offset = torch.tensor(offset0, dtype=torch.int64, device=dev)
        args = (c["csrc"], c["cstart"], c["clen"], flat, c["starts"],
                c["lens"], own, c["extra"][:, :len(dirs)].contiguous()
                if dirs else None, rows, offset, parent, newcol)
        kw = dict(dirs=dirs, width=width, window=W)
        if fn == "plain":
            level_expand_compact_ref(*args, **kw)
        elif launch:
            intersect.level_compact_cuda(*args, **kw, **launch)
        else:
            ops.level_expand_compact(*args, **kw)
        out.append((parent[:C], newcol[:C], int(offset)))
    torch.cuda.synchronize()
    return out


def phase2_compact(arrays, W, errs):
    """K1's mask-and-compact entry against its plain version, bit-equal
    over parent[:C], newcol[:C] and the offset, on rows of the
    wiki-vote-syn CSR at the main-path widths: P = 1-4, CSR and labeled
    candidate rows, own given or not, the comparisons (>, <, !=) or
    none, empty rows (5% of the predecessor rows emptied), and four
    (capacity, starting offset) settings from the launch's total T (all
    kept; totals past C; an offset that starts 50 below C; an offset
    above 2^31 - C, every pair dropped); then every group size with
    small tiles and capped grids, and a relaunch, bit-equal."""
    import numpy as np
    import torch

    from repro_torch.kernels import intersect

    rng = np.random.default_rng(20262)
    n_cases = 0
    variants = [(True, (1, -1, 0), False), (False, (), False),
                (True, (0,), True), (False, (1, -1, 0), True)]
    for D in (128, 1024, 1917):
        for P in (1, 2, 3, 4):
            cs = {lab: rows_cases(arrays, rng, 16384, D, P, label=lab)
                  for lab in (False, True)}
            for i, (own, dirs, lab) in enumerate(variants):
                c = cs[lab]
                o = c["own"] if own else None
                ex = c["extra"][:, :len(dirs)].contiguous() if dirs else None
                T = int(intersect.level_rows_cuda(
                    c["csrc"], c["cstart"], c["clen"], arrays.flat,
                    c["starts"], c["lens"], o, ex, None, dirs=dirs,
                    width=D, window=W).sum())
                half = max(T // 2, 1)
                C, off0 = [(T + 100, 0), (half, 0), (half, max(half - 50, 0)),
                           (max(T, 1), 2**31 - max(T, 1) + 5)][(i + P) % 4]
                got, want = compact_run(c, arrays.flat, o, dirs, W, D, C,
                                        off0)
                check(got[2] == want[2] == off0 + T,
                      f"K1 compact offset {got[2]} plain {want[2]}, want "
                      f"{off0 + T} at D={D} P={P} {(own, dirs, lab)}")
                for g, w in zip(got[:2], want[:2]):
                    errs.append(float((g.to(torch.int64) - w.to(
                        torch.int64)).abs().max()))
                    check(bool((g == w).all()),
                          f"K1 compact != plain at B=16384 D={D} P={P} "
                          f"own={own} dirs={dirs} label={lab} C={C} "
                          f"offset={off0}")
                n_cases += 1
    # every group size, forced, with small tiles and capped grids; then a
    # relaunch through the wrapper, bit-equal to the first launch
    for D, P in ((128, 3), (1024, 2), (1917, 4)):
        c = rows_cases(arrays, rng, 4096, D, P, label=D == 1024)
        for g in (8, 32, 256):
            for tpl, mb in ((32, 0), (1, 3), (4, 1)):
                got, want = compact_run(c, arrays.flat, c["own"], (1, -1, 0),
                                        W, D, 1 << 20, 11, group=g,
                                        tile_per_lane=tpl, max_blocks=mb)
                check(all(bool((a == b).all()) for a, b in
                          zip(got[:2], want[:2])) and got[2] == want[2],
                      f"K1 compact G={g} tile={tpl} blocks={mb} != plain "
                      f"at D={D} P={P}")
                n_cases += 1
        first, _ = compact_run(c, arrays.flat, c["own"], (0,), W, D, 5000, 0)
        again, _ = compact_run(c, arrays.flat, c["own"], (0,), W, D, 5000, 0)
        check(all(bool((a == b).all()) for a, b in zip(first[:2], again[:2]))
              and first[2] == again[2], f"K1 compact relaunch differs at "
              f"D={D}")
    return n_cases


# ------------------------------------------------------- phases 3-5 --
def kernel_modes(plan) -> set:
    """K1 modes a count of `plan` launches on the kernel path, given live
    rows at every level: mask for an inner enumeration level with two or
    more predecessors, count for such a last enumeration level, signed
    for each IEP-tail cardinality.  The portable path launches none."""
    modes = set()
    for i in range(1, plan.depth):
        if len(plan.preds[i]) > 1:
            last = plan.iep is None and i == plan.n - 1
            modes.add("count" if last else "mask")
    if plan.iep is not None:
        modes.add("signed")
    return modes


def check_launches(what, launches, plan, use_kernel) -> None:
    want = kernel_modes(plan) if use_kernel else set()
    got = {k for k, n in launches.items() if n}
    check(got == want, f"{what}: K1 launches {launches}, but the plan "
          f"needs modes {sorted(want)}")


class LaunchRecorder:
    """Wraps `ops.level_expand_compact` (mask mode) and
    `ops.level_expand_rows` (count and signed mode) to keep, for each
    mode in `modes`, the arguments of the largest launch (by rows x
    width) of one count — the inputs phase 6 times — and of the largest
    launch of each bucket width (keyed (mode, width)).  Mask mode keeps
    every argument by name, `offset`, `parent` and `newcol` as they were
    before the call."""

    def __init__(self, ops, modes):
        import inspect

        self.ops = ops
        self.real = (ops.level_expand_compact, ops.level_expand_rows)
        self.sig = inspect.signature(ops.level_expand_compact)
        self.modes = modes
        self.best = {}

    def keep(self, key, size, args, kw):
        mode = key[0] if isinstance(key, tuple) else key
        if mode in self.modes and size > self.best.get(key, (0,))[0]:
            if isinstance(args, dict):
                keep = {k: a.clone() if hasattr(a, "clone") else a
                        for k, a in args.items()}
            else:
                keep = [a.clone() if hasattr(a, "clone") else a
                        for a in args]
            self.best[key] = (size, keep, dict(kw))

    def compact(self, *a, **kw):
        args = self.sig.bind(*a, **kw)
        args.apply_defaults()
        args = dict(args.arguments)
        args["dirs"] = tuple(args["dirs"])
        for key in ("mask", ("mask", args["width"])):
            self.keep(key, args["cstart"].numel() * args["width"], args, {})
        return self.real[0](*a, **kw)

    def rows(self, csrc, cstart, clen, flat, starts, lens, own=None,
             extra=None, neg=None, **kw):
        mode = "count" if neg is None else "signed"
        opts = dict(dirs=tuple(kw.get("dirs", ())), width=kw["width"],
                    window=kw["window"])
        for key in (mode, (mode, kw["width"])):      # largest, per bucket
            self.keep(key, cstart.numel() * kw["width"],
                      (csrc, cstart, clen, starts, lens, own, extra, neg),
                      opts)
        return self.real[1](csrc, cstart, clen, flat, starts, lens, own,
                            extra, neg, **kw)

    def __enter__(self):
        self.ops.level_expand_compact = self.compact
        self.ops.level_expand_rows = self.rows
        return self

    def __exit__(self, *exc):
        self.ops.level_expand_compact, self.ops.level_expand_rows = self.real
        return False


def count_on(what, graph, plan, cfg, arrays, *, aut_divisor=1, roots=None,
             during=contextlib.nullcontext()):
    """Warm a Matcher up, then time one count (inside `during`).  K1's
    launch counters are set to 0 just before the count and read just
    after, and must show exactly the modes the plan needs on this path.
    `roots` = (lo, hi) counts only the embeddings rooted at v0 in
    [lo, hi): one span of the chunked loop, through the same
    `count_partial` entry point."""
    import torch

    from repro_torch.core.executor import CountState, Matcher
    from repro_torch.kernels import ops

    m = Matcher(graph, plan, cfg, arrays=arrays, device="cuda")
    m.warmup()
    torch.cuda.synchronize()
    state = None if roots is None else CountState(
        spans=[(*roots, cfg.capacity)], chunk=cfg.capacity)
    with during:
        ops.reset_launches()
        t0 = time.perf_counter()
        state, res = m.count_partial(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
    check(res is not None and not res.overflowed, f"{what} overflowed")
    check_launches(what, launches, plan, cfg.use_kernel)
    check_compact(what, launches)
    return res.count // aut_divisor, wall, state.dispatches, res, launches


def check_compact(what, launches) -> None:
    """Every mask-mode launch of a count launched each of the
    mask-and-compact entry's three kernels once, as its launcher reports
    them launched (`intersect.compact_launches`, counted apart from the
    wrapper's `ops.launches["mask"]`)."""
    from repro_torch.kernels import intersect

    got = dict(intersect.compact_launches)
    check(got == dict.fromkeys(got, launches["mask"]),
          f"{what}: mask launches {launches['mask']}, mask-and-compact "
          f"kernels {got}")


def stats_on(what, graph, cfg, arrays):
    """`compute_stats` (the triangle count), timed, with K1's launch
    counters set to 0 just before it and read just after."""
    import torch

    from repro_torch.core.executor import compute_stats, triangle_plan
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    st = compute_stats(graph, cfg, device="cuda", arrays=arrays)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    check_launches(what, launches, triangle_plan(), cfg.use_kernel)
    return st, wall, launches


# ------------------------------------------------------------ phase 6 --
def time_ms(fn, iters=20):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_of(cand, starts, lens, extra, valid, count, window):
    """Least time for one launch: each input read once — cand, valid,
    starts/lens, extra, and each distinct predecessor row this launch
    searches (rows recur across frontier rows; they are counted once) —
    and each output written once, over HBM bandwidth; against the
    compares these inputs need (a full binary search of each valid
    candidate in each predecessor row, plus one compare per extra) over
    the cores' rate.  Returns (ms, "bytes" or "operations")."""
    import torch

    B, D = cand.shape
    P = starts.shape[0]
    key = (starts.to(torch.int64) << 32) | lens.clamp(max=window).to(
        torch.int64)
    rows = int((torch.unique(key) & 0xFFFFFFFF).sum())
    nbytes = (4 * B * D + (B * D if valid is not None else 0) + 4 * rows
              + 8 * P * B + (4 * extra.numel() if extra is not None else 0)
              + (4 * B if count else B * D))
    n_valid = (valid.sum(dim=1) if valid is not None
               else torch.full((B,), D, device=cand.device)).double()
    steps = torch.ceil(torch.log2(
        lens.clamp(min=0, max=window).double() + 1)).sum(dim=0)
    E = extra.shape[1] if extra is not None else 0
    compares = float((n_valid * (steps + E)).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = compares / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


ROW_ARGS = ("csrc", "cstart", "clen", "flat", "starts", "lens", "own",
            "extra", "rows")


def compact_composition(a, offset, parent, newcol):
    """What K1's mask-and-compact entry replaced on the main path, on
    its arguments `a` (by name): the window gathered at `width`
    (`ref.gather_window`), the gathered-window kernel in mask mode
    (`ops.level_expand`), then the executor's compaction
    (`ref.compact_pairs`)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import compact_pairs, gather_window

    cand, ok = gather_window(a["csrc"], a["cstart"], a["clen"], a["width"])
    mask = ops.level_expand(cand, a["flat"], a["starts"], a["lens"],
                            a["extra"], ok, dirs=a["dirs"],
                            window=a["window"])
    compact_pairs(mask, cand, a["rows"], offset, parent, newcol)


def composition_parts(a) -> dict:
    """The composition's three parts on recorded arguments `a`, each
    timed on its own (CUDA events, 3 warm-up calls, then 20): the window
    gather, the gathered-window kernel in mask mode, the compaction
    (its `offset` restored before each call, as in every timed call of
    this phase), and the three together."""
    from repro_torch.kernels import intersect
    from repro_torch.kernels.ref import compact_pairs, gather_window

    off0 = a["offset"]
    off, par, col = off0.clone(), a["parent"].clone(), a["newcol"].clone()
    src = (a["csrc"], a["cstart"], a["clen"], a["width"])
    cand, ok = gather_window(*src)
    win = (cand, a["flat"], a["starts"], a["lens"], a["extra"], ok)
    wkw = dict(dirs=a["dirs"], count=False, neg_from=None,
               window=a["window"])
    mask = intersect.level_expand_cuda(*win, **wkw)

    def compact():
        off.copy_(off0)
        compact_pairs(mask, cand, a["rows"], off, par, col)

    def whole():
        off.copy_(off0)
        compact_composition(a, off, par, col)

    return {"gather_ms": time_ms(lambda: gather_window(*src)),
            "window_ms": time_ms(lambda: intersect.level_expand_cuda(
                *win, **wkw)),
            "compact_ms": time_ms(compact),
            "composition_ms": time_ms(whole)}


def compact_outputs(fn, a):
    """(parent[:C], newcol[:C], offset) after `fn(offset, parent, newcol)`
    on fresh copies of the recorded buffers."""
    C = a["parent"].shape[0] - 1
    off, par, col = (a["offset"].clone(), a["parent"].clone(),
                     a["newcol"].clone())
    fn(off, par, col)
    return par[:C], col[:C], off


def all_written(a) -> dict:
    """Recorded mask-mode arguments `a` with the capacity raised so that
    every pair of the launch is written (fresh `parent` / `newcol` of
    offset + total + 1 entries, filled with -7): the launch does all of
    its work, where the recorded one may have dropped pairs past C."""
    import torch

    from repro_torch.kernels import intersect

    total = int(intersect.level_rows_cuda(
        *(a[k] for k in ROW_ARGS[:8]), None, dirs=a["dirs"],
        width=a["width"], window=a["window"]).sum(dtype=torch.int64))
    C = int(a["offset"]) + total
    return dict(a, parent=torch.full((C + 1,), -7, dtype=torch.int32,
                                     device=a["offset"].device),
                newcol=torch.full((C + 1,), -7, dtype=torch.int32,
                                  device=a["offset"].device))


def time_compact(best, window_record=False, full=False,
                 kernel_only=False) -> dict:
    """Phase 6, mask mode, on one recorded launch: K1's mask-and-compact
    entry, the composition it replaced and the plain version, bit-equal
    over parent[:C], newcol[:C] and the offset; then the entry, the
    composition (and each of its parts) and the plain version timed in
    one process on the same inputs, each call with the offset restored
    first.  `full`: at a capacity that holds every pair of the launch
    (`all_written`).  `kernel_only`: the entry against the plain
    version, and only the entry timed.  `window_record`: also the
    gathered-window kernel's record (mask mode on the same window)
    against its own plain version and bound."""
    import torch

    from repro_torch.kernels import intersect
    from repro_torch.kernels.ref import (gather_window,
                                         level_expand_compact_ref,
                                         level_expand_ref)

    _, a, _ = best
    if full:
        a = all_written(a)
    args = tuple(a[k] for k in ROW_ARGS)
    kw = dict(dirs=a["dirs"], width=a["width"], window=a["window"])
    runs = {
        "kernel": lambda o, p, n: intersect.level_compact_cuda(
            *args, o, p, n, **kw),
        "composition": lambda o, p, n: compact_composition(a, o, p, n),
        "plain": lambda o, p, n: level_expand_compact_ref(
            *args, o, p, n, **kw)}
    if kernel_only:
        del runs["composition"]
    outs = {k: compact_outputs(fn, a) for k, fn in runs.items()}
    torch.cuda.synchronize()
    for k in runs:
        check(all(torch.equal(x, y) for x, y in zip(outs[k], outs["plain"])),
              f"K1 mask: {k} != plain on the recorded launch")
    off0 = a["offset"]
    off, par, col = off0.clone(), a["parent"].clone(), a["newcol"].clone()

    def timed(fn):
        def call():
            off.copy_(off0)
            fn(off, par, col)
        return call

    ms = time_ms(timed(runs["kernel"]))
    total = int(outs["plain"][2]) - int(off0)
    C = a["parent"].shape[0] - 1
    written = max(min(total, C - int(off0)), 0)
    P, B = a["starts"].shape
    group = intersect.load().level_compact_group(a["width"])
    what = (f"B={B} width={a['width']} P={P} E={len(a['dirs'])} "
            f"group={group} pairs={total} written={written}")
    if kernel_only:
        return {"what": what, "ms": ms}
    parts = composition_parts(a)
    plain_ms = time_ms(timed(runs["plain"]), iters=5)
    bound_ms, bound_by = rows_bound_of(
        *args[:8], None, dirs=a["dirs"], width=a["width"],
        window=a["window"], written=written)
    rec = {"what": what, "ms": ms, **parts, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if window_record:
        cand, ok = gather_window(a["csrc"], a["cstart"], a["clen"],
                                 a["width"])
        win = (cand, a["flat"], a["starts"], a["lens"], a["extra"], ok)
        wkw = dict(dirs=a["dirs"], window=a["window"])
        want = level_expand_ref(*win, **wkw)
        got = intersect.level_expand_cuda(*win, **wkw, count=False,
                                          neg_from=None)
        torch.cuda.synchronize()
        check(torch.equal(got, want), "K1 window != plain on recorded mask")
        w_bound, w_by = bound_of(cand, a["starts"], a["lens"], a["extra"],
                                 ok, False, a["window"])
        rec["window"] = {
            "ms": parts["window_ms"],
            "plain_ms": time_ms(lambda: level_expand_ref(*win, **wkw),
                                iters=5),
            "bound_ms": w_bound, "bound_by": w_by}
    return rec


def compact_sweep(best, card, tiles=None) -> None:
    """The largest recorded mask launch of each bucket width, as it ran
    (its capacity and offset: a dispatch that overflowed writes only the
    pairs below C) and at a capacity that holds all its pairs
    (`all_written`), through the mask-and-compact kernels at every group
    size and each of `tiles` (int32 staged per lane and buffer; default
    the launcher's), bit-equal to the plain version, and timed: the
    measurement behind the rule in `level_compact_group`."""
    import torch

    from repro_torch.kernels import intersect
    from repro_torch.kernels.ref import level_expand_compact_ref

    lib = intersect.load()
    tiles = tiles or (intersect.TILE_PER_LANE,)
    for key in sorted(k for k in best if isinstance(k, tuple)
                      and k[0] == "mask"):
        for how in ("as recorded", "every pair written"):
            a = best[key][1] if how == "as recorded" \
                else all_written(best[key][1])
            args = tuple(a[k] for k in ROW_ARGS)
            kw = dict(dirs=a["dirs"], width=a["width"], window=a["window"])
            want = compact_outputs(lambda o, p, n: level_expand_compact_ref(
                *args, o, p, n, **kw), a)
            off0 = a["offset"]
            off, par, col = (off0.clone(), a["parent"].clone(),
                             a["newcol"].clone())
            ms = {}
            for g in (8, 32, 256):
                for tpl in tiles:
                    opts = dict(kw, group=g, tile_per_lane=tpl)
                    got = compact_outputs(
                        lambda o, p, n: intersect.level_compact_cuda(
                            *args, o, p, n, **opts), a)
                    torch.cuda.synchronize()
                    check(all(torch.equal(x, y) for x, y in zip(got, want)),
                          f"K1 mask width={key[1]} {how}: {opts} != plain")

                    def call():
                        off.copy_(off0)
                        intersect.level_compact_cuda(*args, off, par, col,
                                                     **opts)
                    ms[(g, tpl)] = time_ms(call)
            log(f"phase 6: K1 mask width={key[1]} B={a['cstart'].numel()} "
                f"{how}: ms by (threads per row, tile per lane) " + " ".join(
                    f"{g}/{tpl}:{t:.4f}" for (g, tpl), t in ms.items())
                + f" (rule: {lib.level_compact_group(key[1])}/"
                f"{intersect.TILE_PER_LANE}) on {card}")


def parent_composition():
    """A context that puts, for the CUDA route of
    `ops.level_expand_compact`, the composition it replaced in place of
    its kernels: the executor then runs a mask level as it did before
    the mask-and-compact entry existed (`k1_mask_walls`)."""
    from repro_torch.kernels import ops

    def stand_in(*args, dirs, width, window):
        a = dict(zip(ROW_ARGS, args), dirs=dirs, width=width, window=window)
        compact_composition(a, *args[len(ROW_ARGS):])

    @contextlib.contextmanager
    def ctx():
        real = ops.level_compact_cuda
        ops.level_compact_cuda = stand_in
        try:
            yield
        finally:
            ops.level_compact_cuda = real
    return ctx()


def wiki_setup():
    """wiki-vote-syn on the card with phase 4's configuration and its
    statistics: (graph, arrays, kernel-path config, stats)."""
    from repro_torch.configs.graphpi import get_dataset
    from repro_torch.core.executor import (ExecutorConfig, auto_buckets,
                                           compute_stats, device_graph)

    wiki = get_dataset("wiki-vote-syn")
    arrays = device_graph(wiki, "cuda")
    cfg = ExecutorConfig(capacity=WIKI_CAPACITY,
                         degree_buckets=auto_buckets(wiki))
    return wiki, arrays, cfg, compute_stats(wiki, cfg, device="cuda",
                                            arrays=arrays)


def group_sweep(best, arrays, card, tiles=None) -> None:
    """The largest recorded count and signed launch of each bucket width
    through the row-sourced kernel at every group size (threads per
    frontier row) and each of `tiles` (int32 staged per lane and
    buffer; default the launcher's), bit-equal to the plain version, and
    timed: the measurement
    behind the rule in `level_rows_group`."""
    import torch

    from repro_torch.kernels import intersect
    from repro_torch.kernels.ref import level_expand_rows_ref

    tiles = tiles or (intersect.TILE_PER_LANE,)
    for key in sorted(k for k in best if isinstance(k, tuple)
                      and k[0] != "mask"):
        mode, width = key
        _, (csrc, cstart, clen, starts, lens, own, extra, neg), kw = best[key]
        args = (csrc, cstart, clen, arrays.flat, starts, lens, own, extra,
                neg)
        want = level_expand_rows_ref(*args, **kw)
        ms = {}
        for g in (8, 32, 256):
            for tpl in tiles:
                opts = dict(kw, group=g, tile_per_lane=tpl)
                got = intersect.level_rows_cuda(*args, **opts)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"K1 rows {mode} width={width}: {opts} != plain")
                ms[(g, tpl)] = time_ms(lambda: intersect.level_rows_cuda(
                    *args, **opts))
        log(f"phase 6: K1 {mode} width={width} B={cstart.numel()}: ms by "
            f"(threads per row, tile per lane) " + " ".join(
                f"{g}/{tpl}:{t:.4f}" for (g, tpl), t in ms.items())
            + f" (rule: {intersect.load().level_rows_group(width)}/"
            f"{intersect.TILE_PER_LANE}) on {card}")


def k1_rows_sweep(card, tiles=(8, 16, 24, 32)) -> None:
    """`group_sweep` and `compact_sweep` on the launches of the
    wiki-vote-syn P1 root slice (graphpi and graphzero IEP plans, kernel
    path): a quick look at the row-sourced kernels' launch shapes
    without the whole counts."""
    from repro_torch.configs.graphpi import get_pattern
    from repro_torch.kernels import ops
    from repro_torch.query.cache import plan_for

    wiki, arrays, cfg, stats = wiki_setup()
    best = {}
    for mode, iep in (("graphpi", False), ("graphzero", True)):
        _, plan = plan_for(get_pattern("P1"), stats, mode=mode, use_iep=iep)
        rec = LaunchRecorder(ops, ("mask", "count", "signed"))
        _, wall, _, _, _ = count_on(f"sweep {mode}", wiki, plan, cfg, arrays,
                                    roots=WIKI_ROOTS, during=rec)
        log(f"sweep: {mode}{' iep' if iep else ''} roots {WIKI_ROOTS}: "
            f"wall={wall:.3f}s")
        best.update(rec.best)
    group_sweep(best, arrays, card, tiles)
    compact_sweep(best, card, tiles)


def k1_mask_walls(card, roots=None, setup=None, want=WIKI_P1,
                  rounds=1) -> None:
    """The wiki-vote-syn P1 count under the graphpi plan on the kernel
    path (`roots` = (lo, hi): the roots v0 in [lo, hi) only), in one
    process, alternating how the mask levels run: the composition the
    mask-and-compact entry replaced (`parent_composition`), the entry,
    the entry, the composition, `rounds` times; each a fresh warmed
    Matcher's count (host clock ending in a synchronize), all equal to
    `want`.  `setup`: phase 4's (graph, arrays, kernel-path config,
    stats), else made here (`wiki_setup`).  Phase 4 runs it on its root
    slice; `k1_mask_walls(card)` times the whole count."""
    import torch

    from repro_torch.configs.graphpi import get_pattern
    from repro_torch.core.executor import CountState, Matcher
    from repro_torch.query.cache import plan_for

    wiki, arrays, cfg, stats = setup or wiki_setup()
    _, plan = plan_for(get_pattern("P1"), stats, mode="graphpi")
    walls = {"composition": [], "entry": []}
    for how in ("composition", "entry", "entry", "composition") * rounds:
        m = Matcher(wiki, plan, cfg, arrays=arrays, device="cuda")
        m.warmup()
        state = None if roots is None else CountState(
            spans=[(*roots, cfg.capacity)], chunk=cfg.capacity)
        with (parent_composition() if how == "composition"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, res = m.count_partial(state)
            torch.cuda.synchronize()
            walls[how].append(time.perf_counter() - t0)
        check(res is not None and not res.overflowed
              and res.count == want, f"walls {how}: {res and res.count}, "
              f"want {want}")
    what = "whole count" if roots is None else f"roots {roots}"
    log(f"walls: wiki-vote-syn P1 graphpi {what}, mask levels by the "
        f"composition / the entry, in turn: " + " ".join(
            f"{how}={','.join(f'{w:.3f}' for w in ws)}s"
            for how, ws in walls.items())
        + f"; mean {sum(walls['composition']) / len(walls['composition']):.3f}"
        f" / {sum(walls['entry']) / len(walls['entry']):.3f} s on {card}")


def composition(csrc, cstart, clen, flat, starts, lens, own, extra, neg,
                *, dirs, width, window):
    """What the row-sourced kernel replaced on the main path: the window
    gathered at `width` (plus, in signed mode, the prefix columns
    concatenated), then the gathered-window kernel through
    `ops.level_expand`."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gather_window

    cand, ok = gather_window(csrc, cstart, clen, width)
    if neg is not None:
        cand = torch.cat([cand, neg], dim=1)
        ok = torch.cat([ok, torch.ones(neg.shape, dtype=torch.bool,
                                       device=ok.device)], dim=1)
    return ops.level_expand(cand, flat, starts, lens, extra, ok, dirs=dirs,
                            count=True, window=window,
                            neg_from=None if neg is None else width)


def time_rows(mode, best, arrays, W) -> dict:
    """Phase 6, count and signed mode: the recorded launch through the
    row-sourced kernel, the composition it replaced and the plain
    version, all bit-equal, then timed in that order on the same rows."""
    import torch

    from repro_torch.kernels import intersect
    from repro_torch.kernels.ref import level_expand_rows_ref

    _, (csrc, cstart, clen, starts, lens, own, extra, neg), kw = best
    args = (csrc, cstart, clen, arrays.flat, starts, lens, own, extra, neg)
    got = intersect.level_rows_cuda(*args, **kw)
    comp = composition(*args, **kw)
    want = level_expand_rows_ref(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K1 rows != plain on recorded {mode}")
    check(torch.equal(comp, want),
          f"composition != plain on recorded {mode}")
    ms = time_ms(lambda: intersect.level_rows_cuda(*args, **kw))
    comp_ms = time_ms(lambda: composition(*args, **kw))
    plain_ms = time_ms(lambda: level_expand_rows_ref(*args, **kw), iters=5)
    bound_ms, bound_by = rows_bound_of(*args, **kw)
    P, B = starts.shape
    Q = 0 if neg is None else neg.shape[1]
    group = intersect.load().level_rows_group(kw["width"])
    return {"what": f"B={B} width={kw['width']} P={P} Q={Q} "
                    f"E={len(kw['dirs'])} group={group}",
            "ms": ms, "composition_ms": comp_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def rows_bound_of(csrc, cstart, clen, flat, starts, lens, own, extra, neg,
                  *, dirs, width, window, written=None):
    """Least time for one launch of the row-sourced kernel.  Bytes: the
    per-row inputs (cstart, clen, starts/lens, own, extra, neg) and the
    int32 output once each, and each distinct CSR row the launch must
    read once (candidate rows; predecessor rows other than own; own rows
    too where prefix columns are searched there), over HBM bandwidth.
    `written` given (the mask-and-compact entry): the int32 output is
    the `rows` input instead, and each of the `written` pairs below the
    capacity adds 8 bytes (parent and newcol).
    Operations: a full binary search of each candidate left by the > / <
    comparisons in each other row plus its != compares, a search per
    comparison to cut the range, and a search of each prefix column in
    every row plus its compares, over the cores' rate.  Returns (ms,
    "bytes" or "operations")."""
    import torch

    from repro_torch.kernels.ref import gather_window

    P, B = starts.shape
    Q = 0 if neg is None else neg.shape[1]
    E = len(dirs)
    dev = cstart.device
    n_own = 0 if own is None else 1
    own = (torch.full((B,), -1, dtype=torch.int32, device=dev)
           if own is None else own)
    plen = lens.clamp(min=0, max=window)
    clen_w = clen.clamp(min=0, max=width)
    searched = torch.arange(P, device=dev)[:, None] != own[None, :]
    keys = [(cstart.to(torch.int64) << 32) | clen_w.to(torch.int64)]
    pkeys = (starts.to(torch.int64) << 32) | plen.to(torch.int64)
    keys.append(pkeys[searched] if Q == 0 else pkeys.reshape(-1))
    rows = int((torch.unique(torch.cat(keys)) & 0xFFFFFFFF).sum())
    nbytes = (4 * B * (2 + 2 * P + n_own + E + Q + 1)
              + 4 * rows + 8 * (written or 0))
    cand, ok = gather_window(csrc, cstart, clen, width)
    for e, d in enumerate(dirs):
        if d:
            ev = extra[:, e][:, None]
            ok &= (cand > ev) if d > 0 else (cand < ev)
    n_in = ok.sum(dim=1).double()
    steps = torch.ceil(torch.log2(plen.double() + 1))
    other = (steps * searched).sum(dim=0)
    n_range = sum(1 for d in dirs if d)
    n_ne = E - n_range
    compares = float((n_in * (other + n_ne)).sum()
                     + n_range * torch.ceil(torch.log2(
                         clen_w.double() + 1)).sum()
                     + Q * (steps.sum(dim=0) + E).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = compares / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_count(what, graph, plan, cfg, arrays, roots, want, card):
    """One count of the roots `roots` on the kernel path, run once
    unprofiled (host clock ending in a synchronize) and once under
    torch.profiler; both must equal `want` (None: each other, since a
    root slice's count depends on the plan's restrictions).  Prints the
    device kernels' summed time against the unprofiled wall (the busy share; the
    profiler's own overhead inflates its window), K1's time per kernel
    (the row-sourced kernel: count or signed mode, and the mask levels'
    first pass; the scan and the emit kernel: the mask levels; the
    gathered-window kernel must not run) and the kernels that took the
    most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.executor import CountState, Matcher

    m = Matcher(graph, plan, cfg, arrays=arrays, device="cuda")
    m.warmup()

    def run():
        state = CountState(spans=[(*roots, cfg.capacity)],
                           chunk=cfg.capacity)
        _, res = m.count_partial(state)
        torch.cuda.synchronize()
        check(res is not None and not res.overflowed, f"{what} overflowed")
        return res.count

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = run()
    check(got == again and want in (None, got),
          f"{what}: unprofiled {got}, profiled {again}, want {want}")
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"profile {what}: device kernels {busy_ms:.3f} ms in "
        f"{sum(e.count for e in kern)} launches; unprofiled wall "
        f"{wall_ms:.3f} ms; busy share {100 * busy_ms / wall_ms:.1f}% "
        f"on {card}")
    n_k1 = {}
    for name in ("level_expand_kernel", "level_rows_kernel",
                 "level_compact_scan_kernel", "level_compact_kernel"):
        ev = [e for e in kern if name in e.key]
        n_k1[name] = sum(e.count for e in ev)
        log(f"profile {what}: K1 {name}: "
            f"{sum(e.self_device_time_total for e in ev) / 1e3:.3f} ms in "
            f"{n_k1[name]} launches")
    check(n_k1["level_expand_kernel"] == 0
          and n_k1["level_compact_kernel"] > 0
          and n_k1["level_compact_scan_kernel"]
          == n_k1["level_compact_kernel"],
          f"{what}: the mask levels did not all run the mask-and-compact "
          f"kernels: {n_k1}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile {what}:   {e.self_device_time_total / 1e3:9.3f} "
            f"ms  x{e.count:<6d} {e.key[:80]}")


# ------------------------------------------------------------ K4 -----
# The reference test's shapes (tests/test_flash_kernel.py:16-22):
# (BH, BK, Sq, Sk, hd); and the qwen3-1.7b serving shape (batch 4 x 16
# query heads over 4 x 8 KV heads, a 2,048-token prompt, head dim 128).
FLASH_SHAPES = [(4, 4, 256, 256, 64), (8, 2, 256, 256, 64),
                (6, 6, 128, 128, 128), (2, 1, 512, 512, 32),
                (3, 3, 384, 384, 64)]
SERVE_ROWS = (64, 32, 2048, 2048, 128)
# bf16 shapes of the wgmma kernel, with their mask: the serving shape;
# multi-query attention with granite-34b's 48 query heads over one KV
# head at S = 1,024; lengths off the 128-row tiles; and a bidirectional
# one at hd 64.
WGMMA_CASES = [(SERVE_ROWS, True), ((48, 1, 1024, 1024, 128), True),
               ((6, 3, 1000, 777, 128), True),
               ((8, 8, 2048, 2048, 64), False)]
# The reference's own tolerances (tests/test_flash_kernel.py:39).
FLASH_ATOL = {"bfloat16": 3e-2, "float32": 2e-5}
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores


def flash_inputs(shape, dtype, seed):
    """q [BH, Sq, hd] and k, v [BK, Sk, hd], standard normal, on the card."""
    import torch

    BH, BK, Sq, Sk, hd = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(s, generator=g, device=DEVICE).to(dtype)
            for s in ((BH, Sq, hd), (BK, Sk, hd), (BK, Sk, hd))]


def flash_err(got, want) -> float:
    import torch

    torch.cuda.synchronize()
    return float((got.float() - want.float()).abs().max())


def check_k4(errs) -> int:
    """K4 against its plain version on the reference test's shapes
    (causal and bidirectional, bf16 and fp32) and on `WGMMA_CASES`
    (bf16); each case within the reference's tolerance, launching the
    kernel the source's rule names (bf16 with hd % 8 == 0: wgmma; fp32:
    scalar), and each bf16 case launched twice with bit-equal results."""
    import torch

    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels.ref import flash_attention_ref

    cases = [(s, c, d) for s in FLASH_SHAPES for c in (True, False)
             for d in ("bfloat16", "float32")]
    cases += [(s, c, "bfloat16") for s, c in WGMMA_CASES]
    for i, (shape, causal, dname) in enumerate(cases):
        dtype = getattr(torch, dname)
        q, k, v = flash_inputs(shape, dtype, 100 + i)
        want_variant = "wgmma" if dname == "bfloat16" else "scalar"
        before = dict(k4.variant_launches)
        got = k4.flash_attention_cuda(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        err = flash_err(got, want)
        errs.append(err)
        what = (f"K4 {shape} {'causal' if causal else 'bidir'} {dname}")
        ran = {n: k4.variant_launches[n] - before[n] for n in before}
        check(ran == {n: int(n == want_variant) for n in ran},
              f"{what}: launched {ran}, not one {want_variant}")
        same = ""
        if dname == "bfloat16":
            again = k4.flash_attention_cuda(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{what}: two launches differ")
            same = "; relaunch bit-equal"
        log(f"phase 7: {what} ({want_variant}): max_abs_err={err:.3e} "
            f"(atol {FLASH_ATOL[dname]:g}){same}")
        check(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
        check(err <= FLASH_ATOL[dname], f"{what}: max_abs_err {err:.3e} > "
              f"{FLASH_ATOL[dname]:g}")
    return len(cases)


def graph_phases(card) -> list:
    """Phases 2-6: K1 against its plain version, the counting path end
    to end, K1's launches and times.  Returns K1's kernel records."""
    from repro_torch.configs.graphpi import get_dataset, get_pattern
    from repro_torch.core.executor import (ExecutorConfig, auto_buckets,
                                           device_graph, triangle_plan)
    from repro_torch.kernels import ops
    from repro_torch.launch import mine
    from repro_torch.query.cache import plan_for

    # ---- 2: K1 vs plain, bit-equal
    wiki = get_dataset("wiki-vote-syn")
    W = wiki.max_degree
    check((wiki.n, wiki.m, W) == (8192, 79597, 1917),
          f"wiki-vote-syn shape {(wiki.n, wiki.m, W)}")
    arrays = device_graph(wiki, "cuda")
    errs: list[float] = []
    t0 = time.perf_counter()
    n_cases = phase2(arrays, W, errs)
    log(f"phase 2: K1 == plain version on {n_cases} cases "
        f"(mask/count/signed, P=1..3, D=128/1024/1917) "
        f"in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    n_cases = phase2_rows(arrays, W, errs)
    log(f"phase 2: K1 rows (count/signed) == plain version on {n_cases} "
        f"cases (P=1..3, D=128/1024/1917, own or not, comparisons or not) "
        f"in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    n_cases = phase2_compact(arrays, W, errs)
    log(f"phase 2: K1 mask-and-compact == plain version on {n_cases} cases "
        f"(P=1..4, D=128/1024/1917, CSR and labeled, own or not, "
        f"comparisons or not, pairs kept, dropped past C, offsets near C "
        f"and past 2^31 - C, every group size, a relaunch) "
        f"in {time.perf_counter() - t0:.1f}s")

    # ---- 3: the mine entry point on tiny-er.  Every run of the main
    # path from here on sets K1's counters to 0 just before it and reads
    # them just after: each count must launch exactly the modes its plan
    # needs (kernel path) or none (portable path).
    t0 = time.perf_counter()
    tri = triangle_plan()
    runs = [(p, "graphpi", iep) for p in ("P1", "P2", "P3", "P4", "P5",
                                          "P6") for iep in (False, True)]
    runs += [("P1", "graphzero", True), ("P4", "graphzero", True)]
    for p, mode, iep in runs:
        what = f"tiny-er {p} {mode}{' iep' if iep else ''}"
        argv = ["--pattern", p, "--dataset", "tiny-er", "--mode", mode,
                "--device", "cuda"]
        argv += ["--use-iep"] if iep else []
        argv += ["--verify"] if p in ("P1", "P2", "P4", "P5") else []
        ops.reset_launches()
        res = mine.run(mine.parse_args(argv), log=lambda line: None)
        run_launches = dict(ops.launches)
        # mine's own launch record covers its count; the rest of the run
        # is the triangle count that bootstraps the performance model
        check_launches(f"{what} (count)", res.launches, res.plan, True)
        check_launches(f"{what} (stats)", {
            k: run_launches[k] - res.launches[k] for k in res.launches},
            tri, True)
        check_compact(what, run_launches)
        got = res.result.count
        if p in TINY_ER_ORACLE:
            check(got == TINY_ER_ORACLE[p],
                  f"{what}: {got} != {TINY_ER_ORACLE[p]}")
        if res.verified is not None:
            check(res.verified, f"{what}: oracle {res.expected}")
        if p == "P6":
            port, _, _, _, _ = count_on(
                f"{what} portable", res.graph, res.plan,
                ExecutorConfig(capacity=1 << 15, use_kernel=False),
                device_graph(res.graph, "cuda"))
            check(port == got, f"{what}: kernel {got} != portable {port}")
        log(f"phase 3: {what}: count={got} iep_k={res.config.iep_k} "
            f"dispatches={res.dispatches} wall={res.wall_seconds:.3f}s "
            f"K1 launches: run={run_launches} count={res.launches} "
            f"{'oracle OK' if res.verified else ''}")
    log(f"phase 3: {len(runs)} mine runs in {time.perf_counter() - t0:.1f}s")

    # ---- 4: full size, wiki-vote-syn.  The bucket layout is the one
    # benchmarks/_util.py:72 gives the reference; the capacity is 2**20
    # rather than its 2**15 because the port expands only live rows, so
    # capacity costs little memory, while every dispatch costs host round
    # trips — P1 here expands ~1e9 frontier rows in all.
    buckets = auto_buckets(wiki)
    cfgs = {path: ExecutorConfig(capacity=WIKI_CAPACITY,
                                 degree_buckets=buckets,
                                 use_kernel=path == "kernel")
            for path in ("kernel", "portable")}
    log(f"phase 4: wiki-vote-syn |V|={wiki.n} |E|={wiki.m} max_deg={W} "
        f"capacity={WIKI_CAPACITY} buckets={buckets}")
    stats = None
    for path, cfg in cfgs.items():
        stats, wall, launches = stats_on(
            f"wiki-vote-syn compute_stats {path}", wiki, cfg, arrays)
        log(f"phase 4: {path}: triangles={stats.tri_cnt} wall={wall:.3f}s "
            f"K1 launches={launches}")
        check(stats.tri_cnt == WIKI_TRIANGLES,
              f"{path} triangles {stats.tri_cnt} != {WIKI_TRIANGLES}")
    house = get_pattern("P1")
    # Whole P1 counts on the kernel path under every distinct plan of
    # the graphpi, graphzero and naive (÷ |Aut|) modes, enum and IEP
    # (graphpi folds no tail here, so its IEP plan is its enum plan).
    # The graphpi count is the named run whose mask and count launches
    # the kernels line reports, the graphzero IEP count the one for
    # signed; phase 6 times the largest launch of each.
    named = {("graphpi", False): ("mask", "count"),
             ("graphzero", True): ("signed",)}
    main_launches, recorders, plans = {}, [], set()
    for mode, iep in (("graphpi", False), ("graphpi", True),
                      ("graphzero", True), ("naive", False),
                      ("graphzero", False)):
        config, plan = plan_for(house, stats, mode=mode, use_iep=iep)
        if repr(plan) in plans:
            log(f"phase 4: P1 {mode}{' iep' if iep else ''}: same plan as "
                f"counted above")
            continue
        plans.add(repr(plan))
        recorder = LaunchRecorder(ops, named.get((mode, iep), ()))
        recorders.append(recorder)
        what = f"wiki-vote-syn P1 {mode}{' iep' if iep else ''} kernel"
        cnt, wall, disp, res, launches = count_on(
            what, wiki, plan, cfgs["kernel"], arrays,
            aut_divisor=house.aut_count() if mode == "naive" else 1,
            during=recorder)
        for k in named.get((mode, iep), ()):
            main_launches[k] = (launches[k], what)
        log(f"phase 4: {what}: count={cnt} iep_k={config.iep_k} "
            f"wall={wall:.3f}s dispatches={disp} "
            f"max_needed={res.max_needed} K1 launches={launches}")
        check(cnt == WIKI_P1, f"{what}: {cnt} != {WIKI_P1}")
    # The portable path takes ~7x the kernel path's time for a whole P1
    # count here, so the two paths meet on a slice of the roots instead.
    config, plan = plan_for(house, stats, mode="graphpi")
    part = {}
    for path, cfg in cfgs.items():
        what = f"wiki-vote-syn P1 graphpi roots {WIKI_ROOTS} {path}"
        part[path], wall, disp, _, launches = count_on(
            what, wiki, plan, cfg, arrays, roots=WIKI_ROOTS)
        log(f"phase 4: {what}: count={part[path]} wall={wall:.3f}s "
            f"dispatches={disp} K1 launches={launches}")
    check(part["kernel"] == part["portable"] > 0,
          f"P1 root slice: kernel {part['kernel']} != "
          f"portable {part['portable']}")
    # The counting path under torch.profiler: the root slice on the
    # kernel path, under the graphpi plan and the graphzero IEP plan.
    for mode, iep in (("graphpi", False), ("graphzero", True)):
        _, plan = plan_for(house, stats, mode=mode, use_iep=iep)
        profile_count(f"wiki-vote-syn P1 {mode}{' iep' if iep else ''} "
                      f"roots {WIKI_ROOTS}", wiki, plan, cfgs["kernel"],
                      arrays, WIKI_ROOTS,
                      part["kernel"] if mode == "graphpi" else None, card)
    # The same root slice with the mask levels run by the composition the
    # mask-and-compact entry replaced and by the entry, in turn.
    k1_mask_walls(card, roots=WIKI_ROOTS, want=part["kernel"], rounds=2,
                  setup=(wiki, arrays, cfgs["kernel"], stats))
    # ---- 4b: small-rmat, every P1 plan on both paths gives one count
    small = get_dataset("small-rmat")
    sarrays = device_graph(small, "cuda")
    scfgs = {path: ExecutorConfig(capacity=1 << 15,
                                  degree_buckets=auto_buckets(small),
                                  use_kernel=path == "kernel")
             for path in ("kernel", "portable")}
    sstats, _, _ = stats_on("small-rmat compute_stats kernel", small,
                            scfgs["kernel"], sarrays)
    p1, plans = {}, set()
    for mode in ("graphpi", "graphzero", "naive"):
        for iep in (False, True):
            config, plan = plan_for(house, sstats, mode=mode,
                                    use_iep=iep)
            if repr(plan) in plans:
                continue          # --use-iep folded no tail: counted above
            plans.add(repr(plan))
            div = plan.pattern.aut_count() if mode == "naive" else 1
            for path, cfg in scfgs.items():
                what = f"small-rmat P1 {mode}{' iep' if iep else ''} {path}"
                cnt, wall, disp, res, launches = count_on(
                    what, small, plan, cfg, sarrays, aut_divisor=div)
                p1[(mode, iep, path)] = cnt
                log(f"phase 4: {what}: count={cnt} iep_k={config.iep_k} "
                    f"wall={wall:.3f}s dispatches={disp} "
                    f"max_needed={res.max_needed} K1 launches={launches}")
    check(len(set(p1.values())) == 1,
          f"small-rmat P1 counts disagree across plans/paths: {p1}")
    RESULTS["small-rmat P1"] = next(iter(p1.values()))

    # ---- 5: launch counters of the named main-path runs
    for mode in ("mask", "count", "signed"):
        n, what = main_launches[mode]
        log(f"phase 5: K1 {mode}: {n} launches in the {what} count"
            + (" (each the row counts, their scan and the emit kernel; "
               "the gathered-window kernel none)" if mode == "mask" else ""))
        check(n > 0, f"K1 {mode} mode never launched in the {what} count")

    # ---- 6: per-launch time on the largest real launch of each mode;
    # mask mode also at the largest launch of each bucket width
    best = {m: b for r in recorders for m, b in r.best.items()}
    kernels = []
    check("mask" in best, "no recorded mask launch")
    # Each at the capacity it ran with (the largest launches run in
    # dispatches that overflow, so they drop pairs past C: the kernel
    # alone) and at one that holds all its pairs (the kernel, the
    # composition and its parts, the plain version); the kernels line
    # takes the latter.
    t0 = time.perf_counter()
    for key in sorted(k for k in best if isinstance(k, tuple)
                      and k[0] == "mask"):
        largest = key[1] == best["mask"][1]["width"]
        rec = time_compact(best[key], kernel_only=True)
        log(f"phase 6: K1 mask, as recorded: {rec['what']} "
            f"ms={rec['ms']:.4f} on {card}")
        rec = time_compact(best[key], window_record=largest, full=True)
        log(f"phase 6: K1 mask (every pair written): {rec.pop('what')} "
            f"ms={rec['ms']:.4f} composition_ms="
            f"{rec.pop('composition_ms'):.4f} (gather "
            f"{rec.pop('gather_ms'):.4f} + window kernel "
            f"{rec.pop('window_ms'):.4f} + compaction "
            f"{rec.pop('compact_ms'):.4f}) plain_ms="
            f"{rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
            f"({rec['bound_by']}) on {card}")
        if largest:
            mask_rec = rec
    window = mask_rec.pop("window")
    window_ms = window.pop("ms")
    log(f"phase 6: K1 gathered-window kernel, mask mode, on the largest "
        f"mask launch's window: ms={window_ms:.4f} plain_ms="
        f"{window['plain_ms']:.4f} bound_ms={window['bound_ms']:.4f} "
        f"({window['bound_by']}) on {card}")
    errs.append(0.0)
    kernels.append({
        "name": "level_expand.mask", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/level_expand.cu",
        "replaces": "src/repro/kernels/intersect.py:220",
        "launches": main_launches["mask"][0], "max_abs_err": max(errs),
        **mask_rec, "library_ms": None})
    for mode in ("count", "signed"):
        check(mode in best, f"no recorded {mode} launch")
        rec = time_rows(mode, best[mode], arrays, W)
        log(f"phase 6: K1 {mode}: {rec.pop('what')} ms={rec['ms']:.4f} "
            f"composition_ms={rec.pop('composition_ms'):.4f} "
            f"plain_ms={rec['plain_ms']:.4f} "
            f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) on {card}")
        kernels.append({
            "name": f"level_expand.{mode}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/level_expand.cu",
            "replaces": "src/repro/kernels/intersect.py:220",
            "launches": main_launches[mode][0], "max_abs_err": max(errs),
            **rec, "library_ms": None,
        })
    # the reference-shaped entry: on no main path; its launches are phase
    # 12's (set in main)
    kernels.append({
        "name": "level_expand.window", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/level_expand.cu",
        "replaces": "src/repro/kernels/intersect.py:220",
        "launches": None, "max_abs_err": max(errs), "ms": window_ms,
        **window, "library_ms": None})
    group_sweep(best, arrays, card)
    compact_sweep(best, card)
    log(f"phase 6: in {time.perf_counter() - t0:.1f}s")
    return kernels


# --------------------------------------------------------- phases 7-9 --
ARCH = "qwen3-1.7b"
DEVICE = "cuda"
SERVE_ARGV = ["--arch", ARCH, "--batch", "4", "--prompt-len", "2048",
              "--gen", "16"]
# Kernel-path vs plain-path prefill logits, both bf16 over 28 layers.
# The plain path rounds q·k to bf16 before its fp32 softmax and the
# weights to bf16 before p·v; K4 keeps both in fp32.  That rounding
# noise compounds through the residual stream: on the CPU, at 28 layers
# of hd 128 and d_model 256-512 (S = 512), the logits (std 0.33-0.45)
# differed by at most 0.022-0.027 and by 0.005-0.006 on average.  At
# full width the logits' std is ~0.9 (lm_head 0.02·√2048), so ~2x that.
# The limits keep a ~5x margin; a kernel that got the attention wrong
# (a wrong KV row, mask or scale) moves the logits by their own std.
PREFILL_MAX_ABS = 0.25
PREFILL_MEAN_ABS = 0.05


class PhaseLaunches:
    """Wraps LMSession's batch prefill, admission and decode: K4's launch
    counters are set to 0 just before each call and read just after, and
    kept as (phase, launches) in call order, with the launches of each
    K4 kernel (`variants`) and each session seen."""

    PHASES = {"_prefill": "prefill", "admit": "admit",
              "decode_steps": "decode"}

    def __init__(self):
        from repro_torch.serve.session import LMSession

        self.cls = LMSession
        self.records: list[tuple[str, int]] = []
        self.variants: list[dict] = []
        self.sessions: list = []

    def _wrap(self, fn, phase):
        import torch

        from repro_torch.kernels import flash_attention as k4
        from repro_torch.kernels import ops

        def wrapped(session, *a, **kw):
            if session not in self.sessions:
                self.sessions.append(session)
            ops.reset_launches()
            out = fn(session, *a, **kw)
            torch.cuda.synchronize()
            self.records.append((phase, ops.launches["flash"]))
            self.variants.append(dict(k4.variant_launches))
            return out
        return wrapped

    def __enter__(self):
        self.saved = {n: getattr(self.cls, n) for n in self.PHASES}
        for n, fn in self.saved.items():
            setattr(self.cls, n, self._wrap(fn, self.PHASES[n]))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.cls, n, fn)
        return False


def check_launches_k4(what, rec, want) -> None:
    """`rec` (a PhaseLaunches) saw the phases and K4 launches `want`, and
    every launch was of the wgmma kernel (bf16, hd 128)."""
    log(f"phase 8: {what}: K4 launches per phase {rec.records}; per "
        f"kernel {rec.variants}")
    check(rec.records == want, f"{what}: K4 launches {rec.records} != {want}")
    check(rec.variants == [{"scalar": 0, "wgmma": n} for _, n in want],
          f"{what}: K4 kernels {rec.variants}: the scalar one ran")


def profile_serving(session, cfg, batch, card) -> None:
    """One kernel-path batch prefill and 4 decode steps of
    `session`, each run once unprofiled (host clock, ending in a
    synchronize) and once under torch.profiler.  Prints the device
    kernels' summed time against the unprofiled wall time (the busy
    share; the profiler's own overhead inflates its window) and the
    kernels that took the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.serve_step import make_prefill

    prefill = make_prefill(cfg, DEVICE, q_chunk=0)
    for what, fn in (("prefill", lambda: prefill(session._params, batch)),
                     ("decode x4", lambda: session.decode_steps(4))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        log(f"profile {what}: device kernels {busy_ms:.3f} ms in "
            f"{sum(e.count for e in kern)} launches; unprofiled wall "
            f"{wall_ms:.3f} ms; busy share {100 * busy_ms / wall_ms:.1f}% "
            f"on {card}")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"profile {what}:   {e.self_device_time_total / 1e3:9.3f} "
                f"ms  x{e.count:<5d} {e.key[:80]}")


def serve_phase(card):
    """Phase 8: qwen3-1.7b at full width and depth on the card, through
    `repro_torch.launch.serve.main` (batch 4, prompt 2,048, 16 tokens),
    then a second session that evicts one slot and admits a new
    sequence, then kernel-path vs plain-path prefill logits.  Returns
    K4's launches in the served batch prefill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve.serve_step import make_prefill
    from repro_torch.serve.session import LMSession, fake_prompts

    cfg = get_config(ARCH)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    with PhaseLaunches() as rec:
        rc = serve.main(SERVE_ARGV + ["--device", DEVICE])
    check(rc == 0, f"serve.main exited {rc}")
    check_launches_k4("serve.main", rec, [("prefill", L), ("decode", 0)])
    served_launches = rec.records[0][1]
    served = rec.sessions[0]
    check(served.metrics()["flash_launches"] == L,
          f"the session counted {served.metrics()['flash_launches']} "
          f"K4 launches, not {L}")
    m = served.metrics()
    out = served.tokens_out()
    check(out.shape == (4, 17) and out.min() >= 0 and out.max() < cfg.vocab,
          f"served tokens {out.shape} out of range")
    log(f"phase 8: serve.main {' '.join(SERVE_ARGV)}: prefill "
        f"{4 * 2048 / m['prefill_seconds']:.0f} tok/s "
        f"({m['prefill_seconds']:.4f} s), decode {m['ms_per_step']:.3f} "
        f"ms/step ({m['decode_tok_s']:.1f} tok/s), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    rec.sessions.clear()
    del served

    # continuous batching on the card: the same seed gives the served
    # run's tokens; evict slot 2 after 4 steps and admit a new sequence;
    # the undisturbed rows stay bit-identical to the served run
    with PhaseLaunches() as rec:
        s = LMSession(ARCH, batch=4, prompt_len=2048, gen=16, seed=0,
                      device=DEVICE)
        s.start()
        s.decode_steps(4)
        gone = s.evict(2)
        slot = s.admit()
        s.decode_steps(4)
    check_launches_k4("evict/admit session", rec,
                      [("prefill", L), ("decode", 0), ("admit", L),
                       ("decode", 0)])
    check(slot == 2, f"admitted into slot {slot}")
    np_rows = s.tokens_out()
    check((gone == out[2, :5]).all(), "evicted row differs from the "
          "served run's")
    check((np_rows[[0, 1, 3]] == out[[0, 1, 3], :9]).all(),
          "undisturbed rows differ from the served run's")
    log(f"phase 8: evict/admit: slot {slot} readmitted at position 2048; "
        f"batch prefill + admission {s.prefill_seconds:.4f} s; the "
        f"undisturbed rows equal the served run's")

    # kernel path vs plain attention, same weights and prompts
    batch = fake_prompts(cfg, 4, 2048, seed=0, device=DEVICE)
    runs = {}
    for name, flash in (("kernel", True), ("plain", False)):
        ops.reset_launches()
        logits, _ = make_prefill(cfg, DEVICE, q_chunk=0, flash=flash)(
            s._params, batch)
        torch.cuda.synchronize()
        runs[name] = (logits, ops.launches["flash"],
                      k4.variant_launches["wgmma"])
    (kl, kn, kw), (pl, pn, pw) = runs["kernel"], runs["plain"]
    check((kn, pn, kw, pw) == (L, 0, L, 0),
          f"prefill launches kernel={kn} ({kw} wgmma) plain={pn}")
    check(bool(torch.isfinite(kl).all()), "kernel-path logits not finite")
    diff = (kl - pl).abs()
    d_max, d_mean = float(diff.max()), float(diff.mean())
    log(f"phase 8: prefill logits [4, {cfg.vocab}] kernel vs plain path: "
        f"max_abs={d_max:.4f} (limit {PREFILL_MAX_ABS}) mean_abs="
        f"{d_mean:.5f} (limit {PREFILL_MEAN_ABS}) logit std "
        f"{float(pl.std()):.4f}; argmax equal in "
        f"{int((kl.argmax(-1) == pl.argmax(-1)).sum())}/4 rows; served "
        f"first tokens {'equal' if (kl.argmax(-1).cpu().numpy() == out[:, 0]).all() else 'DIFFER'}")
    check(d_max <= PREFILL_MAX_ABS and d_mean <= PREFILL_MEAN_ABS,
          f"kernel vs plain prefill logits: max {d_max} mean {d_mean}")
    check((kl.argmax(-1).cpu().numpy() == out[:, 0]).all(),
          "kernel-path prefill tokens differ from the served run's")
    profile_serving(s, cfg, batch, card)
    return served_launches


def time_k4(card, errs) -> dict:
    """Phase 9: at the serving shape, in one process and on the same
    tensors: K4's wgmma kernel (the serving path), the scalar kernel's
    bf16 instantiation (the design it replaced), the plain version and
    PyTorch's `scaled_dot_product_attention` (the library yardstick; the
    port never calls it), with CUDA events (3 warm-up launches, then 50
    timed; 20 for the scalar kernel, 5 for the plain version), beside the
    card's bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref

    BH, BK, S, _, hd = SERVE_ROWS
    q, k, v = flash_inputs(SERVE_ROWS, torch.bfloat16, 7)
    got = flash_attention_cuda(q, k, v, causal=True)
    old = flash_attention_cuda(q, k, v, causal=True, variant="scalar")
    want = flash_attention_ref(q, k, v, causal=True)
    errs.append(flash_err(got, want))
    old_err = flash_err(old, want)
    ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal=True),
                 iters=50)
    scalar_ms = time_ms(lambda: flash_attention_cuda(
        q, k, v, causal=True, variant="scalar"))
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                       iters=5)
    B = 4
    q4, k4, v4 = (t.view(B, t.shape[0] // B, S, hd) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          enable_gqa=True)
    sdpa_err = flash_err(got.view(B, BH // B, S, hd), sdpa)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), iters=50)
    flops = 4.0 * BH * hd * S * (S + 1) / 2          # causal pairs only
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = ((t_ops, "operations") if t_ops >= t_bytes
                          else (t_bytes, "bytes"))
    tflops = flops / ms / 1e9
    log(f"phase 9: K4 q [{BH}, {S}, {hd}] k/v [{BK}, {S}, {hd}] bf16 "
        f"causal: wgmma ms={ms:.4f} ({tflops:.1f} TFLOP/s, "
        f"{100 * bound_ms / ms:.1f}% of the bound) scalar_ms="
        f"{scalar_ms:.4f} ({flops / scalar_ms / 1e9:.1f} TFLOP/s) "
        f"plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
        f"({flops / library_ms / 1e9:.1f} TFLOP/s) bound_ms={bound_ms:.4f} "
        f"({bound_by}: {flops:.3e} FLOP, {nbytes / 1e9:.4f} GB); "
        f"wgmma/sdpa {ms / library_ms:.2f}x, scalar/wgmma "
        f"{scalar_ms / ms:.1f}x; max_abs vs plain wgmma={errs[-1]:.3e} "
        f"scalar={old_err:.3e} sdpa={flash_err(sdpa, want.view(sdpa.shape)):.3e}"
        f", wgmma vs sdpa {sdpa_err:.3e} on {card}")
    check(old_err <= FLASH_ATOL["bfloat16"],
          f"scalar K4 max_abs_err {old_err:.3e}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "variant": "wgmma", "tflops": tflops}


def lm_phases(card) -> list:
    """Phases 7-9; returns K4's kernel record."""
    errs: list[float] = []
    t0 = time.perf_counter()
    n = check_k4(errs)
    log(f"phase 7: K4 within tolerance of the plain version on {n} cases "
        f"in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches = serve_phase(card)
    log(f"phase 8: serving checks in {time.perf_counter() - t0:.1f}s")
    times = time_k4(card, errs)
    return [{"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:92",
             "launches": launches, "max_abs_err": max(errs), **times}]


# ------------------------------------------------------ phases 10-12 --
# The reference kernel test's shapes (tests/test_kernels.py:26-34), rows
# longer than the first version's shared tile (4,096 int32), rows of
# 1,000 / 1,024 / 4,096 entries (power-of-two lengths are where a linear
# shared row meets its bank conflicts), and D and L off multiples of 4
# (the padded kernel's 4-byte path).
MEMBERSHIP_SHAPES = [(1, 1, 1), (3, 5, 7), (8, 128, 128), (16, 256, 384),
                     (9, 130, 200), (2, 300, 64), (32, 64, 512),
                     (4, 700, 9000), (1, 1, 5000), (64, 1024, 1000),
                     (64, 1024, 1024), (16, 512, 4096), (7, 333, 1001)]
# benchmarks/kernel_intersect.py:28-29 (B, D, L), then one executor-scale
# shape: a wiki-vote-syn level's frontier rows and window.
MEMBERSHIP_TIMED = [(256, 128, 128), (512, 128, 256), (1024, 256, 512),
                    (4096, 128, 128), (65536, 1024, 1024)]
# Rows of 1,000 / 4,000 entries beside 1,024 / 4,096 at B = 65,536,
# D = 1,024: the first version's bank conflicts come with power-of-two
# rows.
MEMBERSHIP_BANKS = [(65536, 1024, 1000), (65536, 1024, 1024),
                    (65536, 1024, 4000), (65536, 1024, 4096)]
# benchmarks/kernel_intersect.py:81-82 (B, D, P, L), then 65,536 x 1,024
# with P = 2.
LEVEL_SHAPES = [(256, 128, 3, 128), (512, 128, 4, 256),
                (1024, 256, 2, 512), (65536, 1024, 2, 1024)]
RESULTS: dict = {}               # counts one phase hands to a later one


def sorted_rows(gen, rows, L):
    """[rows, L] strictly increasing int32 rows on the card: cumulative
    sums of gaps drawn from 1..19 (mean 10, so values reach ~10·L, as the
    reference benchmark's rows drawn from range(10·L) do)."""
    import torch

    gaps = torch.randint(1, 20, (rows, L), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    return gaps.cumsum(1, dtype=torch.int32)


def rows_case(gen, B, D, L, dtype=None):
    """Candidates in [0, 10·L] and sorted rows, optionally cast."""
    import torch

    cand = torch.randint(0, 10 * L + 1, (B, D), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    nbr = sorted_rows(gen, B, L)
    if dtype is not None:
        cand, nbr = cand.to(dtype), nbr.to(dtype)
    return cand, nbr


def membership_plain(cand, nbr, count):
    from repro_torch.kernels.ref import (intersect_count_plain,
                                         membership_ref_searchsorted)

    return (intersect_count_plain(cand, nbr) if count
            else membership_ref_searchsorted(cand, nbr))


def offset_view(t, elems=1):
    """A contiguous copy of `t` whose data_ptr lies `elems` elements past
    an allocation's start (4 bytes off a 16-byte boundary for int32)."""
    import torch

    flat = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = flat[elems:].view(t.shape)
    view.copy_(t)
    return view


def check_membership(gen, errs) -> int:
    """Phase 10: K2 and K3 through `ops.sorted_membership` /
    `ops.intersect_count` (the padded kernel, the ragged contract read in
    it) against their plain versions on the widened, padded inputs, and
    against the first version (`membership_linear_cuda`) on those same
    padded inputs, bit-equal."""
    import torch

    from repro_torch.kernels import membership, ops

    def one(what, cand, nbr, **kw):
        c32, n32 = ops._stacked_rows(cand, nbr, kw.get("cand_valid"),
                                     kw.get("nbr_len"), (1, 1, 1))
        for count, k in ((False, "K2"), (True, "K3")):
            fn = ops.intersect_count if count else ops.sorted_membership
            got = fn(cand, nbr, **kw)
            want = membership_plain(c32, n32, count)
            first = membership.membership_linear_cuda(c32, n32, count=count)
            torch.cuda.synchronize()
            err = (got.to(torch.int64) - want.to(torch.int64)).abs()
            errs[k].append(float(err.max()) if err.numel() else 0.0)
            check(torch.equal(got, want), f"{k} != plain on {what}")
            check(torch.equal(got, first),
                  f"{k} != the first version on {what}")
        return 1

    n = 0
    for B, D, L in MEMBERSHIP_SHAPES:
        for dtype in ((torch.int32, torch.int16) if L <= 512
                      else (torch.int32,)):
            n += one(f"{(B, D, L)} {dtype}", *rows_case(gen, B, D, L, dtype))
    for B, D, L in ((6, 100, 150), (5, 333, 9000), (8, 128, 128),
                    (64, 1024, 1024), (9, 7, 1001)):
        cand, nbr = rows_case(gen, B, D, L)
        nbr_len = torch.randint(0, L + 1, (B,), generator=gen, device=DEVICE)
        nbr_len[0] = 0
        if B == 8:
            nbr_len.zero_()                          # every row empty
        valid = torch.rand((B, D), generator=gen, device=DEVICE) < 0.7
        n += one(f"ragged {(B, D, L)}", cand, nbr, cand_valid=valid,
                 nbr_len=nbr_len)
    # nbr_len past L, negative, int64, all zero (int32 and int64)
    cand, nbr = rows_case(gen, 12, 200, 300)
    lens = torch.tensor([0, 1, 299, 300, 301, 10**6, -1, -10**6, 2**40,
                         -2**40, 150, 7], device=DEVICE)
    for what, nl in (("int64 past L and negative", lens),
                     ("int32 past L and negative",
                      lens.clamp(-2**31, 2**31 - 1).to(torch.int32)),
                     ("int64 all zero", torch.zeros(12, dtype=torch.int64,
                                                    device=DEVICE)),
                     ("int32 all zero", torch.zeros(12, dtype=torch.int32,
                                                    device=DEVICE))):
        n += one(f"nbr_len {what}", cand, nbr, nbr_len=nl)
    # invalid candidates are -1, not misses: rows holding -1 match them
    cand, nbr = rows_case(gen, 10, 64, 96)
    nbr[:, 0] = -1
    valid = torch.rand((10, 64), generator=gen, device=DEVICE) < 0.5
    n += one("-1 in the rows, cand_valid", cand, nbr, cand_valid=valid)
    # pointers 4 bytes off a 16-byte boundary (the 4-byte path)
    for B, D, L in ((16, 256, 384), (64, 1024, 1024)):
        cand, nbr = rows_case(gen, B, D, L)
        valid = torch.rand((B, D), generator=gen, device=DEVICE) < 0.7
        view = offset_view(cand)
        check(view.data_ptr() % 16 == 4, "offset view is not misaligned")
        n += one(f"misaligned cand {(B, D, L)}", view, nbr)
        n += one(f"misaligned cand and cand_valid {(B, D, L)}", view,
                 offset_view(nbr), cand_valid=offset_view(valid, 1))
    cand, nbr = rows_case(gen, 12, 200, 300)
    for bb, bd, bl in ((8, 128, 128), (8, 128, 256), (16, 256, 128)):
        n += one(f"blocks {(bb, bd, bl)}", cand, nbr, block_b=bb,
                 block_d=bd, block_l=bl)
    for tile in (1, 7, 64, 4096, membership.TILE):   # rows over 1..300 tiles
        for count in (False, True):
            want = membership_plain(cand, nbr, count)
            for group in (0, 32, 256):
                got = membership.membership_cuda(cand, nbr, count=count,
                                                 tile=tile, group=group)
                check(torch.equal(got, want),
                      f"K2/K3 tile {tile} group {group} count={count} "
                      f"!= plain")
            if tile <= membership.LINEAR_TILE:
                got = membership.membership_linear_cuda(cand, nbr,
                                                        count=count,
                                                        tile=tile)
                check(torch.equal(got, want),
                      f"first version tile {tile} count={count} != plain")
        n += 1
    cand = torch.tensor([[5, 5, 5, 7]], dtype=torch.int32, device=DEVICE)
    nbr = torch.tensor([[1, 5, 9, 2**31 - 1]], dtype=torch.int32,
                       device=DEVICE)
    n += one("duplicate candidates", cand, nbr)
    check(int(ops.intersect_count(cand, nbr)[0]) == 3,
          "duplicate candidates not counted separately")
    return n


def membership_bound(B, D, L, count, ragged=False):
    """Least time for one K2/K3 launch: cand and nbr read once (4 B per
    entry), nbr_len (4 B a row) and cand_valid (1 B a candidate) where
    passed, and the output written once (1 B per candidate, or 4 B per
    row), over HBM bandwidth; against a binary search of each candidate,
    ceil(log2(L + 1)) compares, over the cores' rate."""
    import math

    nbytes = 4 * B * D + 4 * B * L + (4 * B if count else B * D)
    if ragged:
        nbytes += 4 * B + B * D
    compares = B * D * math.ceil(math.log2(L + 1))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = compares / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


PROFILE_TRIES = 4


def device_ms(fn, names, iters=20):
    """Device time per launch of the kernels whose names contain one of
    `names`, from torch.profiler: `iters` calls of `fn` in a warm-up
    cycle, then `iters` in the recorded one, averaged over the launches
    the trace holds (returned with their count); with the events' time
    beside it, this tells the host's cost per call from the kernel's.
    The profiler has delivered a recorded cycle without a single device
    event (1 of ~30 profiles on the card): such a cycle is profiled
    again, up to PROFILE_TRIES times in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for tries in range(1, PROFILE_TRIES + 1):
        traced = []              # the recorded cycle's events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.extend(
                         p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ev = [e for e in traced
              if e.device_type == DeviceType.CUDA
              and any(n in e.key for n in names)]
        launches = sum(e.count for e in ev)
        if launches:
            break
        log(f"phase 11: profile {tries} of {names} traced no launch")
    check(0 < launches <= iters, f"profiled {launches} launches of {names} "
          f"for {iters} calls in {tries} profiles")
    return sum(e.self_device_time_total for e in ev) / 1e3 / launches, \
        launches


def membership_step0(gen, card) -> None:
    """The first version at B = 65,536, D = 1,024 and L = 1,000 / 1,024 /
    4,000 / 4,096 (rows of a power-of-two length meet its bank
    conflicts), and `cand.clone()` + `nbr.clone()` at L = 1,024: what the
    card achieves on the same bytes (each read and written once; the
    port never calls it)."""
    import torch

    from repro_torch.kernels.membership import membership_linear_cuda

    for B, D, L in MEMBERSHIP_BANKS:
        cand, nbr = rows_case(gen, B, D, L)
        for count, k in ((False, "K2"), (True, "K3")):
            got = membership_linear_cuda(cand, nbr, count=count)
            torch.cuda.synchronize()
            check(torch.equal(got, membership_plain(cand, nbr, count)),
                  f"first version {k} != plain at {(B, D, L)}")
            ms = time_ms(lambda: membership_linear_cuda(cand, nbr,
                                                        count=count))
            bound_ms, _ = membership_bound(B, D, L, count)
            log(f"phase 11: step 0: first version {k} B={B} D={D} L={L}: "
                f"ms={ms:.4f} bound_ms={bound_ms:.4f} "
                f"({100 * bound_ms / ms:.1f}% of bound) on {card}")
        if L == 1024:
            ms = time_ms(lambda: (cand.clone(), nbr.clone()))
            moved = 2 * 4 * (cand.numel() + nbr.numel())
            log(f"phase 11: step 0: cand.clone() + nbr.clone() B={B} D={D} "
                f"L={L}: ms={ms:.4f} ({moved / ms / 1e9:.3f} TB/s read + "
                f"written; the kernels' inputs alone at that rate: "
                f"{moved / 2 / (moved / ms):.4f} ms) on {card}")
        del cand, nbr


def time_membership(gen, card, errs) -> dict:
    """Phase 11: K2 and K3 per launch (CUDA events, 3 warm-up launches,
    then 20; the plain version over 5) at the reference benchmark's
    shapes, the executor-scale shape and rows of 1,000 / 1,024 / 4,000 /
    4,096 entries: the padded kernel, the first version and the plain
    version on the same tensors, beside the card's bound; at the small
    shapes also the device time per launch from torch.profiler; at
    65,536 x 1,024 x 1,024 also a warp and a block per row forced, and
    ragged rows (nbr_len, cand_valid) through `ops`, which passes them
    to the kernel, beside the first version behind the padded copies
    the wrapper used to make.  Returns the executor-scale shape's numbers
    per kernel."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.membership import (group_of,
                                                membership_cuda,
                                                membership_linear_cuda)

    membership_step0(gen, card)
    out = {}
    for B, D, L in MEMBERSHIP_TIMED + [s for s in MEMBERSHIP_BANKS
                                      if s not in MEMBERSHIP_TIMED]:
        cand, nbr = rows_case(gen, B, D, L)
        for count, k in ((False, "K2"), (True, "K3")):
            got = membership_cuda(cand, nbr, count=count)
            want = membership_plain(cand, nbr, count)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{k} != plain at {(B, D, L)}")
            errs[k].append(0.0)
            ms = time_ms(lambda: membership_cuda(cand, nbr, count=count))
            linear_ms = time_ms(lambda: membership_linear_cuda(
                cand, nbr, count=count))
            plain_ms = time_ms(lambda: membership_plain(cand, nbr, count),
                               iters=5)
            bound_ms, bound_by = membership_bound(B, D, L, count)
            extra = ""
            if B <= 4096:
                dev, n_dev = device_ms(lambda: membership_cuda(
                    cand, nbr, count=count), ("membership_padded_kernel",))
                lin, n_lin = device_ms(lambda: membership_linear_cuda(
                    cand, nbr, count=count), ("membership_linear_kernel",))
                extra = (f" device_ms={dev:.4f} linear_device_ms={lin:.4f}"
                         f" (profiler, {n_dev} / {n_lin} of 20 launches "
                         f"traced)")
            log(f"phase 11: {k} B={B} D={D} L={L} group={group_of(L)}: "
                f"ms={ms:.4f} linear_ms={linear_ms:.4f} "
                f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                f"({bound_by}; {100 * bound_ms / ms:.1f}% of bound, first "
                f"version {100 * bound_ms / linear_ms:.1f}%){extra} on {card}")
            if (B, D, L) == MEMBERSHIP_TIMED[-1]:
                out[k] = {"ms": ms, "linear_ms": linear_ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}
                forced = {g: time_ms(lambda: membership_cuda(
                    cand, nbr, count=count, group=g)) for g in (32, 256)}
                log(f"phase 11: {k} B={B} D={D} L={L}: a warp per row "
                    f"{forced[32]:.4f} ms, a block per row "
                    f"{forced[256]:.4f} ms on {card}")
        if (B, D, L) == MEMBERSHIP_TIMED[-1]:
            nbr_len = L - torch.randint(0, L // 4 + 1, (B,), generator=gen,
                                        device=DEVICE)
            valid = torch.rand((B, D), generator=gen, device=DEVICE) < 0.7
            for count, k in ((False, "K2"), (True, "K3")):
                fn = ops.intersect_count if count else ops.sorted_membership

                def padded_first():
                    c32, n32 = ops._stacked_rows(cand, nbr, valid, nbr_len,
                                                 (1, 1, 1))
                    return membership_linear_cuda(c32, n32, count=count)

                got = fn(cand, nbr, valid, nbr_len)
                torch.cuda.synchronize()
                check(torch.equal(got, padded_first()),
                      f"ragged {k} != the first version at {(B, D, L)}")
                ms = time_ms(lambda: fn(cand, nbr, valid, nbr_len))
                first_ms = time_ms(padded_first)
                bound_ms, _ = membership_bound(B, D, L, count, ragged=True)
                log(f"phase 11: {k} ragged (nbr_len, cand_valid) B={B} "
                    f"D={D} L={L}: ops ms={ms:.4f} (the kernel reads them); "
                    f"padded copies + first version ms={first_ms:.4f}; "
                    f"bound_ms={bound_ms:.4f} "
                    f"({100 * bound_ms / ms:.1f}% of bound) on {card}")
        del cand, nbr
    return out


def level_case(gen, B, D, P, L, E=2):
    """benchmarks/kernel_intersect.py's level data, built on the card: P·B
    strictly increasing rows of L entries in one flat array (plus the
    flat_gather_pad sentinels), row lengths cut by up to L/4 so the
    windows' ragged tails matter, candidates and prefix values in
    [0, 10·L], comparisons (>, !=)."""
    import torch

    from repro_torch.kernels import ops

    flat = torch.cat([sorted_rows(gen, P * B, L).reshape(-1),
                      torch.full((ops.flat_gather_pad(),), ops.NBR_PAD,
                                 dtype=torch.int32, device=DEVICE)])
    starts = (torch.arange(P * B, device=DEVICE, dtype=torch.int32)
              * L).reshape(P, B)
    lens = (L - torch.randint(0, L // 4 + 1, (P, B), generator=gen,
                              device=DEVICE)).to(torch.int32)
    cand = torch.randint(0, 10 * L + 1, (B, D), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    extra = torch.randint(0, 10 * L + 1, (B, E), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    dirs = tuple(1 if e % 2 == 0 else 0 for e in range(E))
    return cand, flat, starts, lens, extra, dirs


def per_pred(cand, flat, starts, lens, extra, dirs, L, count):
    """benchmarks/kernel_intersect.py:108-181 `per_pred` in torch: one
    mask per comparison, then per predecessor a [B, L] window gathered
    from the flat array and one K2 launch with nbr_len = lens[p]; in
    count mode the last predecessor is one K3 launch over the candidates
    that survived (cand_valid), which is the row count."""
    import torch

    from repro_torch.kernels import ops

    mask = torch.ones(cand.shape, dtype=torch.bool, device=cand.device)
    for e, d in enumerate(dirs):
        ev = extra[:, e][:, None]
        mask &= (cand > ev) if d > 0 else (cand < ev) if d < 0 \
            else (cand != ev)
    pos = torch.arange(L, dtype=torch.int32, device=cand.device)
    P = starts.shape[0]
    for p in range(P):
        window = flat[starts[p][:, None] + pos[None, :]]
        if count and p == P - 1:
            return ops.intersect_count(cand, window, cand_valid=mask,
                                       nbr_len=lens[p])
        mask &= ops.sorted_membership(cand, window, nbr_len=lens[p])
    return mask


def per_pred_phase(gen, card) -> dict:
    """Phase 12: the per-predecessor composition (K2/K3) against the
    fused K1 at the reference benchmark's level shapes and 65,536 x 1,024,
    P = 2: bit-equal masks, row counts equal to K1's count mode.  K2's and
    K3's counters are set to 0 just before these runs and read just after
    (they are the path K2 and K3 serve); then both are timed."""
    import torch

    from repro_torch.kernels import ops

    from repro_torch.kernels import membership

    cases = [(shape, level_case(gen, *shape)) for shape in LEVEL_SHAPES]
    torch.cuda.synchronize()
    ops.reset_launches()
    for (B, D, P, L), (cand, flat, starts, lens, extra, dirs) in cases:
        m = per_pred(cand, flat, starts, lens, extra, dirs, L, False)
        c = per_pred(cand, flat, starts, lens, extra, dirs, L, True)
        fm = ops.level_expand(cand, flat, starts, lens, extra, dirs=dirs,
                              window=L)
        fc = ops.level_expand(cand, flat, starts, lens, extra, dirs=dirs,
                              window=L, count=True)
        torch.cuda.synchronize()
        check(torch.equal(m, fm), f"per-pred mask != K1 at {(B, D, P, L)}")
        check(torch.equal(c, fc), f"per-pred count != K1 at {(B, D, P, L)}")
        check(torch.equal(c, m.sum(dim=1, dtype=torch.int32)),
              f"per-pred count != its mask's row sums at {(B, D, P, L)}")
    launches = {k: ops.launches[k] for k in ("membership",
                                             "intersect_count")}
    want = {"membership": sum(2 * P - 1 for _, _, P, _ in LEVEL_SHAPES),
            "intersect_count": len(LEVEL_SHAPES)}
    # the fused K1 here is the gathered-window kernel: the launches the
    # kernels line reports for it
    RESULTS["K1 window launches"] = ops.launches["mask"] \
        + ops.launches["count"]
    check(RESULTS["K1 window launches"] == 2 * len(LEVEL_SHAPES),
          f"K1 gathered-window launches {ops.launches}")
    kernels = dict(membership.kernel_launches)
    log(f"phase 12: per-pred == fused K1 (mask and count) at "
        f"{len(LEVEL_SHAPES)} shapes; K2/K3 launches {launches}, by kernel "
        f"{kernels}")
    check(launches == want, f"K2/K3 launches {launches} != {want}")
    check(kernels == {"padded": sum(want.values()), "linear": 0},
          f"K2/K3 launches by kernel {kernels}: not all the padded kernel")
    for (B, D, P, L), (cand, flat, starts, lens, extra, dirs) in cases:
        args = (cand, flat, starts, lens, extra, dirs, L)
        t = {name: time_ms(fn, iters=10) for name, fn in (
            ("per-pred mask", lambda: per_pred(*args, False)),
            ("per-pred count", lambda: per_pred(*args, True)),
            ("fused mask", lambda: ops.level_expand(
                cand, flat, starts, lens, extra, dirs=dirs, window=L)),
            ("fused count", lambda: ops.level_expand(
                cand, flat, starts, lens, extra, dirs=dirs, window=L,
                count=True)))}
        log(f"phase 12: B={B} D={D} P={P} L={L} E={len(dirs)}: "
            + " ".join(f"{k}={v:.4f}ms" for k, v in t.items())
            + f" per-pred/fused mask {t['per-pred mask'] / t['fused mask']:.2f}x"
            f" count {t['per-pred count'] / t['fused count']:.2f}x on {card}")
    return launches


def membership_phases(card) -> list:
    """Phases 10-12; returns K2's and K3's kernel records."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(13)
    errs = {"K2": [], "K3": []}
    t0 = time.perf_counter()
    n = check_membership(gen, errs)
    log(f"phase 10: K2 and K3 == plain versions on {n} cases in "
        f"{time.perf_counter() - t0:.1f}s")
    times = time_membership(gen, card, errs)
    launches = per_pred_phase(gen, card)
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/membership.cu",
             "replaces": f"src/repro/kernels/intersect.py:{line}",
             "launches": launches[name], "max_abs_err": max(errs[k]),
             **times[k], "library_ms": None}
            for name, k, line in (("membership", "K2", 307),
                                  ("intersect_count", "K3", 338))]


# ------------------------------------------------------------ phase 13 --
def engine_phase(card) -> None:
    """Phase 13: the query engine on the card, small-rmat P1: duplicate
    tickets of one class resolve in one execution, an isomorphic re-query
    is a cache hit that searches nothing, a count preempted after every
    dispatch resumes to the uninterrupted count; K1's counters are set to
    0 just before each run and must show exactly the plan's modes."""
    import torch

    from repro_torch.configs.graphpi import get_dataset, get_pattern
    from repro_torch.core.executor import ExecutorConfig, auto_buckets
    from repro_torch.kernels import ops
    from repro_torch.query import (QueryEngine, QueryRequest,
                                   relabeled_variant)

    t0 = time.perf_counter()
    small = get_dataset("small-rmat")
    cfg = ExecutorConfig(capacity=1 << 15, degree_buckets=auto_buckets(small))
    house = get_pattern("P1")
    want = RESULTS["small-rmat P1"]

    def serve(engine, what, patterns):
        tickets = [engine.enqueue(QueryRequest(p)) for p in patterns]
        torch.cuda.synchronize()
        ops.reset_launches()
        rounds = 0
        while not all(t.done for t in tickets):
            engine.run_pending()
            rounds += 1
            check(rounds <= 100000, f"{what}: no end")
        torch.cuda.synchronize()
        launches = dict(ops.launches)
        entry = next(e for e in engine.cache.entries()
                     if e.canon_key == tickets[0].result.canon_key)
        check_launches(what, launches, entry.plan, True)
        check_compact(what, launches)
        counts = {t.result.count for t in tickets}
        check(counts == {want}, f"{what}: counts {counts} != {want}")
        log(f"phase 13: {what}: count={want} rounds={rounds} "
            f"executions={engine.executions} coalesced={engine.coalesced} "
            f"preemptions={engine.preemptions} cache={engine.cache.stats.hits}"
            f" hits/{engine.cache.stats.n_searches} searches "
            f"K1 launches={launches}")
        return tickets, rounds

    eng = QueryEngine(small, cfg=cfg, device=DEVICE)
    n_dup = 4
    ts, _ = serve(eng, f"{n_dup} duplicate P1 tickets", [house] + [
        relabeled_variant(house, seed=s) for s in range(1, n_dup)])
    check(eng.executions == 1 and eng.coalesced == n_dup - 1
          and not ts[0].result.cache_hit
          and all(t.result.coalesced and t.result.cache_hit for t in ts[1:]),
          "duplicate tickets were not coalesced into one execution")
    searches = eng.cache.stats.n_searches
    (t,), _ = serve(eng, "isomorphic re-query", [relabeled_variant(house, 11)])
    check(t.result.cache_hit and eng.cache.stats.n_searches == searches
          and eng.executions == 2, "the isomorphic re-query was not a hit")

    whole = QueryEngine(small, cfg=cfg, chunk=128, stats=eng.stats,
                        device=DEVICE)
    serve(whole, "P1 at chunk 128, uninterrupted", [house])
    dispatches = whole.last_round_dispatches
    pre = QueryEngine(small, cfg=cfg, chunk=128, stats=eng.stats,
                      preempt_dispatches=1, device=DEVICE)
    _, rounds = serve(pre, "P1 at chunk 128, preempted every dispatch",
                      [house])
    check(rounds == dispatches and pre.preemptions == rounds - 1
          and pre.executions == 1,
          f"preempted run took {rounds} rounds for {dispatches} dispatches")
    log(f"phase 13: engine checks in {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------ phase 14 --
FRONT_SEED = 14
FRONT_WIKI = "wiki-vote-syn"    # the cold serve, restarts and live graph
FRONT_SMALL = "small-rmat"      # the RPC server and the graph + LM run
FRONT_LIVE_BATCH = 256          # inserts and deletes per live epoch
FRONT_LIVE_CHUNK = 1024         # the live engine's root grid: 8 spans
FRONT_LM_ARGV = ["--arch", ARCH, "--batch", "2", "--prompt-len", "512",
                 "--gen", "8", "--seed", "0", "--device", DEVICE]


def front_serve(what, argv, want, prefix="phase 14"):
    """One `repro_torch.launch.gateway` run (graph tenant only) with
    K1's counters set to 0 just before it and read just after, under an
    enabled tracer whose `executor.count` spans give each count's
    dispatches.  The results must be `want`, and the counters exactly
    the modes of the plans run (the cached plans and the triangle count
    that bootstraps the perf model), every mask launch through the
    mask-and-compact kernels."""
    import torch

    from repro_torch.core.executor import triangle_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import gateway
    from repro_torch.obs.trace import Tracer, get_tracer, set_tracer

    prev = get_tracer()
    tracer = set_tracer(Tracer(enabled=True))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        out = gateway.run(gateway.parse_args(argv),
                          log=lambda line: log(f"{prefix}: {what}: {line}"))
        torch.cuda.synchronize()
    finally:
        set_tracer(prev)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    check(out.rc == 0, f"{what}: gateway exited {out.rc}")
    counts = [r.count for r in out.results]
    check(counts == want, f"{what}: counts {counts} != {want}")
    plans = [e.plan for e in out.engine.cache.entries()]
    modes = set().union(kernel_modes(triangle_plan()),
                        *(kernel_modes(p) for p in plans))
    got = {k for k in ("mask", "count", "signed") if launches[k]}
    check(got == modes, f"{what}: K1 launches {launches}, but the plans "
          f"need modes {sorted(modes)}")
    check_compact(what, launches)
    dispatches = [sp["attrs"].get("dispatches") for sp in tracer.spans()
                  if sp["name"] == "executor.count"]
    return out, launches, wall, dispatches


def front_door_phase(card) -> dict:
    """Phase 14: the graph serving front door on the card — the plan
    store, the live graph, the RPC server and the graph + LM gateway,
    each through the launchers a user runs.  Returns the K1 launches of
    the cold serve per mode and K4's per prefill of the graph + LM run,
    keyed by kernel record name."""
    import io
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.graphpi import get_dataset, get_pattern
    from repro_torch.core.executor import (ExecutorConfig, auto_buckets,
                                           device_graph)
    from repro_torch.graph.csr import GraphCSR
    from repro_torch.kernels import ops
    from repro_torch.launch import gateway, plan_warmup, serve
    from repro_torch.query import QueryEngine, QueryRequest, relabeled_variant
    from repro_torch.serve.rpc import RPCClient

    t_phase = time.perf_counter()
    out_launches = {}
    rng = np.random.default_rng(FRONT_SEED)
    with tempfile.TemporaryDirectory(prefix="front-door-") as tmp:
        # ---- 1: cold serve, wiki-vote-syn, through launch.gateway
        iso = relabeled_variant(get_pattern("P1"), seed=FRONT_SEED)
        reqs = os.path.join(tmp, "wiki.jsonl")
        with open(reqs, "w") as f:
            for spec in ({"pattern": "P1"},
                         {"pattern": {"n": iso.n, "name": "house-iso",
                                      "edges": [list(e) for e in iso.edges]}},
                         {"pattern": "triangle"}):
                f.write(json.dumps(spec) + "\n")
        store = os.path.join(tmp, "plans")
        argv = ["--no-lm", "--dataset", FRONT_WIKI, "--requests", reqs,
                "--cache-dir", store, "--graph-quantum", "2",
                "--capacity", str(WIKI_CAPACITY), "--model-buckets",
                "--device", DEVICE]
        want = [WIKI_P1, WIKI_P1, WIKI_TRIANGLES]
        runs = {}
        for what, extra in (("cold serve", []),
                            ("restart, load-through", []),
                            ("restart, --warm-from-disk",
                             ["--warm-from-disk"])):
            out, launches, wall, disp = front_serve(what, argv + extra, want)
            cs = out.engine.cache.stats
            res = out.results
            log(f"phase 14: {what}: wall {wall:.3f}s; counts "
                f"{[r.count for r in res]}; latency per query "
                f"{[round(r.latency_s, 4) for r in res]} s (search "
                f"{[round(r.search_seconds, 4) for r in res]}, warmup "
                f"{[round(r.compile_seconds, 4) for r in res]}); "
                f"dispatches per count {disp}; executions "
                f"{out.engine.executions}, coalesced {out.engine.coalesced}"
                f"; cache searches={cs.n_searches} hits={cs.hits} "
                f"misses={cs.misses} persist_hits={cs.persist_hits} "
                f"preloads={cs.preloads} warmups={cs.n_compiles}; store "
                f"{out.engine.cache.store.stats.as_dict()}; K1 launches "
                f"{launches} on {card}")
            check(out.engine.coalesced == 1 and res[1].coalesced,
                  f"{what}: the isomorphic P1 was not coalesced")
            runs[what] = (out, launches, wall)
            del out
        cold = runs["cold serve"][0].engine.cache.stats
        check(cold.n_searches == 2, f"cold serve ran {cold.n_searches} "
              f"searches, not 2")
        lt = runs["restart, load-through"][0].engine.cache.stats
        check(lt.n_searches == 0 and lt.persist_hits >= 2,
              f"load-through restart: {lt.as_dict()}")
        wd = runs["restart, --warm-from-disk"][0].engine.cache.stats
        check(wd.n_searches == 0 and wd.preloads >= 2 and wd.misses == 0,
              f"warm-from-disk restart: {wd.as_dict()}")
        first = {w: r[0].results[0].latency_s for w, r in runs.items()}
        log(f"phase 14: first-query (P1) latency: "
            + ", ".join(f"{w} {s:.4f} s" for w, s in first.items())
            + f" on {card}")
        out_launches.update({f"level_expand.{k}":
                             runs["cold serve"][1][k]
                             for k in ("mask", "count", "signed")})
        runs.clear()

        warm_dir = os.path.join(tmp, "warmup")
        for what in ("plan_warmup", "plan_warmup again"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = plan_warmup.main(["--cache-dir", warm_dir,
                                       "--dataset", "tiny-er",
                                       "--device", DEVICE])
            lines = buf.getvalue().splitlines()
            check(rc == 0, f"{what} exited {rc}: {lines[-3:]}")
            log(f"phase 14: {what} P1-P6 x graphpi/graphzero x enum/iep on "
                f"tiny-er: {time.perf_counter() - t0:.3f}s; {lines[-1]} "
                f"on {card}")
        check(" 0 searches" in lines[-1],
              f"the plan_warmup rerun searched: {lines[-1]}")

        # ---- 3: the live graph at full size
        wiki = get_dataset(FRONT_WIKI)
        cfg = ExecutorConfig(capacity=WIKI_CAPACITY,
                             degree_buckets=auto_buckets(wiki))
        t0 = time.perf_counter()
        eng = QueryEngine(wiki, cfg=cfg, live=True, chunk=FRONT_LIVE_CHUNK,
                          device=DEVICE)
        log(f"phase 14: live engine on {FRONT_WIKI}: window "
            f"{eng.live.window}, flat capacity {eng.live.flat_capacity}, "
            f"triangles {eng.stats.tri_cnt}, built in "
            f"{time.perf_counter() - t0:.3f}s")
        check(eng.stats.tri_cnt == WIKI_TRIANGLES,
              f"live triangles {eng.stats.tri_cnt}")

        def live_count(what, pattern):
            ticket = eng.enqueue(QueryRequest(pattern))
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            dispatches = 0
            while not ticket.done:
                eng.run_pending()
                dispatches += eng.last_round_dispatches
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.launches)
            entry = next(e for e in eng.cache.entries()
                         if e.canon_key == ticket.result.canon_key)
            check_launches(f"live {what}", launches, entry.plan,
                           dispatches > 0)
            check_compact(f"live {what}", launches)
            rebuilt = GraphCSR.from_edges(
                wiki.n, eng.live.materialize_edges(), name="rebuilt")
            scratch, s_wall, s_disp, _, _ = count_on(
                f"{what} from scratch", rebuilt, entry.plan,
                ExecutorConfig(capacity=WIKI_CAPACITY,
                               degree_buckets=auto_buckets(rebuilt)),
                device_graph(rebuilt, "cuda"))
            got = ticket.result.count
            check(got == scratch, f"live {what}: {got} != from-scratch "
                  f"{scratch}")
            m = eng._maintainer.counters()
            log(f"phase 14: live {what}: count={got} (from scratch "
                f"{scratch}); live recount {wall:.3f}s in {dispatches} "
                f"dispatches, from-scratch count {s_wall:.3f}s in "
                f"{s_disp} dispatches; epoch {eng.live.edge_epoch}, "
                f"|E|={rebuilt.m}, overlay {eng.live.overlay_edges()} "
                f"edges, compactions {eng.live.compactions}; maintainer "
                f"{m}; rebinds {eng.matcher_rebinds}, rebuilds "
                f"{eng.matcher_rebuilds}; K1 launches {launches} on {card}")
            return got

        tri = get_pattern("triangle")
        live_count("triangles, epoch 0", tri)
        searches = eng.cache.stats.n_searches
        for epoch in (1, 2):
            cur = eng.live.materialize_edges()
            present = set(map(tuple, cur.tolist()))
            ins = set()
            while len(ins) < FRONT_LIVE_BATCH:
                u, v = sorted(int(x) for x in rng.integers(0, wiki.n, 2))
                if u != v and (u, v) not in present:
                    ins.add((u, v))
            dels = cur[rng.choice(len(cur), FRONT_LIVE_BATCH, replace=False)]
            eng.request_mutation("insert_edges", sorted(ins))
            eng.request_mutation("delete_edges", dels.tolist())
            t0 = time.perf_counter()
            eng.run_pending()           # applies the batches: no tickets
            log(f"phase 14: live epoch {epoch}: {FRONT_LIVE_BATCH} inserts "
                f"+ {FRONT_LIVE_BATCH} deletes applied and swapped in "
                f"{time.perf_counter() - t0:.3f}s")
            live_count(f"triangles, epoch {epoch}", tri)
        eng.request_mutation("compact")
        live_count("triangles after compact", tri)
        check(eng.cache.stats.n_searches == searches,
              f"live mutations re-searched: {eng.cache.stats.n_searches} "
              f"!= {searches}")
        live_count("P1 after compact", get_pattern("P1"))
        check(eng.cache.stats.n_searches == searches + 1,
              "P1 searched more than once")
        check(eng.matcher_rebinds > 0, "no epoch swap was a rebind")
        if eng.matcher_rebuilds:
            log(f"phase 14: live: {eng.matcher_rebuilds} matcher rebuilds: "
                f"the overlay grew its fixed shapes {eng.live.resizes} "
                f"times (window {eng.live.window}, flat capacity "
                f"{eng.live.flat_capacity})")
        check(eng.matcher_rebuilds == 0 or eng.live.resizes > 0,
              "a matcher was rebuilt without the overlay growing")
        del eng

        # ---- 4: the RPC front door, small-rmat, a server process and
        # two client processes, one after the other (two tenants)
        small = get_dataset(FRONT_SMALL)
        edges = set(map(tuple, small.edge_array().tolist()))
        ins = set()
        while len(ins) < 16:
            u, v = sorted(int(x) for x in rng.integers(0, small.n, 2))
            if u != v and (u, v) not in edges:
                ins.add((u, v))
        queries = [{"pattern": "P1"}, {"pattern": "P2"},
                   {"pattern": "triangle"}]
        trace = queries + [{"mutate": "insert_edges",
                            "edges": [list(e) for e in sorted(ins)]}] + queries
        trace_path = os.path.join(tmp, "trace.jsonl")
        with open(trace_path, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in trace)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        port_file = os.path.join(tmp, "port")
        server_log = os.path.join(tmp, "server.log")
        t0 = time.perf_counter()
        with open(server_log, "w") as slog:
            server = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.gateway",
                 "--no-lm", "--dataset", FRONT_SMALL, "--live",
                 "--listen", "0", "--port-file", port_file,
                 "--device", DEVICE], cwd=ROOT, env=env, stdout=slog,
                stderr=subprocess.STDOUT)
        try:
            while not os.path.exists(port_file):
                check(server.poll() is None, "RPC server exited: "
                      + open(server_log).read()[-2000:])
                check(time.perf_counter() - t0 < 300, "RPC server never "
                      "wrote its port file")
                time.sleep(0.2)
            host, port = open(port_file).read().split()
            log(f"phase 14: RPC server up on {host}:{port} in "
                f"{time.perf_counter() - t0:.3f}s")

            def client(tenant, *extra):
                t0 = time.perf_counter()
                done = subprocess.run(
                    [sys.executable, "-m", "repro_torch.serve.rpc",
                     "--connect", f"{host}:{port}", "--requests",
                     trace_path, "--tenant", tenant, *extra],
                    cwd=ROOT, env=env, capture_output=True, text=True,
                    timeout=600)
                check(done.returncode == 0, f"client {tenant} exited "
                      f"{done.returncode}: {done.stdout[-2000:]} "
                      f"{done.stderr[-2000:]}")
                counts = [int(line.split("count=")[1].split()[0])
                          for line in done.stdout.splitlines()
                          if " count=" in line]
                log(f"phase 14: RPC client {tenant}: {counts} in "
                    f"{time.perf_counter() - t0:.3f}s")
                return counts

            got = client("a")
            cl = RPCClient(host, int(port), tenant="probe", timeout=120.0)
            try:
                t0 = time.perf_counter()
                for _ in range(20):
                    cl.poll(0)
                poll_ms = (time.perf_counter() - t0) / 20 * 1e3
                cl.result(cl.submit({"pattern": "triangle"}))
                t0 = time.perf_counter()
                for _ in range(20):
                    memo = cl.result(cl.submit({"pattern": "triangle"}))
                query_ms = (time.perf_counter() - t0) / 20 * 1e3
            finally:
                cl.close()
            log(f"phase 14: RPC round trip: poll {poll_ms:.3f} ms, submit "
                f"+ result of a memoized triangle count {query_ms:.3f} ms "
                f"(count {memo['count']}) on {card}")
            got += client("b", "--shutdown")
            rc = server.wait(timeout=120)
            check(rc == 0, f"RPC server exited {rc}: "
                  + open(server_log).read()[-2000:])
        finally:
            if server.poll() is None:
                server.kill()
                server.wait(timeout=60)
        direct = QueryEngine(small, cfg=ExecutorConfig(), live=True,
                             device=DEVICE)
        want = []
        for spec in trace + trace:
            if "mutate" in spec:
                direct.request_mutation(spec["mutate"], spec["edges"])
                continue
            ticket = direct.enqueue(QueryRequest(get_pattern(spec["pattern"])))
            while not ticket.done:
                direct.run_pending()
            want.append(ticket.result.count)
        check(got == want, f"RPC counts {got} != the direct engine's {want}")
        check(want[:3] != want[3:6], "the mutation changed no count")
        check(want[0] == RESULTS["small-rmat P1"],
              f"small-rmat P1 {want[0]} != {RESULTS['small-rmat P1']}")
        log(f"phase 14: RPC: {len(got)} tickets over two tenants equal the "
            f"direct engine's over the same epochs")
        p2 = want[1]
        del direct

        # ---- 5: graph + LM through launch.gateway, then launch.serve
        L = get_config(ARCH).n_layers
        argv = ["--dataset", FRONT_SMALL, "--workload", "smoke",
                "--full-lm"] + FRONT_LM_ARGV
        with PhaseLaunches() as rec:
            t0 = time.perf_counter()
            out = gateway.run(gateway.parse_args(argv),
                              log=lambda line: log(f"phase 14: {line}"))
            wall = time.perf_counter() - t0
        check(out.rc == 0, f"graph + LM gateway exited {out.rc}")
        check([r.count for r in out.results]
              == [RESULTS["small-rmat P1"]] * 2 + [p2] * 2,
              f"graph + LM counts {[r.count for r in out.results]}")
        check(rec.records[0] == ("prefill", L)
              and all(r == ("decode", 0) for r in rec.records[1:])
              and rec.variants[0] == {"scalar": 0, "wgmma": L},
              f"graph + LM: K4 launches per phase {rec.records}, per "
              f"kernel {rec.variants}")
        mixed = out.session.tokens_out()
        m_mixed = out.session.metrics()
        rep = out.gateway.report()
        del out
        rec.sessions.clear()
        with PhaseLaunches() as rec:
            check(serve.main(FRONT_LM_ARGV) == 0, "serve.main failed")
        solo = rec.sessions[0]
        check(rec.records[0] == ("prefill", L), f"serve.main: K4 launches "
              f"{rec.records}")
        check(mixed.shape == (2, 9) and (mixed == solo.tokens_out()).all(),
              "graph + LM tokens differ from launch.serve's")
        m_solo = solo.metrics()
        rec.sessions.clear()
        del solo
        out_launches["flash_attention"] = L
        for name, wr in rep["workloads"].items():
            tm = wr["turn_item_ms"]
            log(f"phase 14: graph + LM: {name} per-item turn p50 "
                + ", ".join(f"{b} {tm[b]['p50_ms']:.3f} ms (n={tm[b]['n']})"
                            for b in ("solo", "contended"))
                + f" on {card}")
        log(f"phase 14: graph + LM in {wall:.3f}s: tokens equal "
            f"launch.serve's; decode {m_mixed['ms_per_step']:.3f} ms/step "
            f"beside the graph tenant, {m_solo['ms_per_step']:.3f} alone; "
            f"prefill {m_mixed['prefill_seconds']:.4f} s / "
            f"{m_solo['prefill_seconds']:.4f} s; K4 launches per prefill "
            f"{L}, all wgmma, on {card}")
    log(f"phase 14: front door checks in {time.perf_counter() - t_phase:.1f}s")
    return out_launches


def ptxas_summary(log_text: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) for each
    entry function of an `nvcc -Xptxas -v` log; names demangled by
    `c++filt` where the machine has it, without their parameter lists."""
    import re
    import shutil
    import subprocess

    out, name, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            if shutil.which("c++filt"):
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True).stdout.strip() or name
            name = name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ").strip()
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), *spills))
            name = None
    return out


def build_kernels() -> None:
    """Phase 1: build K1, K2/K3 and K4 from the checkout's sources, one
    nvcc per source, all started together; print each build's time and
    each kernel's registers and spills (ptxas), and the compiler's notes
    on the wgmma kernel.  K4's wgmma kernel and the padded K2/K3 kernel
    must not spill."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import flash_attention, intersect, membership
    from repro_torch.kernels import nvcc

    kernels = (intersect, membership, flash_attention)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        libs = list(pool.map(lambda k: k.build(), kernels))
    for k in kernels:
        k.load()
    log(f"phase 1: built {', '.join(os.path.relpath(lib, ROOT) for lib in libs)}"
        f" in {time.perf_counter() - t0:.2f}s")
    for src in (k.SOURCE for k in kernels):
        if src.name not in nvcc.build_logs:
            log(f"phase 1: {src.name}: library found, not rebuilt")
            continue
        text = nvcc.build_logs[src.name]
        log(f"phase 1: nvcc {src.name}: {nvcc.build_seconds[src.name]:.2f}s")
        for name, regs, st, ld in ptxas_summary(text):
            log(f"phase 1: ptxas {src.name} {name}: {regs} registers, "
                f"spill stores {st} B, spill loads {ld} B")
            if "wgmma::" in name or "membership_padded_kernel" in name:
                check(st == ld == 0, f"{name} spills ({st} / {ld} bytes)")
        for line in text.splitlines():
            if ("wgmma" in line and "C75" in line) or "arning" in line:
                log(f"phase 1: compiler note: {line.strip()[:160]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[smoke] FAIL: torch.cuda.is_available() is False",
              flush=True)
        return 1
    from repro_torch.device import gpu_report

    t_all = time.perf_counter()
    card = gpu_report()
    log(f"phase 1: card: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    build_kernels()
    kernels = graph_phases(card) + lm_phases(card)
    kernels[4:4] = membership_phases(card)      # K1, K2, K3, K4
    for k in kernels:
        if k["name"] == "level_expand.window":
            k["launches"] = RESULTS["K1 window launches"]
    engine_phase(card)
    front = front_door_phase(card)
    for k in kernels:
        k["front_door_launches"] = front.get(k["name"])
    log(f"done in {time.perf_counter() - t_all:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
