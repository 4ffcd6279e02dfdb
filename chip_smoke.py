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
    graphpi plan and the graphzero plan with its IEP tail; both paths
    on the roots v0 ∈ [96, 112),
    and that slice on the kernel path under torch.profiler with the
    graphpi and the graphzero IEP plans (device kernel time against
    unprofiled wall, K1's time per kernel, top kernels; the
    gathered-window kernel must not run there), then under the graphpi
    plan with the mask levels run by the composition the
    mask-and-compact entry replaced and by the entry, alternated, in
    one process (`k1_mask_walls`).  Then small-rmat: P1 under
    the graphpi, graphzero and naive plans (÷ |Aut|), enum and IEP, on
    the kernel path, and on the portable path under the graphpi plan
    and the graphzero IEP plan;
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
    (6, 3, 1000, 777, 128) and a bidirectional (8, 8, 2048, 2048, 64),
    then the other LM families' prefill shapes (`FAMILY_K4`:
    granite-moe causal hd 64 with G = 2, whisper causal and
    bidirectional hd 64, jamba G = 4 and qwen2-vl G = 8, hd 128), then
    each rank's shapes under tensor parallelism (`TP_K4`: qwen2-vl G =
    8, jamba G = 4, granite-34b 24 over 1, whisper hd 64 at a model
    axis of 2, qwen2-vl 16 over 2 at 4), then minitron-4b's G = 3
    (`WHOLE_K4`: 24 query heads over 8 KV heads, hd 128, one 2,048-token
    sequence, and phase 22's rank shape, 2 rows of 1,024);
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
    share of the card's bound; then the same (no scalar kernel) at each
    of the other families' shapes (`FAMILY_K4`) and at minitron-4b's
    G = 3 (`WHOLE_K4`).

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
15. multi-GPU counting (`ShardedMatcher`, one process per GPU under
    `torch.distributed`): one rank under NCCL through
    `count_embeddings_sharded` on small-rmat (the triangle and P1); then
    `torchrun` with 2 and with 4 ranks sharing the card under gloo (the
    backend rule of `launch/mesh.py`), through `launch.mine` (the
    triangle, at 2 ranks) and `launch.query_serve` (the triangle, P1 and an
    isomorphic P1 coalesced with it, whole P1 at the stripe chunk
    `SHARD_P1_CHUNK`) on wiki-vote-syn from capacity 2^20; where the
    machine has more than one card, both launchers again with a card per
    rank under NCCL.  Each run checks the backend, the counts against phase
    4's single-device values, every rank's exit code (torchrun's) and
    that every rank launched K1 in exactly the plans' modes, and prints
    each rank's wall before the reductions, its K1 launches and the
    balance, max over mean rank wall.
16. the gateway's sharded graph tenant and the static verifier:
    `torchrun` with 2 ranks sharing the card (gloo) of
    `launch.gateway --no-lm --listen 0 --model-buckets` on
    wiki-vote-syn, rank 0 fronting the RPC server and broadcasting each
    round to rank 1 (`serve/spmd.py`); this process pipelines the
    triangle, P1, an isomorphic P1 (coalesced with it) and the triangle
    under the graphzero IEP plan to rank 0 (`RPCClient.submit_many`),
    holds the counts to phases 4 and 15's and shuts the server down;
    every rank must exit 0 and launch K1 in mask, count and signed mode
    (with more cards, the same under NCCL, a card per rank).  Beside it
    on the host, `python -m repro_torch.analysis` (every pass) and its
    deep kernel-contract pass over wiki-vote-syn's buckets must exit 0.
    The Python mirror of K1's limits must equal the library's exports,
    and a call one past them (P = 17, 17 comparisons), which the static
    pass flags, must be refused on the card with an error by the
    kernels' launchers and the wrapper.  `examples/torch_quickstart.py`
    and `examples/torch_motif_counting_iep.py` run on the card, each
    count equal to the oracle's.
17. the other LM families through `repro_torch.launch.serve.main` on
    the card (`FAMILY_RUNS`; batch 4, a 2,048-token prompt, 16 tokens,
    random weights from seed 0, bf16): granite-moe-1b-a400m at full
    size (24 layers, 32 experts top-8), mamba2-370m and whisper-base at
    full size, jamba-v0.1-52b at full width cut to 8 layers (one
    superblock) and qwen2-vl-72b at full width cut to 4 (a single card
    does not hold either whole).  Each must launch K4 once per
    flash-eligible attention call of its prefill (24 / 0 / 18 / 1 / 4),
    all of the wgmma kernel, and none in decode; its kernel-path prefill
    logits must lie within phase 8's limits of the plain path's
    (`flash=False`) on the same weights and prompts, printed beside the
    plain path's distance from the same path with attention in fp32
    (the rounding noise floor) and, for MoE layers, the tokens routed
    to another expert set; its first greedy tokens must equal the
    served run's (printed beside the plain path's, with the plain
    path's top-2 gaps), and a second granite-moe prefill must be
    bit-equal (logits and K/V).  Each prints its served
    prefill s, decode ms/step and peak memory, and a torch.profiler
    window over one prefill and 4 decode steps (busy share, top
    kernels).
18. LM training through `repro_torch.launch.train.main` on the card
    (random weights from seed 0, fp32 masters, bf16 compute, remat on,
    batch 4 x 1,024, no checkpoint at full size): qwen3-1.7b whole
    (28 layers, 2.03e9 parameters) for 8 steps at --lr 3e-5 (`TRAIN_LR`
    says why), then granite-moe-1b-a400m and whisper-base whole for 3
    steps and mamba2-370m whole for 8, at the launcher's default rate;
    every loss and grad norm finite, each run's last loss below its
    first, no K4 launch in any step (training attention is plain
    PyTorch); each prints its step times, steady s/step and tok/s and
    peak memory, and qwen3-1.7b one more step under torch.profiler
    (busy share, launches, top kernels).  Then the gradient at full
    size: qwen3-1.7b whole in fp32, the loss's slope along the
    normalized gradient equal to -|g| within 1%; qwen3-1.7b at full
    width cut to 2 layers, one train step on the card against the
    port's CPU path from the same state (loss within 5e-3 and grad norm
    within 2e-2, beside the card's bf16 vs fp32 distance, the noise
    floor); and
    the smoke config's resume on the card, 4 + 4 steps against 8 under
    deterministic algorithms, within the reference's tolerance (rtol
    2e-5 / atol 2e-6).
19. tensor-parallel LM serving: one torchrun of 2 ranks sharing the
    card (gloo) at `--model-axis 2`, each rank serving, through
    `repro_torch.launch.serve.main` in the launch's group, qwen2-vl-72b
    at full width cut to 4 layers, jamba-v0.1-52b cut to 8,
    granite-34b cut to 8 (its one KV head: the decode cache splits its
    sequence) and whisper-base whole (batch 4, a 2,048-token prompt,
    16 tokens, seed 0, bf16); every rank launches K4 4 / 1 / 8 / 18
    times a prefill, all wgmma, none in decode, and takes the same
    tokens; each run's TP prefill logits lie within phase 8's limits of
    the one-device kernel path's (phase 17's for jamba and qwen2-vl,
    made here for the others; printed beside the plain path's fp32
    noise floor), and the first tokens agree wherever the one-device
    top-2 gap exceeds that distance; per rank its prefill s, decode
    ms/step and peak memory.  With 4 or more cards, qwen2-vl-72b whole
    at `--model-axis 4` under NCCL (a card per rank), 80 K4 launches a
    rank; with fewer, a line saying it was skipped.
20. sharded LM training through `repro_torch.launch.train --model-axis`
    (`TP_TRAIN_RUNS`, each rank in `tp_train_child`; batch 4 x 1,024,
    remat, bf16, seed 0): launch A, 2 ranks sharing the card (gloo) at
    model 2, trains qwen3-1.7b whole 3 steps (lr 3e-5), then
    whisper-base whole 2 steps checkpointed and step 3 resumed at model
    2, while this process resumes the checkpoint's copy on one device;
    launch B, 4 ranks at data 2 x model 2 (ZeRO-3), granite-moe whole 2
    steps, at the same time as launch A.  Every rank's metrics equal
    and finite; qwen3's and
    granite-moe's first steps within phase 18's limits (5e-3 / 2e-2) of
    phase 18's one-device first step, whisper's one-device step 3
    within them of the model-2 run's; per rank s/step, peak memory and
    a step's collectives by kind and bytes.  With 4 or more cards,
    jamba-v0.1-52b cut to 8 layers at model 4 and qwen2-vl-72b cut to 4
    at data 2 x model 2, 2 steps each under NCCL (a card per rank);
    with fewer, a line saying it was skipped.
21. the dry-run (`repro_torch.launch.dryrun.run_cell`, as `python -m
    repro_torch.launch.dryrun` runs it; `DRYRUN_CELLS`): the graph cell
    (house on rmat(16, 12), rank 0's stripe of 16 at capacity 2^15)
    counted on the card under the op walk, its K1 launches equal to the
    kernel calls the walk recorded and its count and `max_needed` equal
    to a count of the same stripe on one device; then qwen3-1.7b
    train_4k, granite-moe-1b-a400m prefill_32k (MoE and K4),
    jamba-v0.1-52b long_500k on the one-pod grid, qwen2-vl-72b
    train_4k on the two-pod grid, whisper-base prefill_32k on the
    one-pod grid ('dp_replicated') and minitron-4b train_4k on the
    two-pod grid ('tp2d', its 24 heads whole over the model axis of
    16), each one rank's step on meta tensors under a fake process
    group of 256 / 512 ranks: no launch, K4 recorded once per
    flash-eligible call of a prefill (24; 18).  Each cell's roofline
    terms print on a line of their own; the phase must take less than
    90 s.
22. attention whole on every model rank (`WHOLE_RUNS`, each rank in
    `whole_child`, one torchrun of ranks sharing the card under gloo
    per run, bf16, seed 0): whisper-base whole at `--model-axis 3` on 3
    ranks ('dp_replicated': the whole model and 2 rows of a batch of 6
    a rank; a 2,048-token prompt, 16 tokens, then 2 train steps of 6 x
    1,024) and minitron-4b at full width cut to 2 layers at
    `--model-axis 16` on 16 ranks ('tp2d' with its 24 heads whole on
    every rank; a batch of 2, a 1,024-token prompt, 4 tokens, a cache
    whose sequence splits over the ranks, then one train step of 2 x
    512); every rank launches K4 18 / 2 times a prefill, all wgmma,
    none in decode or training, and takes the same tokens; the prefill
    logits lie within phase 8's limits of the one-device kernel path's
    (made in this process first), the first tokens agree wherever the
    one-device top-2 gap exceeds that distance, the first train step
    lies within phase 18's limits of one device's, every rank's step
    metrics are equal; per rank its rows, prefill s, decode ms/step,
    peak memory and the prefill's and a step's collectives by kind;
    the phase must take less than 150 s.

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
each prefill and decode call, 28 per prefill and none in decode; in
phase 15 K1's, around the one-rank counts and around each rank's serve
(the launchers' own records), exactly the plans' modes in every rank;
in phase 16, each gateway rank's records, mask, count and signed; in
phase 17 K4's, around each family's prefill and decode calls and each
prefill compared, the family's flash-eligible calls per prefill; in
phase 18 K4's, around each train step, none; in phase 19 each rank's
K4 counters, around its served prefill and decode calls, its
flash-eligible calls per prefill and none in decode; in phase 20 each
rank's K4 counters, around each train step, none; in phase 21 K1's,
around the graph cell, equal to the walk's kernel calls, and none
around each LM cell on meta; in phase 22 each rank's K4 counters,
around its served prefill and decode calls and each train step, its
flash-eligible calls per prefill and none otherwise.

Counts are integers and every comparison of phases 2–6 and 10–16 is
exact (no tolerance).  The last two lines are the kernels record (K1's
three modes and its gathered-window entry, K2 and K3 with the first
version's time as `linear_ms`, K4 with its kernel `variant` and
`tflops`; `front_door_launches`: K1's launches per mode in phase 14's
cold serve and K4's per prefill of its graph + LM run;
`sharded_launches`: K1's launches per rank in phase 15's query_serve
runs; `gateway_sharded_launches`: the same in phase 16's gateway; K4's
`family_launches`: its launches per prefill of each phase 17 family,
`family_shapes`: phase 9's times at the families' shapes,
`train_launches`: its launches in phase 18's train steps, 0,
`train_launches_per_step` by arch, `tp_launches`: its launches per
rank per prefill in phase 19, by arch, and `tp_train_launches`: its
launches per rank per step in phase 20, by run; K1's `dryrun_launches`:
its launches per mode in phase 21's graph cell; K4's
`dryrun_meta_calls`: its calls on meta per LM cell of phase 21, and
`whole_launches`: its launches per rank per prefill in phase 22, by
run) and
the device record (JSON).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# The kernels' bounds (bytes over HBM's rate against operations over the
# type's peak), shared with the dry-run's roofline.
from repro_torch.roofline.kernels import (bound_of, k4_bound,  # noqa: E402
                                          membership_bound, rows_bound_of)

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
        window=a["window"], written=written)[:2]
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
                                 ok, False, a["window"])[:2]
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
    bound_ms, bound_by = rows_bound_of(*args, **kw)[:2]
    P, B = starts.shape
    Q = 0 if neg is None else neg.shape[1]
    group = intersect.load().level_rows_group(kw["width"])
    return {"what": f"B={B} width={kw['width']} P={P} Q={Q} "
                    f"E={len(kw['dirs'])} group={group}",
            "ms": ms, "composition_ms": comp_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
# The other LM families' prefill shapes at batch 4 and a 2,048-token
# prompt (phase 17), with their mask and K4 launches per prefill:
# granite-moe-1b-a400m (16 query heads over 8 KV heads, hd 64; G = 2),
# whisper-base (8 over 8, hd 64: the decoder's self-attention causal,
# the encoder's and the cross-attention bidirectional), jamba-v0.1-52b
# (32 over 8, hd 128; G = 4; its one attention layer of the 8 served)
# and qwen2-vl-72b (64 over 8, hd 128; G = 8; 4 layers served).
FAMILY_K4 = [("granite-moe-1b-a400m", (64, 32, 2048, 2048, 64), True, 24),
             ("whisper-base", (32, 32, 2048, 2048, 64), True, 6),
             ("whisper-base", (32, 32, 2048, 2048, 64), False, 12),
             ("jamba-v0.1-52b", (128, 32, 2048, 2048, 128), True, 1),
             ("qwen2-vl-72b", (256, 32, 2048, 2048, 128), True, 4)]
WGMMA_CASES += [(shape, causal) for _, shape, causal, _ in FAMILY_K4]
# Each rank's prefill shapes under tensor parallelism (phase 19, batch 4,
# a 2,048-token prompt): at a model axis of 2, qwen2-vl-72b's 32 query
# heads over 4 KV heads (G = 8), jamba-v0.1-52b's 16 over 4 (G = 4),
# granite-34b's 24 over its one KV head (G = 24: the KV heads do not
# divide the axis, so a rank keeps it whole) and whisper-base's 4 over
# 4 (hd 64, causal and bidirectional); at 4, qwen2-vl-72b's 16 over 2.
TP_K4 = [((128, 16, 2048, 2048, 128), True), ((64, 16, 2048, 2048, 128), True),
         ((96, 4, 2048, 2048, 128), True), ((16, 16, 2048, 2048, 64), True),
         ((16, 16, 2048, 2048, 64), False), ((64, 8, 2048, 2048, 128), True)]
WGMMA_CASES += TP_K4
# Attention whole on every model rank (phase 22): minitron-4b's 24 query
# heads over 8 KV heads (G = 3, hd 128), one 2,048-token sequence (phase
# 9 times it), and each rank's shape in phase 22 (2 rows of 1,024); and
# whisper-base's 2 rows a rank of phase 22's batch of 6 at 'dp_replicated'
# (8 over 8, hd 64: TP_K4's shape at 2 x 8 heads).
WHOLE_K4 = [("minitron-4b", (24, 8, 2048, 2048, 128), True, 32)]
WGMMA_CASES += [(shape, causal) for _, shape, causal, _ in WHOLE_K4]
WGMMA_CASES += [((48, 16, 1024, 1024, 128), True)]
# The reference's own tolerances (tests/test_flash_kernel.py:39).
FLASH_ATOL = {"bfloat16": 3e-2, "float32": 2e-5}


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
    # the graphpi mode, enum and IEP (graphpi folds no tail here, so its
    # IEP plan is its enum plan), and the graphzero IEP plan.  The
    # graphzero enum plan (~45 s here; its inner levels are its IEP
    # plan's) and the naive plan (~40 s) are counted on small-rmat below
    # only, so the script keeps under its time limit with phase 20.
    # The graphpi count is the named run whose mask and count launches
    # the kernels line reports, the graphzero IEP count the one for
    # signed; phase 6 times the largest launch of each.
    named = {("graphpi", False): ("mask", "count"),
             ("graphzero", True): ("signed",)}
    main_launches, recorders, plans = {}, [], set()
    for mode, iep in (("graphpi", False), ("graphpi", True),
                      ("graphzero", True)):
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
            what, wiki, plan, cfgs["kernel"], arrays, during=recorder)
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
    # ---- 4b: small-rmat, every P1 plan gives one count: on the kernel
    # path, and on the portable path (~10 s a plan) under the graphpi
    # plan and the graphzero IEP plan, whose folded tail is the
    # portable path's other branch
    small = get_dataset("small-rmat")
    sarrays = device_graph(small, "cuda")
    scfgs = {path: ExecutorConfig(capacity=1 << 15,
                                  degree_buckets=auto_buckets(small),
                                  use_kernel=path == "kernel")
             for path in ("kernel", "portable")}
    sstats, _, _ = stats_on("small-rmat compute_stats kernel", small,
                            scfgs["kernel"], sarrays)
    RESULTS["small-rmat triangles"] = sstats.tri_cnt
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
                if path == "portable" and (mode, iep) not in (
                        ("graphpi", False), ("graphzero", True)):
                    continue
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
            if session.device.type == "cuda":
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


def check_launches_k4(what, rec, want, phase="phase 8") -> None:
    """`rec` (a PhaseLaunches) saw the phases and K4 launches `want`, and
    every launch was of the wgmma kernel (bf16, hd 64 or 128)."""
    log(f"{phase}: {what}: K4 launches per phase {rec.records}; per "
        f"kernel {rec.variants}")
    check(rec.records == want, f"{what}: K4 launches {rec.records} != {want}")
    check(rec.variants == [{"scalar": 0, "wgmma": n} for _, n in want],
          f"{what}: K4 kernels {rec.variants}: the scalar one ran")


def profile_serving(session, cfg, batch, card, decode=None, top=8,
                    label="profile") -> None:
    """One kernel-path batch prefill and 4 decode steps of
    `session` (`decode`: a callable running them, by default the
    session's own next 4), each run once unprofiled (host clock, ending
    in a synchronize) and once under torch.profiler.  Prints the device
    kernels' summed time against the unprofiled wall time (the busy
    share; the profiler's own overhead inflates its window) and the
    `top` kernels that took the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.serve_step import make_prefill

    prefill = make_prefill(cfg, DEVICE, q_chunk=0)
    if decode is None:
        def decode():
            session.decode_steps(4)
    for what, fn in (("prefill", lambda: prefill(session._params, batch)),
                     ("decode x4", decode)):
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
        log(f"{label} {what}: device kernels {busy_ms:.3f} ms in "
            f"{sum(e.count for e in kern)} launches; unprofiled wall "
            f"{wall_ms:.3f} ms; busy share {100 * busy_ms / wall_ms:.1f}% "
            f"on {card}")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
            log(f"{label} {what}:   {e.self_device_time_total / 1e3:9.3f} "
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


def time_k4_case(shape, causal, seed, batch=4, iters=50):
    """K4's wgmma kernel, its plain version and PyTorch's
    `scaled_dot_product_attention` (the rows viewed as `batch` sequences
    of BH / batch heads, `enable_gqa`) on the same bf16 tensors, with
    CUDA events (3 warm-up launches, then `iters` timed; 5 for the plain
    version), beside the bound.  Returns the tensors and the record."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref

    BH, BK, S, _, hd = shape
    q, k, v = flash_inputs(shape, torch.bfloat16, seed)
    got = flash_attention_cuda(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    err = flash_err(got, want)
    ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal),
                 iters=iters)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=causal),
                       iters=5)
    q4, k4, v4 = (t.view(batch, t.shape[0] // batch, S, hd)
                  for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                          enable_gqa=True)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal, enable_gqa=True), iters=iters)
    bound_ms, bound_by, flops, nbytes = k4_bound(shape, causal)
    rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "tflops": flops / ms / 1e9, "max_abs_err": err,
           "sdpa_err": flash_err(got.view(sdpa.shape), sdpa),
           "flops": flops, "bytes": nbytes}
    return (q, k, v, want), rec


def time_k4(card, errs) -> dict:
    """Phase 9: at the serving shape, in one process and on the same
    tensors: K4's wgmma kernel (the serving path), the scalar kernel's
    bf16 instantiation (the design it replaced), the plain version and
    PyTorch's `scaled_dot_product_attention` (the library yardstick; the
    port never calls it), with CUDA events (3 warm-up launches, then 50
    timed; 20 for the scalar kernel, 5 for the plain version), beside the
    card's bound; then the same for each of `FAMILY_K4`'s shapes (no
    scalar kernel)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    BH, BK, S, _, hd = SERVE_ROWS
    (q, k, v, want), rec = time_k4_case(SERVE_ROWS, True, 7)
    errs.append(rec["max_abs_err"])
    old = flash_attention_cuda(q, k, v, causal=True, variant="scalar")
    old_err = flash_err(old, want)
    scalar_ms = time_ms(lambda: flash_attention_cuda(
        q, k, v, causal=True, variant="scalar"))
    ms, library_ms, bound_ms = rec["ms"], rec["library_ms"], rec["bound_ms"]
    log(f"phase 9: K4 q [{BH}, {S}, {hd}] k/v [{BK}, {S}, {hd}] bf16 "
        f"causal: wgmma ms={ms:.4f} ({rec['tflops']:.1f} TFLOP/s, "
        f"{100 * bound_ms / ms:.1f}% of the bound) scalar_ms="
        f"{scalar_ms:.4f} ({rec['flops'] / scalar_ms / 1e9:.1f} TFLOP/s) "
        f"plain_ms={rec['plain_ms']:.4f} sdpa_ms={library_ms:.4f} "
        f"({rec['flops'] / library_ms / 1e9:.1f} TFLOP/s) bound_ms="
        f"{bound_ms:.4f} ({rec['bound_by']}: {rec['flops']:.3e} FLOP, "
        f"{rec['bytes'] / 1e9:.4f} GB); wgmma/sdpa {ms / library_ms:.2f}x, "
        f"scalar/wgmma {scalar_ms / ms:.1f}x; max_abs vs plain wgmma="
        f"{errs[-1]:.3e} scalar={old_err:.3e}, wgmma vs sdpa "
        f"{rec['sdpa_err']:.3e} on {card}")
    check(old_err <= FLASH_ATOL["bfloat16"],
          f"scalar K4 max_abs_err {old_err:.3e}")
    families = []
    for i, (arch, shape, causal, per_prefill) in enumerate(FAMILY_K4
                                                           + WHOLE_K4):
        _, frec = time_k4_case(shape, causal, 70 + i)
        errs.append(frec["max_abs_err"])
        check(frec["max_abs_err"] <= FLASH_ATOL["bfloat16"],
              f"K4 {arch} {shape}: max_abs_err {frec['max_abs_err']:.3e}")
        log(f"phase 9: K4 {arch} q [{shape[0]}, {shape[2]}, {shape[4]}] "
            f"k/v [{shape[1]}, {shape[3]}, {shape[4]}] bf16 "
            f"{'causal' if causal else 'bidir'} ({per_prefill} per prefill)"
            f": wgmma ms={frec['ms']:.4f} ({frec['tflops']:.1f} TFLOP/s, "
            f"{100 * frec['bound_ms'] / frec['ms']:.1f}% of the bound) "
            f"plain_ms={frec['plain_ms']:.4f} sdpa_ms="
            f"{frec['library_ms']:.4f} bound_ms={frec['bound_ms']:.4f} "
            f"({frec['bound_by']}); wgmma/sdpa "
            f"{frec['ms'] / frec['library_ms']:.2f}x; max_abs vs plain "
            f"{frec['max_abs_err']:.3e}, vs sdpa {frec['sdpa_err']:.3e} "
            f"on {card}")
        families.append({"arch": arch, "shape": list(shape),
                         "causal": causal, "per_prefill": per_prefill,
                         **{key: frec[key] for key in (
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "tflops", "max_abs_err")}})
    return {"ms": ms, "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
            "bound_by": rec["bound_by"], "library_ms": library_ms,
            "variant": "wgmma", "tflops": rec["tflops"],
            "family_shapes": families}


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


PROFILE_TRIES = 4


def device_ms(fn, names, iters=20):
    """Device time per launch of the kernels whose names contain one of
    `names`, from torch.profiler: `iters` calls of `fn` in a warm-up
    cycle, then `iters` in the recorded one, averaged over the launches
    the trace holds (returned with their count); with the events' time
    beside it, this tells the host's cost per call from the kernel's.
    A recorded trace once held a launch more than the cycle made (21
    for 20): only launches that start after the recorded cycle begins
    count, and any dropped is logged.  The profiler has delivered
    a recorded cycle without a single device event (1 of ~30 profiles
    on the card): such a cycle is profiled again, up to PROFILE_TRIES
    times in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    mark = "device_ms cycle"
    for tries in range(1, PROFILE_TRIES + 1):
        traced = []              # the recorded cycle's events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.extend(
                         p.events())) as prof:
            for _ in range(2):
                with record_function(mark):
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
                prof.step()
        # the trace can hold the warm-up cycle's mark too: the recorded
        # cycle is the last
        starts = [e.time_range.start for e in traced if e.name == mark]
        check(bool(starts), f"profile of {names}: no cycle traced")
        start = max(starts)
        ev = [e for e in traced
              if e.device_type == DeviceType.CUDA
              and any(n in e.name for n in names)]
        early = [e for e in ev if e.time_range.start < start]
        if early:
            log(f"phase 11: profile {tries} of {names}: dropped {len(early)} "
                f"launches that started before the recorded cycle")
        ev = [e for e in ev if e.time_range.start >= start]
        launches = len(ev)
        if launches:
            break
        log(f"phase 11: profile {tries} of {names} traced no launch")
    check(0 < launches <= iters, f"profiled {launches} launches of {names} "
          f"for {iters} calls in {tries} profiles")
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / launches, \
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
            bound_ms = membership_bound(B, D, L, count).ms
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
            bound_ms, bound_by = membership_bound(B, D, L, count)[:2]
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
                bound_ms = membership_bound(B, D, L, count, ragged=True).ms
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


# ------------------------------------------------------------ phase 15 --
SHARD_DATASET = "wiki-vote-syn"
SHARD_CAPACITY = 1 << 20
# Stripe chunks of the whole-P1 checks, from `shard_reckoning`.  The
# sharded matcher does not bisect: a chunk's frontier must fit the
# capacity (doubled by whole passes up to 2^28), and every chunk pays
# bookkeeping of the capacity's size (~38 ms at 2^26, ~75 at 2^27 on the
# card).  On wiki-vote-syn under the launchers' layout (no buckets)
# single roots need up to 1.6e6 rows and roots 0-511 hold most of P1, so
# at W = 2 a chunk of 64 roots (rank 0's first: 0, 2, ..., 126) needs at
# most 5.4e7 rows (2^26), and at W = 4 a chunk of 128 at most 6.7e7.
SHARD_P1_CHUNK = {2: 64, 3: 128, 4: 128}
SHARD_TIMEOUT_S = 300
RANK_LINE = (r"rank (\d+): wall=([\d.]+)s passes=(\d+) K1 launches "
             r"mask=(\d+) count=(\d+) signed=(\d+)")


def torchrun(what, world, module, argv, want, modes, backend):
    """One `torchrun --standalone --nproc-per-node world -m module argv`
    on the card, its processes in a session of their own (killed whole
    past SHARD_TIMEOUT_S).  Every rank must exit 0 (torchrun's code), the
    group's backend must be `backend`, the counts rank 0 prints `want`,
    and every rank must have launched K1 in exactly `modes`.  Returns
    the per-rank records (wall, passes, launches) and the run's wall."""
    import re
    import signal
    import subprocess

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(world), "-m", module, *argv]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=SHARD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        log(out[-4000:])
        check(False, f"{what}: no end in {SHARD_TIMEOUT_S}s")
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("[mine]", "[serve]", "[group]"))]
    for ln in lines:
        log(f"phase 15: {what}: {ln}")
    if proc.returncode != 0:
        log(out[-4000:])
    check(proc.returncode == 0, f"{what}: torchrun exited {proc.returncode}")
    m = re.search(r"\[group\] world=(\d+) backend=(\w+)", out)
    check(m is not None and (int(m.group(1)), m.group(2)) == (world, backend),
          f"{what}: group {m and m.groups()}, want {world} ranks on "
          f"{backend}")
    counts = [int(c) for c in re.findall(r"(?:\[mine\]|\]\s+\S+)\s+"
                                         r"count=(\d+)", out)]
    check(counts == want, f"{what}: counts {counts} != {want}")
    check("OVERFLOWED" not in out, f"{what}: a count overflowed")
    ranks = [dict(rank=int(r), wall=float(w), passes=int(p),
                  launches=dict(mask=int(a), count=int(b), signed=int(c)))
             for r, w, p, a, b, c in re.findall(RANK_LINE, out)]
    check([r["rank"] for r in ranks] == list(range(world)),
          f"{what}: rank lines {ranks}")
    for r in ranks:
        got = {k for k, v in r["launches"].items() if v}
        check(got == modes, f"{what}: rank {r['rank']} launched K1 in "
              f"{r['launches']}, but the plans need {sorted(modes)}")
    return ranks, wall


def shard_reckoning(card, roots=512, worlds=(2, 4),
                    chunks=(8, 16, 32, 64, 128, 256),
                    capacities=(20, 24, 26, 27, 28)) -> dict:
    """The reckoning behind `SHARD_P1_CHUNK` (not part of `main()`):
    P1's frontier demand (`needed`) and wall for each single root
    v0 < `roots` on wiki-vote-syn under the launchers' layout (no
    buckets, the kernel path) at capacity 2^28; from them an upper bound
    of each stripe chunk's demand (the sum of its roots') for rank d's
    first chunks at each world size and chunk; and the time of one
    all-sentinel chunk at each capacity (the per-chunk bookkeeping a
    sharded pass pays whatever its roots)."""
    import math

    import torch

    from repro_torch.configs.graphpi import get_dataset, get_pattern
    from repro_torch.core.executor import (ExecutorConfig, Matcher,
                                           compute_stats)
    from repro_torch.query.cache import plan_for

    wiki = get_dataset(SHARD_DATASET)
    stats = compute_stats(wiki, ExecutorConfig(capacity=SHARD_CAPACITY),
                          device="cuda")
    _, plan = plan_for(get_pattern("P1"), stats, mode="graphpi")
    cap = Matcher.MAX_CAPACITY
    m = Matcher(wiki, plan, ExecutorConfig(capacity=cap), device="cuda")
    fn, args = m._fn(cap), m._call_args()
    torch.cuda.reset_peak_memory_stats()
    needed, ms, raw = [], [], 0
    for r in range(roots):
        v0 = torch.tensor([r], dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cnt, nd = fn(*args, v0)
        needed.append(int(nd))
        raw += int(cnt)
        ms.append((time.perf_counter() - t0) * 1e3)
    log(f"shard reckoning: P1 single roots 0..{roots - 1} at capacity "
        f"2^{cap.bit_length() - 1}: needed max {max(needed):,} (root "
        f"{needed.index(max(needed))}), raw {raw:,} of {WIKI_P1:,}, "
        f"{sum(ms) / 1e3:.2f}s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    bounds = {}
    for world in worlds:
        for c in chunks:
            worst = max((sum(needed[d + world * (k * c + j)]
                             for j in range(c))
                         for d in range(world) for k in range(4)
                         if d + world * (k * c + c - 1) < roots),
                        default=None)
            if worst is None:
                continue                   # a chunk past the roots counted
            per = math.ceil(math.ceil(wiki.n / world) / c) * c
            bounds[(world, c)] = worst
            log(f"shard reckoning: W={world} chunk={c}: {per // c} chunks "
                f"per rank, first chunks need at most {worst:,} rows "
                f"(capacity 2^{max(20, (worst - 1).bit_length())})")
    costs = {}
    for k in capacities:
        f = m._fn(1 << k)
        v0 = torch.full((8,), wiki.n, dtype=torch.int32, device="cuda")
        int(f(*args, v0)[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            int(f(*args, v0)[1])
        costs[k] = (time.perf_counter() - t0) / 5 * 1e3
        log(f"shard reckoning: an all-sentinel chunk at capacity 2^{k}: "
            f"{costs[k]:.2f} ms on {card}")
    return {"needed": needed, "ms": ms, "bounds": bounds, "costs": costs}


def shard_serve(world, backend, card, mine=True) -> list:
    """Phase 15's launcher runs at one world size: `launch.mine` on the
    triangle (with `mine`), then `launch.query_serve` on the triangle, P1
    and an isomorphic P1 (coalesced with it), whole wiki-vote-syn from
    capacity 2^20 at the stripe chunk `SHARD_P1_CHUNK`; returns K1's
    launches per rank in the serve."""
    import tempfile

    base = ["--dataset", SHARD_DATASET, "--capacity", str(SHARD_CAPACITY)]
    tag = f"W={world} {backend}"
    if mine:
        _, wall = torchrun(f"mine triangle {tag}", world,
                           "repro_torch.launch.mine",
                           ["--pattern", "triangle", *base],
                           [WIKI_TRIANGLES], {"count"}, backend)
        log(f"phase 15: mine triangle {tag}: {wall:.1f}s in all (process "
            f"start included) on {card}")
    with tempfile.NamedTemporaryFile("w", suffix=".jsonl",
                                     delete=False) as f:
        f.write('{"pattern": "triangle"}\n{"pattern": "P1"}\n'
                '{"pattern": {"n": 5, "edges": [[0, 1], [1, 2], [2, 3], '
                '[3, 0], [4, 0], [4, 1]], "name": "house-b"}}\n')
    try:
        ranks, wall = torchrun(
            f"query_serve triangle + P1 {tag}", world,
            "repro_torch.launch.query_serve",
            [*base, "--requests", f.name, "--round-quantum", "3",
             "--chunk", str(SHARD_P1_CHUNK[world]), "--expect-min-hits", "1"],
            [WIKI_TRIANGLES, WIKI_P1, WIKI_P1], {"count", "mask"}, backend)
    finally:
        os.unlink(f.name)
    walls = [r["wall"] for r in ranks]
    log(f"phase 15: query_serve {tag}: {wall:.1f}s in all; rank walls "
        f"{walls}, balance max/mean {max(walls) / (sum(walls) / world):.3f}; "
        f"K1 launches per rank {[r['launches'] for r in ranks]} on {card}")
    return [r["launches"] for r in ranks]


def sharded_phase(card) -> dict:
    """Phase 15: multi-GPU counting.  (a) One rank under NCCL through
    `count_embeddings_sharded` on small-rmat; (b) `torchrun` with 2 and
    4 ranks sharing the card under gloo, through `launch.mine` (2 ranks)
    and `launch.query_serve` on wiki-vote-syn at capacity 2^20: the
    triangles at both world sizes, whole P1 at both; (c) NCCL across
    min(cards, 4) cards where there is more than one.  Counts equal
    phase 4's single-device values; every rank launches K1 in exactly
    the plans' modes.  Returns K1's launches per rank and mode."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs.graphpi import get_dataset, get_pattern
    from repro_torch.core.executor import (ExecutorConfig,
                                           count_embeddings_sharded,
                                           triangle_plan)
    from repro_torch.core.perf_model import GraphStats
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import close_group, init_group
    from repro_torch.query.cache import plan_for

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    launches: dict = {}

    # ---- (a) one rank, NCCL, in this process
    small = get_dataset("small-rmat")
    tri = RESULTS["small-rmat triangles"]
    stats = GraphStats(n_vertices=small.n, n_edges=small.m, tri_cnt=tri)
    _, p1_plan = plan_for(get_pattern("P1"), stats, mode="graphpi")
    with tempfile.TemporaryDirectory() as d:
        group, dev = init_group("cuda", rank=0, world_size=1, local_world=1,
                                init_method=f"file://{d}/rdv", timeout=120,
                                log=lambda ln: log(f"phase 15: {ln}"))
        try:
            check(dist.get_backend(group) == "nccl",
                  f"one rank on its card: backend {dist.get_backend(group)}")
            for name, plan, want in (
                    ("triangle", triangle_plan(), tri),
                    ("P1", p1_plan, RESULTS["small-rmat P1"])):
                what = f"small-rmat {name} sharded, W=1, nccl"
                torch.cuda.synchronize()
                ops.reset_launches()
                t0 = time.perf_counter()
                res = count_embeddings_sharded(
                    small, plan, group, cfg=ExecutorConfig(), device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = dict(ops.launches)
                check_launches(what, got, plan, True)
                check_compact(what, got)
                check(res.count == want and not res.overflowed,
                      f"{what}: {res} != {want}")
                log(f"phase 15: {what}: count={res.count} "
                    f"max_needed={res.max_needed} wall={wall:.3f}s "
                    f"K1 launches={ {k: got[k] for k in ops.K1_MODES} } "
                    f"on {card}")
        finally:
            close_group()

    # ---- (b) ranks sharing the card: gloo (NCCL refuses two ranks on
    # one device), through the launchers; `mine` at W = 2 only, which
    # keeps the script near half its time limit with phase 16
    for world in (2, 4):
        launches[f"W{world} triangle + P1"] = shard_serve(
            world, "gloo" if world > cards else "nccl", card,
            mine=world == 2)

    # ---- (c) a card per rank, where the machine has more than one
    if cards > 1:
        world = min(cards, 4)
        launches[f"W{world} nccl triangle + P1"] = shard_serve(
            world, "nccl", card)
    else:
        log("phase 15: one card: no NCCL run across cards")
    log(f"phase 15: sharded checks in {time.perf_counter() - t_phase:.1f}s")
    return launches


# ------------------------------------------------------------ phase 16 --
GW_DATASET = "wiki-vote-syn"
GW_CAPACITY = 1 << 20
GW_DEVICE = "cuda"
# the batch one client pipelines to rank 0 (`RPCClient.submit_many`):
# the triangle, P1 and an isomorphic P1 (coalesced with it), and the
# triangle under the graphzero IEP plan, whose tail runs K1's signed
# mode; then the counts each must have
GW_BATCH = [{"pattern": "triangle"}, {"pattern": "P1"},
            {"pattern": {"n": 5, "edges": [[0, 1], [1, 2], [2, 3], [3, 0],
                                           [4, 0], [4, 1]],
                         "name": "house-b"}},
            {"pattern": "triangle", "mode": "graphzero", "use_iep": True}]
GW_COUNTS = [WIKI_TRIANGLES, WIKI_P1, WIKI_P1, WIKI_TRIANGLES]
GW_MODES = {"mask", "count", "signed"}
EXAMPLES = (("torch_quickstart.py", TINY_ER_ORACLE["P1"]),
            ("torch_motif_counting_iep.py", 612))


def gateway_serve(world, backend, card) -> dict:
    """`torchrun` of `launch.gateway --no-lm --listen 0 --model-buckets`
    on GW_DATASET at `world` ranks; this process is the client: it
    pipelines GW_BATCH to rank 0, reads the results and shuts the
    server down.  Every rank must exit 0 on `backend`, launch K1 in
    exactly GW_MODES, and rank 0 alone print.  Returns the per-rank
    records, the results and the walls."""
    import re
    import signal
    import subprocess
    import tempfile

    from repro_torch.serve.rpc import RPCClient

    tag = f"W={world} {backend}"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        port_file = os.path.join(tmp, "port")
        out_path = os.path.join(tmp, "out.log")
        t0 = time.perf_counter()
        with open(out_path, "w") as out_f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(world), "-m",
                 "repro_torch.launch.gateway", "--no-lm", "--model-buckets",
                 "--dataset", GW_DATASET, "--capacity", str(GW_CAPACITY),
                 "--chunk", str(SHARD_P1_CHUNK[world]), "--graph-quantum",
                 "8", "--listen", "0", "--port-file", port_file,
                 "--device", GW_DEVICE], cwd=ROOT, env=env, text=True,
                stdout=out_f, stderr=subprocess.STDOUT,
                start_new_session=True)
        try:
            while not os.path.exists(port_file):
                check(proc.poll() is None, f"gateway {tag} exited: "
                      + open(out_path).read()[-3000:])
                check(time.perf_counter() - t0 < SHARD_TIMEOUT_S,
                      f"gateway {tag} never listened")
                time.sleep(0.1)
            up = time.perf_counter() - t0
            host, port = open(port_file).read().split()
            client = RPCClient(host, int(port), timeout=SHARD_TIMEOUT_S)
            try:
                t1 = time.perf_counter()
                tickets = client.submit_many(GW_BATCH)
                results = [client.result(t) for t in tickets]
                batch_s = time.perf_counter() - t1
                stats = client.stats()["stats"]
                client.shutdown()
            finally:
                client.close()
            rc = proc.wait(timeout=SHARD_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.perf_counter() - t0
        out = open(out_path).read()
    for ln in out.splitlines():
        if ln.startswith(("[gateway]", "[group]")):
            log(f"phase 16: {tag}: {ln}")
    if rc != 0:
        log(out[-4000:])
    check(rc == 0, f"gateway {tag}: torchrun exited {rc}")
    check("still referenced" not in out and "terminate called" not in out,
          f"gateway {tag}: a rank kept or aborted its group")
    m = re.search(r"\[group\] world=(\d+) backend=(\w+)", out)
    check(m is not None and (int(m.group(1)), m.group(2)) == (world, backend),
          f"gateway {tag}: group {m and m.groups()}")
    check(out.count("[gateway] listening on") == 1,
          f"gateway {tag}: rank 0 alone prints")
    counts = [r["count"] for r in results]
    check(counts == GW_COUNTS, f"gateway {tag}: counts {counts} != "
          f"{GW_COUNTS} (phases 4 and 15)")
    check([r["coalesced"] for r in results] == [False, False, True, False],
          f"gateway {tag}: coalescing {[r['coalesced'] for r in results]}")
    check(not any(r["overflowed"] for r in results),
          f"gateway {tag}: a count overflowed")
    check(stats["devices"] == world and stats["coalesced"] == 1
          and stats["executions"] == 3,
          f"gateway {tag}: {stats['devices']} ranks, {stats['executions']} "
          f"executions, {stats['coalesced']} coalesced")
    ranks = [dict(rank=int(r), wall=float(w), passes=int(p),
                  launches=dict(mask=int(a), count=int(b), signed=int(c)))
             for r, w, p, a, b, c in re.findall(RANK_LINE, out)]
    check([r["rank"] for r in ranks] == list(range(world)),
          f"gateway {tag}: rank lines {ranks}")
    for r in ranks:
        got = {k for k, v in r["launches"].items() if v}
        check(got == GW_MODES, f"gateway {tag}: rank {r['rank']} launched "
              f"K1 in {r['launches']}, want {sorted(GW_MODES)}")
    p1 = results[1]
    log(f"phase 16: gateway {tag}: listening {up:.1f}s after start; the "
        f"pipelined batch answered in {batch_s:.3f}s; whole P1 latency "
        f"{p1['latency_s']:.3f}s (search {p1['search_seconds']:.3f}s, "
        f"warmup {p1['compile_seconds']:.3f}s) max_needed "
        f"{p1['max_needed']:,}; triangle {results[0]['latency_s']:.3f}s, "
        f"graphzero IEP triangle {results[3]['latency_s']:.3f}s; rank walls "
        f"{[r['wall'] for r in ranks]}; K1 launches per rank "
        f"{[r['launches'] for r in ranks]}; {wall:.1f}s in all on {card}")
    return {"ranks": ranks, "results": results, "batch_s": batch_s,
            "wall": wall}


def k1_limits_phase() -> None:
    """The Python mirror of K1's limits equals what the built library
    exports; a call past them, which the static pass flags, is refused
    on the card with an error by the kernels' launchers and by the
    wrappers, and never answered."""
    import dataclasses

    import torch

    from repro_torch.analysis import check_spec
    from repro_torch.analysis.kernel_contracts import LevelExpandSpec
    from repro_torch.kernels import intersect, ops

    lib = intersect.load()
    check((lib.level_expand_max_dirs(), lib.level_rows_max_preds())
          == (ops.MAX_DIRS, ops.MAX_PREDS),
          f"K1 exports {lib.level_expand_max_dirs()} / "
          f"{lib.level_rows_max_preds()}, the mirror says {ops.MAX_DIRS} / "
          f"{ops.MAX_PREDS}")
    spec = LevelExpandSpec(B=4, width=2, P=2, window=2, flat_len=8)
    B, dev = 4, "cuda"

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    refused = 0
    for P, E in ((ops.MAX_PREDS + 1, 0), (2, ops.MAX_DIRS + 1)):
        flagged = {f.rule for f in check_spec(
            dataclasses.replace(spec, P=P, E=E))}
        check(flagged & {"kernel-preds", "kernel-dirs"},
              f"the static pass does not flag P={P} E={E}")
        args = (z(8), z(B), z(B), z(8), z(P, B), z(P, B))
        extra, dirs = (z(B, E), (1,) * E) if E else (None, ())
        before = dict(ops.launches)
        for name, call in (
                ("intersect.level_rows_cuda", lambda: intersect.level_rows_cuda(
                    *args, None, extra, None, dirs=dirs, width=2, window=2)),
                ("intersect.level_compact_cuda",
                 lambda: intersect.level_compact_cuda(
                     *args, None, extra, z(B), z(dtype=torch.int64), z(9),
                     z(9), dirs=dirs, width=2, window=2)),
                ("ops.level_expand_rows", lambda: ops.level_expand_rows(
                    *args, None, extra, dirs=dirs, width=2, window=2))):
            try:
                call()
            except ValueError as e:
                refused += 1
                log(f"phase 16: {name} P={P} E={E} refused: {e}")
            else:
                check(False, f"{name} answered P={P} E={E}")
        torch.cuda.synchronize()
        check(dict(ops.launches) == before, "a refused call counted a launch")
    log(f"phase 16: K1's limits: library exports dirs "
        f"{lib.level_expand_max_dirs()} / preds {lib.level_rows_max_preds()} "
        f"== the Python mirror; {refused} calls past them refused on the card")


def gateway_sharded_phase(card) -> dict:
    """Phase 16: the gateway's sharded graph tenant and the static
    verifier.  `python -m repro_torch.analysis` (all passes) and its
    deep kernel-contract pass over wiki-vote-syn's buckets run on the
    host beside the rest of the phase; K1's limits are checked against
    the library; `torchrun` with 2 ranks sharing the card (gloo) serves
    GW_BATCH through rank 0's RPC server (and under NCCL across cards,
    where there are more); the two examples run on the card.  Returns
    K1's launches per rank and mode."""
    import subprocess

    import torch

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    analysis = {
        "all passes": ["-m", "repro_torch.analysis"],
        "kernel contracts --deep on wiki-vote-syn's buckets": [
            "-m", "repro_torch.analysis", "--kernel-contracts", "--deep",
            "--dataset", GW_DATASET, "--model-buckets"]}
    procs = {what: subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                                    env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
             for what, argv in analysis.items()}
    try:
        k1_limits_phase()
        cards = torch.cuda.device_count()
        runs = {"W2 gateway": gateway_serve(2, "gloo" if cards < 2
                                            else "nccl", card)}
        if cards > 1:
            world = min(cards, 4)
            runs[f"W{world} nccl gateway"] = gateway_serve(world, "nccl",
                                                           card)
        else:
            log("phase 16: one card: no NCCL run across cards")
        t0 = time.perf_counter()
        ex = {name: subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", name),
             "--device", GW_DEVICE], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for name, _ in EXAMPLES}
        for name, want in EXAMPLES:
            out, _ = ex[name].communicate(timeout=SHARD_TIMEOUT_S)
            lines = [ln for ln in out.splitlines()
                     if "count" in ln or "oracle" in ln]
            for ln in lines:
                log(f"phase 16: {name}: {ln}")
            check(ex[name].returncode == 0 and "count == oracle" in out
                  and f"oracle = {want}" in out,
                  f"{name} exited {ex[name].returncode}: {out[-2000:]}")
            launched = sum(int(n) for n in
                           __import__("re").findall(r"(?:mask|count|signed)"
                                                    r"=(\d+)", out))
            check(GW_DEVICE != "cuda" or launched > 0,
                  f"{name}: no K1 launch on the card")
        log(f"phase 16: examples in {time.perf_counter() - t0:.1f}s")
        for what, proc in procs.items():
            out, _ = proc.communicate(timeout=SHARD_TIMEOUT_S)
            log(f"phase 16: python -m repro_torch.analysis ({what}): exit "
                f"{proc.returncode}: {out.splitlines()[0] if out else ''}")
            check(proc.returncode == 0 and " 0 error(s)" in out,
                  f"analysis ({what}) exited {proc.returncode}: "
                  f"{out[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"phase 16: sharded gateway checks in "
        f"{time.perf_counter() - t_phase:.1f}s")
    return {run: [r["launches"] for r in rec["ranks"]]
            for run, rec in runs.items()}


# ------------------------------------------------------------ phase 17 --
# The other LM families, each through `launch.serve` at batch 4, a
# 2,048-token prompt and 16 generated tokens (random weights from seed
# 0, bf16): (arch, decoder layers served (0: all), K4 launches per
# prefill = its flash-eligible attention calls).  jamba-v0.1-52b is cut
# to 8 layers (one superblock: 7 Mamba + 1 attention, MoE in every odd
# layer; ~13.3e9 parameters, 26.5 GB in bf16) and qwen2-vl-72b to 4
# (~6.0e9, 12 GB): the whole models do not fit one card.
FAMILY_RUNS = [("granite-moe-1b-a400m", 0, 24), ("mamba2-370m", 0, 0),
               ("whisper-base", 0, 18), ("jamba-v0.1-52b", 8, 1),
               ("qwen2-vl-72b", 4, 4)]
FAMILY_PROMPT = 2048
FAMILY_ARGV = ["--batch", "4", "--prompt-len", str(FAMILY_PROMPT),
               "--gen", "16"]
# Kernel-path vs plain-path prefill logits (both bf16) are held to phase
# 8's limits, PREFILL_MAX_ABS and PREFILL_MEAN_ABS.  The two paths round
# attention differently (the plain path rounds q·k and the softmax
# weights to bf16, K4 keeps them in fp32), and MoE routing amplifies
# that: a token whose k-th and (k+1)-th experts are nearly tied takes
# another expert.  The noise floor is measured beside each comparison:
# the plain path against the same path with attention in fp32
# (`fp32_attention`), which rounds no better or worse than K4 does.


@contextlib.contextmanager
def fp32_attention():
    """The plain attention path (`layers._sdpa`) computing in fp32 on
    q, k, v widened from bf16, its output cast back: the yardstick of
    attention rounding noise in phase 17."""
    from repro_torch.models import layers

    plain = layers._sdpa

    def wide(q, k, v, *, causal, q_offset=0):
        return plain(q.float(), k.float(), v.float(), causal=causal,
                     q_offset=q_offset).to(q.dtype)

    layers._sdpa = wide
    try:
        yield
    finally:
        layers._sdpa = plain


@contextlib.contextmanager
def recording_routes(routes: list):
    """Appends each MoE layer's chosen experts ([N, k], sorted per
    token) to `routes` while it is open."""
    from repro_torch.models import moe

    route = moe._route

    def spy(p, x, cfg, dtype):
        w, idx, aux = route(p, x, cfg, dtype)
        routes.append(idx.sort(dim=1).values)
        return w, idx, aux

    moe._route = spy
    try:
        yield
    finally:
        moe._route = route


def family_run(card, arch, layers, want) -> dict:
    """One family through `launch.serve.main` on the card: K4 launches
    per prefill (`want`; none in decode), tokens in range; then the
    kernel-path prefill against the plain path (`flash=False`) on the
    session's weights and prompts within phase 8's limits (beside the
    plain path against `fp32_attention`, and the tokens each MoE layer
    routed otherwise), the kernel path's first greedy tokens equal to
    the served run's (and
    beside the plain path's, with the plain path's top-2 gaps: a gap
    below 2·max_abs lets a row's first token differ); for granite-moe a
    second kernel-path prefill, bit-equal.  Then a profile window over
    one prefill and 4 decode steps (`profile_serving`)."""
    import gc

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import make_prefill
    from repro_torch.serve.session import fake_prompts

    gc.collect()                  # the previous family's weights
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch] + FAMILY_ARGV + ["--device", DEVICE]
    if layers:
        argv += ["--layers", str(layers)]
    t0 = time.perf_counter()
    with PhaseLaunches() as rec:
        rc = serve.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"serve.main {arch} exited {rc}")
    check_launches_k4(f"serve.main {' '.join(argv)}", rec,
                      [("prefill", want), ("decode", 0)], phase="phase 17")
    session = rec.sessions[0]
    cfg = session.cfg
    check(T.flash_calls(cfg) == want and
          session.metrics()["flash_launches"] == want,
          f"{arch}: {T.flash_calls(cfg)} flash-eligible calls, session "
          f"counted {session.metrics()['flash_launches']}, not {want}")
    m = session.metrics()
    out = session.tokens_out()
    check(out.shape == (4, 17) and out.min() >= 0 and out.max() < cfg.vocab,
          f"{arch}: served tokens {out.shape} out of range")
    peak = torch.cuda.max_memory_allocated() / 2**30

    batch = fake_prompts(cfg, 4, FAMILY_PROMPT, seed=0, device=DEVICE)
    runs, routes = {}, {}
    for name, flash in (("kernel", True), ("plain", False),
                        ("fp32 attention", False), ("again", True)):
        if name == "again" and cfg.family != "moe":
            continue
        prefill = make_prefill(cfg, DEVICE, q_chunk=0, flash=flash)
        torch.cuda.synchronize()
        ops.reset_launches()
        routes[name] = []
        wide = (fp32_attention() if name == "fp32 attention"
                else contextlib.nullcontext())
        t1 = time.perf_counter()
        with wide, recording_routes(routes[name]):
            logits, cache = prefill(session._params, batch)
        torch.cuda.synchronize()
        runs[name] = (logits, cache, ops.launches["flash"],
                      time.perf_counter() - t1)
    kl, kc, kn, k_s = runs["kernel"]
    pl, _, pn, p_s = runs["plain"]
    wl, _, wn, _ = runs["fp32 attention"]
    check((kn, pn, wn) == (want, 0, 0),
          f"{arch}: prefill launches kernel={kn} plain={pn} fp32={wn}")
    check(bool(torch.isfinite(kl).all()), f"{arch}: logits not finite")

    def apart(a, b):
        d = (a - b).abs()
        return float(d.max()), float(d.mean())

    d_max, d_mean = apart(kl, pl)
    f_max, f_mean = apart(pl, wl)
    moved = ""
    if routes["kernel"]:
        flips = [int((a != b).any(dim=1).sum())
                 for a, b in zip(routes["kernel"], routes["plain"])]
        moved = (f"; tokens routed to another expert set, kernel vs plain "
                 f"path, per MoE layer {flips} of "
                 f"{routes['kernel'][0].shape[0]}")
    k_tok = kl.argmax(-1).cpu().numpy()
    p_tok = pl.argmax(-1).cpu().numpy()
    # the plain path's gap between its two largest logits per row: a
    # row whose gap is below 2·max_abs may take another first token on
    # the kernel path without either path being wrong
    gap = pl.topk(2, dim=-1).values
    gap = (gap[:, 0] - gap[:, 1]).cpu().numpy()
    same = ""
    if "again" in runs:
        al, ac, _, _ = runs["again"]
        bit = torch.equal(al, kl) and all(
            torch.equal(a, b) for a, b in zip(
                (t for lc in ac["layers"] for t in lc.values()),
                (t for lc in kc["layers"] for t in lc.values())))
        check(bit, f"{arch}: two kernel-path prefills differ")
        same = "; a second kernel-path prefill bit-equal (logits, K/V)"
    log(f"phase 17: {arch} ({cfg.n_layers} layers, "
        f"{cfg.param_count() / 1e9:.3f}e9 params): served prefill "
        f"{m['prefill_seconds']:.4f} s, decode {m['ms_per_step']:.3f} "
        f"ms/step ({m['decode_tok_s']:.1f} tok/s), peak memory {peak:.2f} "
        f"GiB, serve.main wall {wall:.1f} s; warm prefill kernel path "
        f"{k_s:.4f} s, plain path {p_s:.4f} s; logits [4, {cfg.vocab}] "
        f"kernel vs plain max_abs={d_max:.4f} mean_abs={d_mean:.5f} "
        f"(limits {PREFILL_MAX_ABS} / {PREFILL_MEAN_ABS}), plain vs fp32 "
        f"attention max_abs={f_max:.4f} mean_abs={f_mean:.5f}, logit std "
        f"{float(pl.std()):.4f}{moved}; first tokens kernel "
        f"{k_tok.tolist()} plain {p_tok.tolist()} (top-2 gaps "
        f"{', '.join(f'{g:.4f}' for g in gap)}) served "
        f"{out[:, 0].tolist()}{same} on {card}")
    check(d_max <= PREFILL_MAX_ABS and d_mean <= PREFILL_MEAN_ABS,
          f"{arch}: kernel vs plain prefill logits: max {d_max} "
          f"mean {d_mean}")
    check((k_tok == out[:, 0]).all(),
          f"{arch}: kernel-path first tokens differ from the served run's")
    del runs

    # where the time goes: a prefill and 4 decode steps profiled (the
    # served session has finished: the steps rewrite cache cells
    # 2,048-2,051 with its last token)
    tok = session._tokens
    start = torch.full((4,), FAMILY_PROMPT, dtype=torch.long, device=DEVICE)

    def decode4():
        for i in range(4):
            session._decode(session._params, tok, session._cache, start + i)

    profile_serving(session, cfg, batch, card, decode=decode4, top=5,
                    label=f"phase 17: {arch} profile")
    # phase 19 holds its tensor-parallel logits against these
    RESULTS[f"one-device logits {arch}"] = (kl.cpu(), f_max, f_mean)
    return {"launches": want, "prefill_s": m["prefill_seconds"],
            "decode_ms": m["ms_per_step"], "peak_gib": peak,
            "max_abs": d_max}


def family_phase(card) -> dict:
    """Phase 17: every other LM family on the card (`FAMILY_RUNS`).
    Returns K4's launches per prefill by arch."""
    t_phase = time.perf_counter()
    launches = {}
    for arch, layers, want in FAMILY_RUNS:
        launches[arch] = family_run(card, arch, layers, want)["launches"]
    log(f"phase 17: LM families in {time.perf_counter() - t_phase:.1f}s")
    return launches



# ------------------------------------------------------------ phase 18 --
# LM training through `repro_torch.launch.train.main` (random weights
# from seed 0, fp32 masters, bf16 compute, remat on, AdamW at the
# launcher's defaults): qwen3-1.7b whole for TRAIN_STEPS steps, then the
# families of `TRAIN_RUNS` whole for 3 steps each.  No full-size
# checkpoint is written (qwen3-1.7b's would be 32.5 GB).
# qwen3-1.7b trains at --lr 3e-5.  From random weights with the
# launcher's 5 warm-up steps, larger rates spike its loss (8 steps at
# the default 3e-4: the grad norm 5.8 -> 96.9 at step 4; at 1e-4: 8.6 ->
# 63.0 at step 8, the loss ending above its first value).  Whether bf16
# compute or AdamW's dynamics at this scale cause it is not yet
# separated; the gradient itself is checked at full size in fp32
# (`train_gradient_check`).  The other runs keep the default 3e-4;
# mamba2-370m takes 8 steps because in 3 its loss moves less than the
# batch-to-batch spread.
TRAIN_ARGV = ["--batch", "4", "--seq", "1024", "--log-every", "1"]
TRAIN_STEPS = 8
TRAIN_LR = "3e-5"
TRAIN_RUNS = [("granite-moe-1b-a400m", 3), ("mamba2-370m", 8),
              ("whisper-base", 3)]
# The backward pass at full size: qwen3-1.7b whole in fp32, one sequence
# of TRAIN_CHECK_SEQ tokens; the loss's change along the normalized
# gradient over a step of GRAD_EPS, divided by it, must be -|g| within
# GRAD_RTOL (a wrong gradient points elsewhere, and the slope is then
# smaller in size).
GRAD_EPS = 1e-3
GRAD_RTOL = 1e-2
# The card against the port's CPU path: qwen3-1.7b at full width cut to
# 2 layers, one sequence of 256 tokens, one train step from the same
# state, bf16 on both.  The limits are absolute, about ten times the
# distances measured on an H100: card against CPU 0.00028 on the loss
# (about 12.3) and 0.00178 on the grad norm (about 13.9), the card's
# bf16 step against its fp32 one 0.00011 and 0.00251.  A path with
# nearly uniform logits (loss ln V = 11.93) lies far outside them.
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_SEQ = 256
TRAIN_LOSS_ATOL = 5e-3
TRAIN_GNORM_ATOL = 2e-2
# The resume check: the smoke config 4 + 4 steps against 8 straight on
# the card, under deterministic algorithms, within the reference's own
# tolerance (tests/test_checkpoint.py).
RESUME_ARGV = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
               "--log-every", "100"]
RESUME_RTOL, RESUME_ATOL = 2e-5, 2e-6


class TrainSteps:
    """Wraps `train_step.make_train_step` while open: each step's
    K4 counters are set to 0 just before it and read just after, and
    the step is synchronized and timed on the host clock; keeps each
    step's record (with the collectives it made, by kind: calls and
    bytes) and the last step's function and arguments (for a profile
    window after the run)."""

    def __init__(self):
        self.steps: list[dict] = []
        self.last = None

    def __enter__(self):
        from repro_torch.train import train_step

        self.mod, self.make = train_step, train_step.make_train_step

        def make(*a, **kw):
            step = self.make(*a, **kw)

            def recorded(params, opt_state, batch):
                import torch

                from repro_torch.kernels import ops
                from repro_torch.parallel import tp

                cuda = torch.cuda.is_available()   # phase 20's CPU ranks
                if cuda:
                    torch.cuda.synchronize()
                ops.reset_launches()
                calls, moved = dict(tp.calls), dict(tp.moved)
                t0 = time.perf_counter()
                out = step(params, opt_state, batch)
                if cuda:
                    torch.cuda.synchronize()
                m = out[2]
                self.steps.append({
                    "s": time.perf_counter() - t0,
                    "loss": float(m["loss"]), "grad_norm":
                    float(m["grad_norm"]), "lr": float(m["lr"]),
                    "launches": dict(ops.launches),
                    "collectives": {k: [tp.calls[k] - calls[k],
                                        tp.moved[k] - moved[k]]
                                    for k in tp.KINDS
                                    if tp.calls[k] > calls[k]}})
                self.last = (step, out[0], out[1], batch)
                return out
            return recorded

        train_step.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.mod.make_train_step = self.make
        return False


def profile_train_step(last, card, label, top=8) -> dict:
    """One more step of a finished run (`TrainSteps.last`) unprofiled
    (host clock ending in a synchronize), then one under torch.profiler:
    the device kernels' summed time against the unprofiled wall (the
    busy share), their launches, and the `top` kernels by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step, params, opt_state, batch = last
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, opt_state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    n = sum(e.count for e in kern)
    log(f"{label}: one step: device kernels {busy_ms:.3f} ms in {n} "
        f"launches; unprofiled wall {wall_ms:.3f} ms; busy share "
        f"{100 * busy_ms / wall_ms:.1f}% on {card}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"{label}:   {e.self_device_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:160]}")
    # the optimizer's share: the AdamW update alone on zero gradients
    # (decay only; the run is over), CUDA events
    from repro_torch.train import optimizer as O
    from repro_torch.train.tree import leaves, tree_map

    grads = tree_map(torch.zeros_like, params)
    cfg = O.AdamWConfig()
    opt_ms = time_ms(lambda: O.adamw_update(cfg, grads, opt_state, params),
                     iters=5)
    log(f"{label}: the AdamW update alone: {opt_ms:.3f} ms "
        f"({len(leaves(params))} leaves) on {card}")
    return {"busy_ms": busy_ms, "launches": n, "wall_ms": wall_ms,
            "adamw_ms": opt_ms}


def train_run(card, arch, steps, extra=(), profile_it=False) -> dict:
    """`arch` whole through `launch.train.main` on the card for `steps`
    steps: every loss and grad norm finite, the last loss below the
    first, no K4 launch in any step; prints each step, the steady step
    time (median after the first), tokens per second and peak memory."""
    import gc
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = (["--arch", arch, "--steps", str(steps), "--device", DEVICE]
            + TRAIN_ARGV + list(extra))
    t0 = time.perf_counter()
    with TrainSteps() as rec:
        rc = train.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"train.main {arch} exited {rc}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = rec.steps
    check(len(st) == steps, f"{arch}: {len(st)} steps recorded, not {steps}")
    losses = [r["loss"] for r in st]
    for i, r in enumerate(st):
        check(all(map(math.isfinite, (r["loss"], r["grad_norm"]))),
              f"{arch}: step {i + 1} loss {r['loss']} gnorm "
              f"{r['grad_norm']} not finite")
        check(r["launches"]["flash"] == 0,
              f"{arch}: step {i + 1} launched K4 {r['launches']['flash']} "
              f"times (training attention is plain)")
    check(losses[-1] < losses[0], f"{arch}: loss did not fall: {losses}")
    tokens = 4 * 1024
    steady = statistics.median(r["s"] for r in st[1:])
    cfg = get_config(arch)
    log(f"phase 18: train.main {' '.join(argv)} ({cfg.n_layers} layers, "
        f"{cfg.param_count() / 1e9:.3f}e9 params): losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(r['grad_norm'], 3) for r in st]}; step s "
        f"{[round(r['s'], 4) for r in st]}; steady {steady:.4f} s/step "
        f"({tokens / steady:.0f} tok/s); peak memory {peak:.2f} GiB; K4 "
        f"launches per step {[r['launches']['flash'] for r in st]}; "
        f"train.main wall {wall:.1f} s on {card}")
    out = {"steady_s": steady, "peak_gib": peak, "losses": losses,
           "launches": [r["launches"]["flash"] for r in st]}
    # phase 20 holds its sharded first steps against these
    RESULTS[f"first step {arch}"] = (st[0]["loss"], st[0]["grad_norm"])
    if profile_it:
        out["profile"] = profile_train_step(
            rec.last, card, f"phase 18: {arch} profile")
    rec.last = None
    return out


def train_against_cpu(card) -> None:
    """qwen3-1.7b at full width cut to TRAIN_CHECK_LAYERS layers: one
    train step from the same state and batch on the card and on the
    port's CPU path (bf16 both), loss within TRAIN_LOSS_ATOL and grad
    norm within TRAIN_GNORM_ATOL,
    printed beside the card's distance from the same step in fp32 (the
    rounding noise floor, as phase 17 measures it on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.tree import tree_map

    cfg = get_config(ARCH).scaled(n_layers=TRAIN_CHECK_LAYERS)
    opt = O.AdamWConfig(total_steps=8, warmup_steps=5)
    opts = TS.TrainOptions(remat=True, q_chunk=0, loss_chunk=0)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_CHECK_SEQ,
                                   global_batch=1), cfg).batch(0)
    t0 = time.perf_counter()
    master, _ = TS.init_train_state(cfg, seed=0, device="cpu")
    got = {}
    for name, c, dev in (("card", cfg, DEVICE), ("cpu", cfg, "cpu"),
                         ("card fp32", cfg.scaled(dtype="float32"), DEVICE)):
        params = tree_map(lambda t: t.to(dev, copy=True), master)
        state = O.init_opt_state(params)
        t1 = time.perf_counter()
        _, _, m = TS.make_train_step(c, opt, opts, device=dev)(
            params, state, batch)
        got[name] = (float(m["loss"]), float(m["grad_norm"]),
                     time.perf_counter() - t1)
        del params, state
    (cl, cg, cs), (pl, pg, ps), (fl, fg, _) = (
        got["card"], got["cpu"], got["card fp32"])
    log(f"phase 18: {ARCH} full width, {TRAIN_CHECK_LAYERS} layers, 1 x "
        f"{TRAIN_CHECK_SEQ} tokens, one step: card loss {cl:.5f} gnorm "
        f"{cg:.5f} ({cs:.3f} s), CPU loss {pl:.5f} gnorm {pg:.5f} "
        f"({ps:.3f} s): apart {abs(cl - pl):.5f} / {abs(cg - pg):.5f} "
        f"(limits {TRAIN_LOSS_ATOL} / {TRAIN_GNORM_ATOL}); noise floor, the "
        f"card's bf16 vs fp32 step: {abs(cl - fl):.5f} / "
        f"{abs(cg - fg):.5f}; "
        f"{time.perf_counter() - t0:.1f} s in all on {card}")
    for what, a, b, tol in (("loss", cl, pl, TRAIN_LOSS_ATOL),
                            ("grad norm", cg, pg, TRAIN_GNORM_ATOL)):
        check(abs(a - b) <= tol,
              f"{ARCH} {TRAIN_CHECK_LAYERS} layers: card {what} {a} vs "
              f"CPU {b}")


def train_gradient_check(card) -> None:
    """The gradient of `loss_fn` at full size against the loss itself:
    qwen3-1.7b whole in fp32 on the card, (L(θ - ε·g/|g|) - L(θ)) / ε
    within GRAD_RTOL of -|g| (`GRAD_EPS`)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.tree import leaves

    cfg = get_config(ARCH).scaled(dtype="float32")
    params = T.init(cfg, 0, DEVICE)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_CHECK_SEQ,
                                   global_batch=1), cfg).batch(0)
    batch = {k: v.to(DEVICE) for k, v in batch.items()}
    loss = T.loss_fn(cfg, remat=True)
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    l0, _ = loss(params, batch)
    gs = torch.autograd.grad(l0, ps)
    gn = float(O.global_norm(gs))
    with torch.no_grad():
        for p, g in zip(ps, gs):
            p.sub_(g, alpha=GRAD_EPS / gn)
        l1 = float(loss(params, batch)[0])
    slope = (l1 - float(l0.detach())) / GRAD_EPS
    log(f"phase 18: {ARCH} whole in fp32, 1 x {TRAIN_CHECK_SEQ} tokens: "
        f"loss {float(l0.detach()):.6f}, |g| = {gn:.6f}; slope of the loss "
        f"along -g/|g| over {GRAD_EPS:g}: {slope:.6f} (want -|g|, within "
        f"{GRAD_RTOL:g}) on {card}")
    check(abs(slope + gn) <= GRAD_RTOL * gn,
          f"{ARCH}: slope along the gradient {slope} != -|g| = {-gn}")
    del params, ps, gs
    gc.collect()
    torch.cuda.empty_cache()


def train_resume(card) -> None:
    """The smoke config through `launch.train.main` on the card: 4 steps
    and a resumed 4 against 8 straight, every leaf of the step-8
    checkpoints within the reference's tolerance, under
    `torch.use_deterministic_algorithms` (cuBLAS's deterministic
    workspace set for it)."""
    import json
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch import train

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    argv = RESUME_ARGV + ["--device", DEVICE]
    with tempfile.TemporaryDirectory() as tmp:
        d1, d2 = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        torch.use_deterministic_algorithms(True)
        try:
            with contextlib.redirect_stdout(None):
                for steps in ("4", "8"):
                    train.main(argv + ["--steps", steps, "--ckpt-dir", d1,
                                       "--ckpt-every", "4"])
                train.main(argv + ["--steps", "8", "--ckpt-dir", d2,
                                   "--ckpt-every", "8"])
        finally:
            torch.use_deterministic_algorithms(False)

        def leaves(d):
            with open(os.path.join(d, "step_8", "manifest.json")) as f:
                man = json.load(f)
            return {m["path"]: np.load(os.path.join(d, "step_8", m["file"]))
                    for m in man["leaves"]}

        l1, l2 = leaves(d1), leaves(d2)
    check(l1.keys() == l2.keys(), "resume: checkpoint trees differ")
    worst = max(float(np.abs(l1[k].astype(np.float64) - l2[k]).max())
                for k in l1)
    for k in l1:
        check(bool(np.allclose(l1[k], l2[k], rtol=RESUME_RTOL,
                               atol=RESUME_ATOL)),
              f"resume: {k} differs between 4 + 4 and 8 steps")
    log(f"phase 18: resume on the card ({' '.join(RESUME_ARGV)}): 4 + 4 "
        f"steps equal 8 straight within rtol {RESUME_RTOL} / atol "
        f"{RESUME_ATOL} over {len(l1)} leaves (largest difference "
        f"{worst:.3e}) on {card}")


def train_phase(card) -> dict:
    """Phase 18: LM training on the card.  Returns K4's launches per
    step of each run (training attention is plain: all 0)."""
    t_phase = time.perf_counter()
    runs = {ARCH: train_run(card, ARCH, TRAIN_STEPS, ("--lr", TRAIN_LR),
                            profile_it=True)}
    for arch, steps in TRAIN_RUNS:
        runs[arch] = train_run(card, arch, steps)
    train_gradient_check(card)
    train_against_cpu(card)
    train_resume(card)
    log(f"phase 18: LM training in {time.perf_counter() - t_phase:.1f}s")
    return {arch: r["launches"] for arch, r in runs.items()}


# ------------------------------------------------------------ phase 19 --
# Tensor-parallel serving through `repro_torch.launch.serve --model-axis
# 2`: one torchrun launch of TP_WORLD ranks sharing the card (gloo; NCCL
# refuses two ranks on one device), batch 4, a 2,048-token prompt, 16
# tokens, random weights from seed 0, bf16: (arch, decoder layers (0:
# all), K4 launches per rank per prefill).  qwen2-vl-72b at full width
# cut to 4 layers as in phase 17, jamba-v0.1-52b to 8 (one superblock),
# granite-34b to 8 (its one KV head puts the decode cache's sequence over
# the model axis: flash-decoding) and whisper-base whole.  The ranks
# serve the runs one after another in one launch (`tp_child`: each
# calls `launch.serve.main`'s body in the group the launch opened).
TP_WORLD = 2
TP_RUNS = [("qwen2-vl-72b", 4, 4), ("jamba-v0.1-52b", 8, 1),
           ("granite-34b", 8, 8), ("whisper-base", 0, 18)]
TP_PROMPT = 2048
TP_ARGV = ["--batch", "4", "--gen", "16", "--model-axis", str(TP_WORLD)]
# Each run's TP prefill logits are held to phase 8's limits,
# PREFILL_MAX_ABS and PREFILL_MEAN_ABS, against the one-device kernel
# path's on the same weights and prompts (phase 17's for jamba and
# qwen2-vl, made here for the others): the TP path sums each
# row-parallel product's partials in fp32 over gloo and rounds once,
# where one device rounds the whole product, and MoE routing amplifies
# that the way phase 17's note says.  The first greedy token must equal
# the one-device token wherever the one-device top-2 gap exceeds that
# distance.
TP_TIMEOUT_S = 420
TP_CHILD_ARGV: list = []          # extra `tp_child` flags (a CPU rehearsal)
TP4_ARGV = ["--arch", "qwen2-vl-72b", "--batch", "4", "--prompt-len", "2048",
            "--gen", "16", "--model-axis", "4"]
TP_RANK_LINE = (r"\[serve\] rank (\d+): K4 launches=(\d+) prefill=([\d.]+)s "
                r"decode=([\d.]+)ms/step peak=([\d.]+)GiB")


def tp_child(argv) -> int:
    """A rank of phase 19's launch (`chip_smoke.py --tp-child --out F`,
    under torchrun): every run of `TP_RUNS` through `launch.serve.main`'s
    body (`--model-axis TP_WORLD`) in the launch's group, K4's launches
    per phase recorded (`PhaseLaunches`), then one more TP prefill on
    the served weights and prompts, whose logits rank 0 saves to
    F.<arch>.pt; each rank writes its records to F.rank<r>.json."""
    import argparse
    import gc

    import torch

    from repro_torch.launch import mesh, serve
    from repro_torch.serve.serve_step import make_prefill
    from repro_torch.serve.session import fake_prompts

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=TP_PROMPT)
    args = ap.parse_args(argv)
    group, device = mesh.shared_group(args.device)
    rank = group.rank()
    cuda = device.type == "cuda"
    records = []
    for arch, layers, _ in TP_RUNS:
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        run = (["--arch", arch, "--prompt-len", str(args.prompt_len),
                "--device", args.device] + TP_ARGV
               + (["--layers", str(layers)] if layers else [])
               + (["--smoke"] if args.smoke else []))
        with PhaseLaunches() as rec:
            rc = serve.main.__wrapped__(run)
        session = rec.sessions[0]
        m = session.metrics()
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        batch = fake_prompts(session.cfg, 4, args.prompt_len, seed=0,
                             device=device)
        prefill = make_prefill(session.cfg, device, q_chunk=0,
                               grid=session.grid)
        t0 = time.perf_counter()
        logits, _ = prefill(session._params, batch)
        if cuda:
            torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        if rank == 0:
            torch.save(logits.float().cpu(), f"{args.out}.{arch}.pt")
        records.append({
            "arch": arch, "rc": rc, "phases": rec.records,
            "variants": rec.variants, "prefill_s": m["prefill_seconds"],
            "warm_prefill_s": warm,
            "decode_ms": m["ms_per_step"], "peak_gib": peak,
            "tokens": session.tokens_out()[:, 0].tolist(),
            "split": [session.grid.data, session.grid.model]})
        del session, rec, prefill, logits, batch
    with open(f"{args.out}.rank{rank}.json", "w") as f:
        json.dump(records, f)
    del group                   # close_group frees the group it holds
    mesh.close_group()
    return 0


def one_device_logits(arch, layers, device, rows=4, prompt=None):
    """The one-device kernel-path prefill logits of `arch` cut to
    `layers` (weights from seed 0 cast layer by layer, `fake_prompts`
    of seed 0: `rows` rows of `prompt` tokens, default TP_PROMPT),
    beside the plain path's noise floor (plain against
    `fp32_attention`, max and mean): what phase 17 keeps for its runs."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import (cast_params_for_serving,
                                              make_prefill)
    from repro_torch.serve.session import fake_prompts

    cfg = get_config(arch)
    if layers:
        cfg = cfg.scaled(n_layers=layers)
    params = T.init(cfg, 0, device, cast=cast_params_for_serving)
    batch = fake_prompts(cfg, rows, prompt or TP_PROMPT, seed=0,
                         device=device)
    kernel = make_prefill(cfg, device, q_chunk=0)(params, batch)[0]
    plain = make_prefill(cfg, device, q_chunk=0, flash=False)
    pl = plain(params, batch)[0]
    with fp32_attention():
        wl = plain(params, batch)[0]
    d = (pl - wl).abs()
    out = (kernel.float().cpu(), float(d.max()), float(d.mean()))
    del params, batch, kernel, pl, wl
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_start(world, argv, env=None):
    """Start one torchrun of `world` ranks on the card, in a session of
    its own (its environment this process's with `env` over it), its
    output into an anonymous file; returns (process, file)."""
    import subprocess
    import tempfile

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(world), *argv]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", **(env or {}))
    out = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True, stdout=out,
                            stderr=subprocess.STDOUT, start_new_session=True)
    return proc, out


def tp_collect(what, started, timeout=TP_TIMEOUT_S, phase="phase 19"):
    """Wait for a `tp_start` launch (killed whole past `timeout`);
    returns (exit code, output)."""
    import signal
    import subprocess

    proc, f = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        f.seek(0)
        log(f.read()[-4000:])
        check(False, f"{what}: no end in {timeout}s")
    f.seek(0)
    out = f.read()
    f.close()
    if proc.returncode != 0:
        # the ranks' own tracebacks, then the end (torchrun's summary of
        # many ranks alone outgrows it)
        log("\n".join([ln for ln in out.splitlines()
                       if ln.startswith("[rank")][-80:]))
        log(out[-6000:])
    for ln in out.splitlines():
        if ln.startswith(("[serve] rank", "[serve] grid", "[group]",
                          "[train] rank", "[train] grid")):
            log(f"{phase}: {what}: {ln}")
    return proc.returncode, out


def tp_launch(what, world, argv, timeout=TP_TIMEOUT_S, phase="phase 19",
              env=None):
    """One torchrun of `world` ranks on the card (`tp_start`, then
    `tp_collect`); returns (exit code, output)."""
    return tp_collect(what, tp_start(world, argv, env), timeout, phase)


def tp_whole_run(card) -> list:
    """qwen2-vl-72b whole (80 layers, 145 GB in bf16) at `--model-axis
    4` through `launch.serve` under NCCL, a card per rank: 80 K4
    launches a rank per prefill, 16 tokens served; each rank's line
    printed.  Returns the K4 launches per rank."""
    import re

    rc, out = tp_launch("qwen2-vl-72b whole, 4 cards", 4,
                        ["-m", "repro_torch.launch.serve", *TP4_ARGV])
    check(rc == 0, f"phase 19: 4-card torchrun exited {rc}")
    check("[group] world=4 backend=nccl" in out,
          "phase 19: the 4-card launch is not on NCCL")
    rows = re.findall(TP_RANK_LINE, out)
    check([int(r[0]) for r in rows] == [0, 1, 2, 3]
          and all(int(r[1]) == 80 for r in rows),
          f"phase 19: 4-card K4 launches per rank {rows}, want 80")
    check("[serve] decode: 16 steps" in out,
          "phase 19: the 4-card run did not serve 16 tokens")
    for ln in out.splitlines():
        if ln.startswith(("[serve] prefill", "[serve] decode",
                          "[serve] sample")):
            log(f"phase 19: qwen2-vl-72b whole, 4 cards: {ln} on {card}")
    return [int(r[1]) for r in rows]


def tp_phase(card) -> dict:
    """Phase 19: `TP_RUNS` through one torchrun of `launch.serve
    --model-axis 2` (`tp_child`): every rank launches K4 once per
    flash-eligible attention call of its prefill and none in decode,
    all of the wgmma kernel; the ranks take the same tokens; the TP
    prefill logits lie within phase 8's limits of the one-device
    kernel path's, and the first tokens agree wherever the one-device
    top-2 gap exceeds the distance.  With 4 or more cards, qwen2-vl-72b
    whole at `--model-axis 4` under NCCL, a card per rank.  Returns K4's
    launches per rank per prefill by arch."""
    import gc
    import tempfile

    import torch

    t_phase = time.perf_counter()
    gc.collect()                  # the earlier phases' weights: the
    torch.cuda.empty_cache()      # ranks need the card's memory
    log(f"phase 19: this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of the card")
    one = {}
    for arch, layers, _ in TP_RUNS:
        key = f"one-device logits {arch}"
        one[arch] = RESULTS.get(key) or one_device_logits(arch, layers,
                                                          DEVICE)
    out_dir = tempfile.mkdtemp(prefix="tp-", dir=os.path.join(ROOT, "build"))
    base = os.path.join(out_dir, "run")
    t0 = time.perf_counter()
    rc, out = tp_launch(f"{TP_WORLD} ranks, one card", TP_WORLD,
                        [os.path.abspath(__file__), "--tp-child", "--out",
                         base, "--device", DEVICE, *TP_CHILD_ARGV])
    wall = time.perf_counter() - t0
    check(rc == 0, f"phase 19: torchrun exited {rc}")
    check(f"[group] world={TP_WORLD} backend=gloo" in out,
          "phase 19: the ranks sharing the card are not on gloo")
    ranks = []
    for r in range(TP_WORLD):
        with open(f"{base}.rank{r}.json") as f:
            ranks.append(json.load(f))
    launches = {}
    for i, (arch, layers, want) in enumerate(TP_RUNS):
        recs = [rk[i] for rk in ranks]
        for r, rec in enumerate(recs):
            phases = [tuple(p) for p in rec["phases"]]
            check(rec["rc"] == 0, f"phase 19: {arch} rank {r}: serve "
                  f"exited {rec['rc']}")
            check(phases == [("prefill", want), ("decode", 0)],
                  f"phase 19: {arch} rank {r}: K4 launches {phases}, want "
                  f"{want} in the prefill and none in decode")
            check(rec["variants"] == [{"scalar": 0, "wgmma": n}
                                      for _, n in phases],
                  f"phase 19: {arch} rank {r}: K4 kernels {rec['variants']}")
            check(rec["tokens"] == recs[0]["tokens"],
                  f"phase 19: {arch}: ranks took other tokens "
                  f"{[x['tokens'] for x in recs]}")
        launches[arch] = [want] * TP_WORLD
        tp = torch.load(f"{base}.{arch}.pt")
        kl, f_max, f_mean = one[arch]
        check(tp.shape == kl.shape and bool(torch.isfinite(tp).all()),
              f"phase 19: {arch}: TP logits {tuple(tp.shape)} vs "
              f"{tuple(kl.shape)}, or not finite")
        d = (tp - kl.float()).abs()
        d_max, d_mean = float(d.max()), float(d.mean())
        top = kl.float().topk(2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).tolist()
        t_tok, o_tok = tp.argmax(-1).tolist(), kl.argmax(-1).tolist()
        served = recs[0]["tokens"]
        per_rank = "; ".join(
            f"rank {r} prefill {x['prefill_s']:.4f} s (warm "
            f"{x['warm_prefill_s']:.4f} s), decode "
            f"{x['decode_ms']:.3f} ms/step, peak {x['peak_gib']:.2f} GiB"
            for r, x in enumerate(recs))
        log(f"phase 19: {arch} ({layers or 'all'} layers) at data x model "
            f"= {recs[0]['split']}: {per_rank}; TP vs one-device logits "
            f"max_abs={d_max:.4f} mean_abs={d_mean:.5f} (limits "
            f"{PREFILL_MAX_ABS} / {PREFILL_MEAN_ABS}; one-device plain vs "
            f"fp32 attention noise floor max_abs={f_max:.4f} "
            f"mean_abs={f_mean:.5f}); first tokens TP {t_tok} served "
            f"{served} one-device {o_tok} (top-2 gaps "
            f"{', '.join(f'{g:.4f}' for g in gap)}) on {card}")
        check(d_max <= PREFILL_MAX_ABS and d_mean <= PREFILL_MEAN_ABS,
              f"phase 19: {arch}: TP vs one-device logits max {d_max} "
              f"mean {d_mean}")
        for b, g in enumerate(gap):
            if g > d_max:
                check(t_tok[b] == o_tok[b] == served[b],
                      f"phase 19: {arch} row {b}: first token TP "
                      f"{t_tok[b]} served {served[b]} one-device "
                      f"{o_tok[b]} (gap {g:.4f} > {d_max:.4f})")
    log(f"phase 19: {TP_WORLD}-rank launch in {wall:.1f}s")
    if torch.cuda.device_count() >= 4:
        launches["qwen2-vl-72b whole, model 4"] = tp_whole_run(card)
    else:
        log(f"phase 19: qwen2-vl-72b whole at --model-axis 4 on 4 cards "
            f"skipped: {torch.cuda.device_count()} card(s) visible")
    log(f"phase 19: tensor-parallel serving in "
        f"{time.perf_counter() - t_phase:.1f}s")
    return launches


# ------------------------------------------------------------ phase 20 --
# Sharded training through `repro_torch.launch.train --model-axis M`:
# torchrun launches of ranks sharing the card (gloo; NCCL refuses two
# ranks on one device), random weights from seed 0, bf16, remat, the
# batch of phase 18 (4 x 1,024).  Each rank runs `TP_TRAIN_RUNS[launch]`
# through `launch.train.main`'s body in the launch's group
# (`tp_train_child`), each step recorded by `TrainSteps`.
#  * launch A, 2 ranks at model 2: qwen3-1.7b whole, 3 steps at lr
#    TRAIN_LR; then whisper-base whole, 2 steps checkpointed, and step 3
#    resumed from that checkpoint at model 2, while the checkpoint's
#    copy resumes on one device (`--model-axis 1`, in this process);
#  * launch B, 4 ranks at data 2 x model 2 (ZeRO-3 over data, expert
#    parallelism, the MoE keep decision over the whole batch):
#    granite-moe-1b-a400m whole, 2 steps (under gloo each step moves
#    every parameter's data-axis gather twice, forward and remat, and its
#    gradient once, through the host); it runs at the same time as
#    launch A (~35 + ~25 GiB of the card), which keeps the script under
#    its time limit: the ranks' step times are then each other's
#    contention, collectives and not scaling in any case;
#  * with 4 or more cards, one NCCL launch with a card per rank:
#    jamba-v0.1-52b cut to 8 layers (one superblock) at model 4, 53 GB
#    of fp32 masters, gradients and AdamW moments a card, and
#    qwen2-vl-72b cut to 4 layers at data 2 x model 2, 24 GB a card;
#    neither fits one card.
# The first step of qwen3-1.7b and of granite-moe must lie within
# TRAIN_LOSS_ATOL / TRAIN_GNORM_ATOL of phase 18's one-device first step
# on the same weights and batch (the sharded step sums each row-parallel
# product's partials in fp32 over gloo and rounds once, where one device
# rounds the whole product: the same bf16 noise phase 18's limits are
# ten times), and whisper-base's one-device step 3 within the same
# limits of launch A's; K4 launches 0 in every step of every rank
# (training attention is plain).
TP_TRAIN_ARGV = ["--batch", "4", "--seq", "1024", "--log-every", "1"]
# extra `launch.train` flags of every phase 20 run, passed to the ranks
# too (a CPU rehearsal: ["--smoke", "--seq", "32"])
TP_TRAIN_CHILD_ARGV: list = []
TP_TRAIN_RUNS = {
    "A": [("qwen3-1.7b", ["--arch", "qwen3-1.7b", "--steps", "3", "--lr",
                          TRAIN_LR, "--model-axis", "2"]),
          ("whisper-base to step 2", ["--arch", "whisper-base", "--steps",
                                      "2", "--model-axis", "2",
                                      "--ckpt-every", "2"]),
          ("whisper-base step 3", ["--arch", "whisper-base", "--steps", "3",
                                   "--model-axis", "2"])],
    "B": [("granite-moe-1b-a400m", ["--arch", "granite-moe-1b-a400m",
                                    "--steps", "2", "--model-axis", "2"])],
    "4 cards": [("jamba-v0.1-52b, 8 layers", [
                    "--arch", "jamba-v0.1-52b", "--layers", "8", "--steps",
                    "2", "--model-axis", "4"]),
                ("qwen2-vl-72b, 4 layers", [
                    "--arch", "qwen2-vl-72b", "--layers", "4", "--steps", "2",
                    "--model-axis", "2"])],
}
TP_TRAIN_WORLD = {"A": 2, "B": 4, "4 cards": 4}
TP_TRAIN_TIMEOUT_S = 300


def tp_train_child(argv) -> int:
    """A rank of a phase 20 launch (`chip_smoke.py --tp-train-child
    --launch L --out F --ckpt D`, under torchrun): every run of
    `TP_TRAIN_RUNS[L]` through `launch.train.main`'s body in the
    launch's group, each step recorded (`TrainSteps`); the whisper-base
    runs checkpoint into D/tp, which rank 0 copies to D/one after step
    2; each rank writes its records to F.rank<r>.json."""
    import argparse
    import gc
    import shutil

    import torch

    from repro_torch.launch import mesh, train

    ap = argparse.ArgumentParser()
    ap.add_argument("--launch", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seq", default="")
    args = ap.parse_args(argv)
    import torch._dynamo  # noqa: F401  (before the group: launch.train's note)

    group, device = mesh.shared_group(args.device)
    rank = group.rank()
    cuda = device.type == "cuda"
    records = []
    for name, run in TP_TRAIN_RUNS[args.launch]:
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        argv = (run + TP_TRAIN_ARGV + ["--device", args.device]
                + (["--smoke"] if args.smoke else [])
                + (["--seq", args.seq] if args.seq else [])
                + (["--ckpt-dir", os.path.join(args.ckpt, "tp")]
                   if name.startswith("whisper") else []))
        t0 = time.perf_counter()
        with TrainSteps() as rec:
            rc = train.main.__wrapped__(argv)
        wall = time.perf_counter() - t0
        if name == "whisper-base to step 2" and rank == 0:
            shutil.copytree(os.path.join(args.ckpt, "tp"),
                            os.path.join(args.ckpt, "one"))
        records.append({
            "name": name, "rc": rc, "wall_s": wall,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if cuda else 0.0),
            "steps": rec.steps})
        rec.last = None
        del rec
    with open(f"{args.out}.rank{rank}.json", "w") as f:
        json.dump(records, f)
    del group
    mesh.close_group()
    return 0


def tp_train_start(launch, ckpt_dir):
    """Start one phase 20 launch (`tp_start`); returns what
    `tp_train_collect` reads."""
    base = os.path.join(ckpt_dir, f"run-{launch.replace(' ', '-')}")
    started = tp_start(TP_TRAIN_WORLD[launch], [
        os.path.abspath(__file__), "--tp-train-child", "--launch", launch,
        "--out", base, "--ckpt", ckpt_dir, "--device", DEVICE,
        *TP_TRAIN_CHILD_ARGV])
    return launch, base, started, time.perf_counter()


def tp_train_collect(card, begun) -> list:
    """Wait for a `tp_train_start` launch; returns each rank's records
    (rank order), after checking that every run exited 0 with finite
    metrics, the same on every rank, and no K4 launch in any step;
    prints each run's steps, per rank its seconds a step (median after
    the first), peak memory and a step's collectives by kind and
    bytes."""
    import statistics

    launch, base, started, t0 = begun
    world = TP_TRAIN_WORLD[launch]
    rc, out = tp_collect(f"launch {launch}, {world} ranks", started,
                         timeout=TP_TRAIN_TIMEOUT_S, phase="phase 20")
    wall = time.perf_counter() - t0
    check(rc == 0, f"phase 20: launch {launch}: torchrun exited {rc}")
    backend = "nccl" if launch == "4 cards" else "gloo"
    check(f"[group] world={world} backend={backend}" in out,
          f"phase 20: launch {launch} is not on {backend}")
    ranks = []
    for r in range(world):
        with open(f"{base}.rank{r}.json") as f:
            ranks.append(json.load(f))
    for i, (name, _) in enumerate(TP_TRAIN_RUNS[launch]):
        recs = [rk[i] for rk in ranks]
        for r, rec in enumerate(recs):
            check(rec["rc"] == 0, f"phase 20: {name} rank {r} exited "
                  f"{rec['rc']}")
            for j, st in enumerate(rec["steps"]):
                check(all(map(math.isfinite, (st["loss"], st["grad_norm"]))),
                      f"phase 20: {name} rank {r} step {j + 1} not finite")
                check(st["launches"]["flash"] == 0,
                      f"phase 20: {name} rank {r} step {j + 1} launched K4 "
                      f"{st['launches']['flash']} times")
                check((st["loss"], st["grad_norm"]) ==
                      (recs[0]["steps"][j]["loss"],
                       recs[0]["steps"][j]["grad_norm"]),
                      f"phase 20: {name}: the ranks' step {j + 1} metrics "
                      f"differ")
        steps = recs[0]["steps"]
        per_rank = "; ".join(
            f"rank {r} {statistics.median(x['s'] for x in rec['steps'][1:] or rec['steps']):.3f} s/step, "
            f"peak {rec['peak_gib']:.2f} GiB, collectives a step "
            + ", ".join(f"{k} {n} ({b / 2**20:.0f} MiB)"
                        for k, (n, b) in rec["steps"][-1]["collectives"]
                        .items())
            for r, rec in enumerate(recs))
        log(f"phase 20: launch {launch}: {name}: losses "
            f"{[round(x['loss'], 5) for x in steps]}, grad norms "
            f"{[round(x['grad_norm'], 4) for x in steps]}, step s "
            f"{[round(x['s'], 3) for x in steps]}; {per_rank}; K4 launches "
            f"0 in every step of every rank; run wall "
            f"{recs[0]['wall_s']:.1f} s on {card}")
    log(f"phase 20: launch {launch} ({world} ranks) in {wall:.1f}s")
    return ranks


def tp_train_first_step(name, rec, arch) -> None:
    """A launch's first step against phase 18's one-device first step of
    `arch` on the same weights and batch."""
    loss, gnorm = rec["steps"][0]["loss"], rec["steps"][0]["grad_norm"]
    want = RESULTS.get(f"first step {arch}")
    check(want is not None, f"phase 20: no phase 18 first step of {arch}")
    dl, dg = abs(loss - want[0]), abs(gnorm - want[1])
    log(f"phase 20: {name}: first step loss {loss:.5f} gnorm {gnorm:.5f}, "
        f"one device (phase 18) {want[0]:.5f} / {want[1]:.5f}: apart "
        f"{dl:.5f} / {dg:.5f} (limits {TRAIN_LOSS_ATOL} / "
        f"{TRAIN_GNORM_ATOL})")
    check(dl <= TRAIN_LOSS_ATOL and dg <= TRAIN_GNORM_ATOL,
          f"phase 20: {name}: first step {loss} / {gnorm} vs one device "
          f"{want}")


def tp_train_phase(card) -> dict:
    """Phase 20: sharded training (see `TP_TRAIN_RUNS`).  Returns K4's
    launches per rank per step by run (all 0)."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import train

    t_phase = time.perf_counter()
    gc.collect()                  # the earlier phases' weights: the
    torch.cuda.empty_cache()      # ranks need the card's memory
    ckpt_dir = tempfile.mkdtemp(prefix="tp-train-",
                                dir=os.path.join(ROOT, "build"))
    launches = {}
    try:
        # launches A and B run at once (35 + 25 GiB of the card's 80)
        begun_b = tp_train_start("B", ckpt_dir)
        a = tp_train_collect(card, tp_train_start("A", ckpt_dir))
        tp_train_first_step("launch A qwen3-1.7b at model 2", a[0][0],
                            "qwen3-1.7b")
        # whisper-base's step 3 on one device from launch A's step-2
        # checkpoint, against launch A's own resumed step 3
        argv = (["--arch", "whisper-base", "--steps", "3", "--device",
                 DEVICE, "--ckpt-dir", os.path.join(ckpt_dir, "one")]
                + TP_TRAIN_ARGV + TP_TRAIN_CHILD_ARGV)
        with TrainSteps() as rec, contextlib.redirect_stdout(None):
            rc = train.main(argv)
        check(rc == 0 and len(rec.steps) == 1,
              f"phase 20: one-device resume exited {rc} after "
              f"{len(rec.steps)} step(s), want 1")
        one, tp3 = rec.steps[0], a[0][2]["steps"][0]
        dl, dg = (abs(one["loss"] - tp3["loss"]),
                  abs(one["grad_norm"] - tp3["grad_norm"]))
        log(f"phase 20: whisper-base step 3 resumed from the model-2 "
            f"checkpoint of step 2: one device loss {one['loss']:.5f} gnorm "
            f"{one['grad_norm']:.5f}, model 2 {tp3['loss']:.5f} / "
            f"{tp3['grad_norm']:.5f}: apart {dl:.5f} / {dg:.5f} (limits "
            f"{TRAIN_LOSS_ATOL} / {TRAIN_GNORM_ATOL}) on {card}")
        check(dl <= TRAIN_LOSS_ATOL and dg <= TRAIN_GNORM_ATOL,
              f"phase 20: whisper-base elastic resume {one} vs {tp3}")
        check(one["launches"]["flash"] == 0, "phase 20: the one-device "
              "resume launched K4")
        rec.last = None
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        b = tp_train_collect(card, begun_b)
        tp_train_first_step("launch B granite-moe-1b-a400m at data 2 x "
                            "model 2", b[0][0], "granite-moe-1b-a400m")
        runs = {"A": a, "B": b}
        if torch.cuda.device_count() >= 4:
            runs["4 cards"] = tp_train_collect(
                card, tp_train_start("4 cards", ckpt_dir))
        else:
            log(f"phase 20: jamba-v0.1-52b (8 layers, model 4) and "
                f"qwen2-vl-72b (4 layers, data 2 x model 2) on 4 cards "
                f"skipped: {torch.cuda.device_count()} card(s) visible")
        for launch, ranks in runs.items():
            for i, (name, _) in enumerate(TP_TRAIN_RUNS[launch]):
                launches[name] = [[st["launches"]["flash"]
                                   for st in rk[i]["steps"]] for rk in ranks]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"phase 20: sharded training in {time.perf_counter() - t_phase:.1f}s")
    return launches

# ------------------------------------------------------------ phase 21 --
# The dry-run's cells (`repro_torch.launch.dryrun`): the graph cell on
# the card, then LM cells on `meta` tensors on the production grids (a
# fake process group of 256 or 512 ranks): a dense train step, a prefill
# with MoE and K4, a long-context hybrid decode, a train step on the
# two-pod grid, whisper-base's prefill under 'dp_replicated' (K4 on every
# head, 18 calls) and minitron-4b's train step under 'tp2d' with its 24
# heads whole over a model axis of 16.
DRYRUN_CELLS = [("qwen3-1.7b", "train_4k", "single"),
                ("granite-moe-1b-a400m", "prefill_32k", "single"),
                ("jamba-v0.1-52b", "long_500k", "single"),
                ("qwen2-vl-72b", "train_4k", "multi"),
                ("whisper-base", "prefill_32k", "single"),
                ("minitron-4b", "train_4k", "multi")]
DRYRUN_LIMIT_S = 90.0
DRYRUN_TERMS = ("flops_per_device", "bytes_per_device",
                "coll_bytes_per_device", "coll_breakdown", "model_flops",
                "peak_memory_bytes", "compute_s", "memory_s", "collective_s",
                "bottleneck", "useful_flops_ratio", "step_time_s",
                "roofline_fraction", "compile_seconds", "kernel_calls",
                "kernel_compares", "count", "max_needed", "overflowed")


def dryrun_phase(card) -> dict:
    """Phase 21: `launch.dryrun`'s cells through `run_cell`, as `python
    -m repro_torch.launch.dryrun` runs them.  The graph cell counts rank
    0's stripe on the card: K1's launches (counters set to 0 just before
    it, read just after) must equal the kernel calls its walk recorded,
    and its count and frontier demand must equal a count of the same
    stripe on one device outside the walk.  Each LM cell runs on meta
    tensors: no kernel launched, K4 recorded once per flash-eligible
    attention call of a prefill (`transformer.flash_calls`).  Each
    cell's terms print on a line of their own; the phase must take
    less than DRYRUN_LIMIT_S."""
    import tempfile

    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import flash_calls

    t_phase = time.perf_counter()
    out = {"launches": {}, "flash": {}}
    graph = dryrun.graphpi_graph()          # made once, for both counts
    with tempfile.TemporaryDirectory() as out_dir:
        ops.reset_launches()
        rec = dryrun.run_cell("graphpi", "count", "single", out_dir,
                              device=DEVICE, graph=graph)
        launched = {k: v for k, v in ops.launches.items() if v}
        log(f"phase 21: graphpi count single: K1 launches {launched}, "
            f"recorded {rec['kernel_calls']}")
        check(DEVICE == "cpu" or (launched and launched == rec["kernel_calls"]
                                  and set(launched) <= set(ops.K1_MODES)),
              f"graph cell's K1 launches {launched} != its recorded calls "
              f"{rec['kernel_calls']}")
        out["launches"] = launched
        with dryrun.fake_world(256):
            fn, a, v0, plan, _ = dryrun.graphpi_stripe(
                dryrun.production_grid("single"), device=DEVICE, graph=graph)
        cnt, needed = fn(a.indptr, a.degrees, a.flat, a.labs, v0)
        one = (int(cnt) // plan.iep_divisor, int(needed))
        check(one == (rec["count"], rec["max_needed"]),
              f"graph cell (count, max_needed) {rec['count']}, "
              f"{rec['max_needed']} != one device's {one}")
        del fn, a, v0
        log("phase 21: graphpi count single terms: " + json.dumps(
            {k: rec[k] for k in DRYRUN_TERMS if k in rec}))
        for arch, shape, mesh in DRYRUN_CELLS:
            ops.reset_launches()
            rec = dryrun.run_cell(arch, shape, mesh, out_dir)
            check(not any(ops.launches.values()),
                  f"{arch} {shape} {mesh}: launches on meta {ops.launches}")
            cfg = get_config(arch)
            # every prompt length here is a multiple of 512
            want = flash_calls(cfg) if SHAPES[shape].kind == "prefill" else 0
            got = rec["kernel_calls"].get("flash", 0)
            check(got == want, f"{arch} {shape}: K4 recorded {got} times, "
                               f"want {want}")
            out["flash"][f"{arch} {shape} {mesh}"] = got
            log(f"phase 21: {arch} {shape} {mesh} terms: " + json.dumps(
                {k: rec[k] for k in DRYRUN_TERMS if k in rec}))
    torch.cuda.empty_cache()
    dt = time.perf_counter() - t_phase
    log(f"phase 21: dry-run in {dt:.1f}s on {card}")
    check(dt < DRYRUN_LIMIT_S, f"phase 21 took {dt:.1f}s (limit "
                               f"{DRYRUN_LIMIT_S:g}s)")
    return out


# ------------------------------------------------------------ phase 22 --
# Attention whole on every model rank, through `launch.serve --model-axis`
# and `launch.train --model-axis` in one torchrun per run of ranks sharing
# the card (gloo; NCCL refuses two ranks on one device), random weights
# from seed 0, bf16; each rank serves, then trains, in the launch's group
# (`whole_child`):
#  * whisper-base whole at a model axis of 3 on 3 ranks: `pick_layout`
#    gives 'dp_replicated' (its 8 heads do not divide 3, its state fits):
#    every rank holds the whole model and 2 rows of a batch of 6; served
#    with a 2,048-token prompt and 16 tokens (18 K4 launches a rank a
#    prefill, on every head; none in decode), then 2 train steps of
#    6 x 1,024;
#  * minitron-4b at full width cut to 2 of its 32 layers at a model axis
#    of 16 on 16 ranks: 'tp2d' (its state does not fit), its 24 heads
#    whole on every rank, the MLP and the 256,000-row vocabulary split 16
#    ways; served with a batch of 2, a 1,024-token prompt and 4 tokens
#    in a cache of 1,040 positions, whose sequence splits over the 16
#    ranks (its 8 KV heads do not divide 16: flash-decoding with all 24
#    query heads on every rank) (2 K4 launches a rank a prefill, G = 3),
#    then one train step of 2 x 512 (this process's one-device reference
#    step holds 29 GB of masters, gradients and moments beside the
#    [2, S, 256,000] fp32 logits and their gradient; at S = 1,024 it
#    left the card little room).  16 is the smallest axis
#    that divides its 3,072 / 9,216 / 256,000 but not its 24 heads.
#    The 16 ranks draw their weights WHOLE_INIT_AT_ONCE at a time
#    (`staggered_init`): each draws the whole fp32 embedding (3.1 GB)
#    before it keeps its 1/16, and 16 at once would not fit the card.
#    The ranks run with the caching
#    allocator's expandable segments (`WHOLE_ENV`): with fixed segments
#    a rank's shards sit in the segments its whole parts were drawn in,
#    which empty_cache cannot return, and 16 such ranks do not fit.
# Each run's prefill logits lie within phase 8's limits of the one-device
# kernel path's on the same weights and prompts (made in this process
# before the launch), the first tokens agree wherever the one-device
# top-2 gap exceeds that distance, the ranks take the same tokens, and
# the first train step lies within phase 18's limits (TRAIN_LOSS_ATOL /
# TRAIN_GNORM_ATOL) of this process's one-device first step; every rank's
# step metrics are equal and finite, with no K4 launch in training.
WHOLE_RUNS = {
    "whisper-base": dict(
        world=3, layout="dp_replicated", k4=18,
        serve=["--arch", "whisper-base", "--batch", "6", "--prompt-len",
               "2048", "--gen", "16", "--model-axis", "3"],
        train=["--arch", "whisper-base", "--batch", "6", "--seq", "1024",
               "--steps", "2", "--model-axis", "3", "--log-every", "1"]),
    "minitron-4b": dict(
        world=16, layout="tp2d", k4=2,
        serve=["--arch", "minitron-4b", "--layers", "2", "--batch", "2",
               "--prompt-len", "1024", "--gen", "4", "--max-seq", "1040",
               "--model-axis", "16"],
        train=["--arch", "minitron-4b", "--layers", "2", "--batch", "2",
               "--seq", "512", "--steps", "1", "--model-axis", "16",
               "--log-every", "1"]),
}
WHOLE_INIT_AT_ONCE = 4
WHOLE_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
WHOLE_TIMEOUT_S = 300
WHOLE_LIMIT_S = 150.0


def _flag(argv, name, default=None):
    return argv[argv.index(name) + 1] if name in argv else default


def _without(argv, *names):
    """`argv` less each flag of `names` and its value."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in names:
            skip = True
        else:
            out.append(a)
    return out


@contextlib.contextmanager
def staggered_init(group, at_once):
    """`transformer.init` taken by `at_once` ranks of `group` at a time
    while open (a barrier after each turn; every rank makes the same
    calls), each rank handing its freed blocks back to the card after
    its turn (the caching allocator would keep the whole parts it drew
    reserved)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.models import transformer as T

    init, rank, world = T.init, group.rank(), group.size()

    def turns(*a, **kw):
        out = None
        for first in range(0, world, at_once):
            if first <= rank < first + at_once:
                out = init(*a, **kw)
                gc.collect()
                if torch.cuda.is_initialized():
                    torch.cuda.empty_cache()
            dist.barrier(group)
        return out

    T.init = turns
    try:
        yield
    finally:
        T.init = init


def whole_child(argv) -> int:
    """A rank of a phase 22 launch (`chip_smoke.py --whole-child --out
    F`, under torchrun): the serve argv of F.json through
    `launch.serve.main`'s body, K4's launches per phase recorded
    (`PhaseLaunches`), one more prefill of the served weights and
    prompts (rank 0 saves its logits to F.pt), then the train argv of
    F.json through `launch.train.main`'s body (`TrainSteps`); each rank
    writes its records to F.rank<r>.json."""
    import argparse
    import gc

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(f"{args.out}.json") as f:
        run = json.load(f)
    sv, tr = run["serve"], run["train"]
    import torch._dynamo  # noqa: F401  (before the group: launch.train's note)

    from repro_torch.launch import mesh, serve, train
    from repro_torch.serve.serve_step import make_prefill
    from repro_torch.serve.session import fake_prompts

    group, device = mesh.shared_group(_flag(sv, "--device"))
    rank, cuda = group.rank(), device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with staggered_init(group, WHOLE_INIT_AT_ONCE), PhaseLaunches() as rec:
        rc = serve.main.__wrapped__(sv)
    session = rec.sessions[0]
    m = session.metrics()
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    batch = fake_prompts(session.cfg, int(_flag(sv, "--batch")),
                         int(_flag(sv, "--prompt-len")), seed=0,
                         device=device)
    prefill = make_prefill(session.cfg, device, q_chunk=0, grid=session.grid)
    t0 = time.perf_counter()
    logits, _ = prefill(session._params, batch)
    if cuda:
        torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    if rank == 0:
        torch.save(logits.float().cpu(), f"{args.out}.pt")
    record = {
        "rc": rc, "phases": rec.records, "variants": rec.variants,
        "prefill_s": m["prefill_seconds"], "warm_prefill_s": warm,
        "decode_ms": m["ms_per_step"], "peak_gib": peak,
        "tokens": session.tokens_out()[:, 0].tolist(),
        "layout": session.layout, "rows": list(session._rows),
        "collectives": session.prefill_collectives,
        "split": [session.grid.data, session.grid.model]}
    del session, rec, prefill, logits, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with staggered_init(group, WHOLE_INIT_AT_ONCE), TrainSteps() as steps:
        record["train_rc"] = train.main.__wrapped__(tr)
    record["train_wall_s"] = time.perf_counter() - t0
    record["train_peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                                if cuda else 0.0)
    record["steps"] = steps.steps
    steps.last = None
    del steps
    with open(f"{args.out}.rank{rank}.json", "w") as f:
        json.dump(record, f)
    del group
    mesh.close_group()
    return 0


def whole_argvs(name) -> tuple[list, list]:
    """(serve argv, train argv) of `WHOLE_RUNS[name]` on DEVICE."""
    run = WHOLE_RUNS[name]
    return (run["serve"] + ["--device", DEVICE],
            run["train"] + ["--device", DEVICE])


def whole_references(name) -> dict:
    """This process's one-device references of `WHOLE_RUNS[name]`: the
    kernel-path prefill logits and the plain path's noise floor on the
    served weights and prompts (`one_device_logits`), and the first
    train step (loss, grad norm) on the trained batch."""
    import gc

    import torch

    from repro_torch.launch import train

    sv, tr = whole_argvs(name)
    logits, f_max, f_mean = one_device_logits(
        _flag(sv, "--arch"), int(_flag(sv, "--layers", 0)), DEVICE,
        rows=int(_flag(sv, "--batch")),
        prompt=int(_flag(sv, "--prompt-len")))
    argv = _without(tr, "--model-axis", "--steps") + ["--steps", "1"]
    with TrainSteps() as rec, contextlib.redirect_stdout(None):
        rc = train.main(argv)
    check(rc == 0 and len(rec.steps) == 1,
          f"phase 22: {name}: the one-device train step exited {rc} after "
          f"{len(rec.steps)} step(s)")
    first = (rec.steps[0]["loss"], rec.steps[0]["grad_norm"])
    rec.last = None
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    return {"logits": logits, "floor": (f_max, f_mean), "first": first}


def whole_run(card, name, ref, out_dir) -> list:
    """One phase 22 launch (`whole_child` on `WHOLE_RUNS[name]`'s world)
    checked against this process's one-device `ref`; returns K4's
    launches per rank per prefill."""
    import statistics

    import torch

    run = WHOLE_RUNS[name]
    world, want = run["world"], run["k4"]
    sv, tr = whole_argvs(name)
    base = os.path.join(out_dir, name)
    with open(f"{base}.json", "w") as f:
        json.dump({"serve": sv, "train": tr}, f)
    t0 = time.perf_counter()
    rc, out = tp_launch(f"{name}, {world} ranks, one card", world,
                        [os.path.abspath(__file__), "--whole-child",
                         "--out", base], timeout=WHOLE_TIMEOUT_S,
                        phase="phase 22", env=WHOLE_ENV)
    wall = time.perf_counter() - t0
    check(rc == 0, f"phase 22: {name}: torchrun exited {rc}")
    check(f"[group] world={world} backend=gloo" in out,
          f"phase 22: {name}: the ranks sharing the card are not on gloo")
    recs = []
    for r in range(world):
        with open(f"{base}.rank{r}.json") as f:
            recs.append(json.load(f))
    B = int(_flag(sv, "--batch"))
    for r, rec in enumerate(recs):
        phases = [tuple(p) for p in rec["phases"]]
        check(rec["rc"] == 0 and rec["train_rc"] == 0,
              f"phase 22: {name} rank {r}: serve / train exited "
              f"{rec['rc']} / {rec['train_rc']}")
        check(rec["layout"] == run["layout"],
              f"phase 22: {name} rank {r}: layout {rec['layout']}, want "
              f"{run['layout']}")
        check(phases == [("prefill", want), ("decode", 0)],
              f"phase 22: {name} rank {r}: K4 launches {phases}, want "
              f"{want} in the prefill and none in decode")
        check(rec["variants"] == [{"scalar": 0, "wgmma": n}
                                  for _, n in phases],
              f"phase 22: {name} rank {r}: K4 kernels {rec['variants']}")
        check(rec["tokens"] == recs[0]["tokens"],
              f"phase 22: {name}: ranks took other tokens "
              f"{[x['tokens'] for x in recs]}")
        for j, st in enumerate(rec["steps"]):
            check(all(map(math.isfinite, (st["loss"], st["grad_norm"]))),
                  f"phase 22: {name} rank {r} step {j + 1} not finite")
            check(st["launches"]["flash"] == 0,
                  f"phase 22: {name} rank {r} step {j + 1} launched K4")
            check((st["loss"], st["grad_norm"]) ==
                  (recs[0]["steps"][j]["loss"],
                   recs[0]["steps"][j]["grad_norm"]),
                  f"phase 22: {name}: the ranks' step {j + 1} metrics "
                  f"differ")
        check(len(rec["steps"]) == int(_flag(tr, "--steps")),
              f"phase 22: {name} rank {r}: {len(rec['steps'])} steps")
    rows = [tuple(x["rows"]) for x in recs]
    if run["layout"] == "dp_replicated":
        n = B // world
        check(rows == [(r * n, n) for r in range(world)],
              f"phase 22: {name}: rows {rows}, want {n} a rank over all "
              f"{world}")
    tp = torch.load(f"{base}.pt")
    kl = ref["logits"]
    f_max, f_mean = ref["floor"]
    check(tp.shape == kl.shape and bool(torch.isfinite(tp).all()),
          f"phase 22: {name}: logits {tuple(tp.shape)} vs "
          f"{tuple(kl.shape)}, or not finite")
    d = (tp - kl.float()).abs()
    d_max, d_mean = float(d.max()), float(d.mean())
    top = kl.float().topk(2, dim=-1).values
    gap = (top[:, 0] - top[:, 1]).tolist()
    t_tok, o_tok = tp.argmax(-1).tolist(), kl.argmax(-1).tolist()
    served = recs[0]["tokens"]
    per_rank = "; ".join(
        f"rank {r} rows {x['rows']} prefill {x['prefill_s']:.4f} s (warm "
        f"{x['warm_prefill_s']:.4f} s), decode {x['decode_ms']:.3f} "
        f"ms/step, peak {x['peak_gib']:.2f} GiB, prefill collectives "
        + " ".join(f"{k}={v}" for k, v in x["collectives"].items() if v)
        for r, x in enumerate(recs))
    log(f"phase 22: {name} ({_flag(sv, '--layers', 'all')} layers) at "
        f"data x model = {recs[0]['split']}, layout {recs[0]['layout']}: "
        f"{per_rank}; vs one-device logits max_abs={d_max:.4f} "
        f"mean_abs={d_mean:.5f} (limits {PREFILL_MAX_ABS} / "
        f"{PREFILL_MEAN_ABS}; one-device plain vs fp32 attention noise "
        f"floor max_abs={f_max:.4f} mean_abs={f_mean:.5f}); first tokens "
        f"{t_tok} served {served} one-device {o_tok} (top-2 gaps "
        f"{', '.join(f'{g:.4f}' for g in gap)}) on {card}")
    check(d_max <= PREFILL_MAX_ABS and d_mean <= PREFILL_MEAN_ABS,
          f"phase 22: {name}: logits max {d_max} mean {d_mean} from one "
          f"device's")
    for b, g in enumerate(gap):
        if g > d_max:
            check(t_tok[b] == o_tok[b] == served[b],
                  f"phase 22: {name} row {b}: first token {t_tok[b]} "
                  f"served {served[b]} one-device {o_tok[b]} (gap {g:.4f} "
                  f"> {d_max:.4f})")
    steps = recs[0]["steps"]
    loss, gnorm = steps[0]["loss"], steps[0]["grad_norm"]
    dl, dg = abs(loss - ref["first"][0]), abs(gnorm - ref["first"][1])
    per_rank = "; ".join(
        f"rank {r} {statistics.median(x['s'] for x in rec['steps'][1:] or rec['steps']):.3f} s/step, "
        f"peak {rec['train_peak_gib']:.2f} GiB, collectives a step "
        + ", ".join(f"{k} {c} ({b / 2**20:.0f} MiB)"
                    for k, (c, b) in rec["steps"][-1]["collectives"].items())
        for r, rec in enumerate(recs))
    log(f"phase 22: {name} train: losses "
        f"{[round(x['loss'], 5) for x in steps]}, grad norms "
        f"{[round(x['grad_norm'], 4) for x in steps]}; first step "
        f"{loss:.5f} / {gnorm:.5f}, one device {ref['first'][0]:.5f} / "
        f"{ref['first'][1]:.5f}: apart {dl:.5f} / {dg:.5f} (limits "
        f"{TRAIN_LOSS_ATOL} / {TRAIN_GNORM_ATOL}); {per_rank}; K4 0 in "
        f"every step of every rank on {card}")
    check(dl <= TRAIN_LOSS_ATOL and dg <= TRAIN_GNORM_ATOL,
          f"phase 22: {name}: first step {loss} / {gnorm} vs one device "
          f"{ref['first']}")
    log(f"phase 22: {name}: {world}-rank launch in {wall:.1f}s")
    return [want] * world


def whole_phase(card) -> dict:
    """Phase 22: `WHOLE_RUNS` (see above), one after the other, each
    after its one-device references.  Returns K4's launches per rank per
    prefill by run."""
    import gc
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    gc.collect()                  # the earlier phases' weights: the
    torch.cuda.empty_cache()      # ranks need the card's memory
    out_dir = tempfile.mkdtemp(prefix="whole-",
                               dir=os.path.join(ROOT, "build"))
    launches = {}
    try:
        for name in WHOLE_RUNS:
            ref = whole_references(name)
            launches[name] = whole_run(card, name, ref, out_dir)
            del ref
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    dt = time.perf_counter() - t_phase
    log(f"phase 22: attention whole on every model rank in {dt:.1f}s on "
        f"{card}")
    check(dt < WHOLE_LIMIT_S, f"phase 22 took {dt:.1f}s (limit "
                              f"{WHOLE_LIMIT_S:g}s)")
    return launches


# ------------------------------------------------------------- phase 1 --
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
    sharded = sharded_phase(card)
    for k in kernels:
        mode = k["name"].removeprefix("level_expand.")
        if mode in ("mask", "count", "signed"):
            k["sharded_launches"] = {run: [r[mode] for r in ranks]
                                     for run, ranks in sharded.items()}
    gateway_sharded = gateway_sharded_phase(card)
    for k in kernels:
        mode = k["name"].removeprefix("level_expand.")
        if mode in ("mask", "count", "signed"):
            k["gateway_sharded_launches"] = {
                run: [r[mode] for r in ranks]
                for run, ranks in gateway_sharded.items()}
    family = family_phase(card)
    for k in kernels:
        if k["name"] == "flash_attention":
            k["family_launches"] = family
    trained = train_phase(card)
    for k in kernels:
        if k["name"] == "flash_attention":
            k["train_launches"] = sum(sum(v) for v in trained.values())
            k["train_launches_per_step"] = trained
    tp = tp_phase(card)
    for k in kernels:
        if k["name"] == "flash_attention":
            k["tp_launches"] = tp
    tp_train = tp_train_phase(card)
    for k in kernels:
        if k["name"] == "flash_attention":
            k["tp_train_launches"] = tp_train
    dry = dryrun_phase(card)
    for k in kernels:
        mode = k["name"].removeprefix("level_expand.")
        if mode in ("mask", "count", "signed"):
            k["dryrun_launches"] = dry["launches"].get(mode, 0)
        if k["name"] == "flash_attention":
            k["dryrun_meta_calls"] = dry["flash"]
    whole = whole_phase(card)
    for k in kernels:
        if k["name"] == "flash_attention":
            k["whole_launches"] = whole
    log(f"done in {time.perf_counter() - t_all:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-child"]:
        sys.exit(tp_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-train-child"]:
        sys.exit(tp_train_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--whole-child"]:
        sys.exit(whole_child(sys.argv[2:]))
    sys.exit(main())
