#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero without them, and when
run outside a checkout of this repository.  Phases, one line each:

 1. the card's name and power limit (`nvidia-smi`), then K1
    (`src/repro_torch/kernels/csrc/level_expand.cu`) built with nvcc for
    sm_90a from the checkout's sources;
 2. K1 against its plain PyTorch version on the card, bit-equal, on
    windows of the wiki-vote-syn CSR at main-path shapes (B = 32768,
    D ∈ {128, 1024, 1917}, P ∈ {1, 2, 3}) in mask, count and signed mode;
 3. `repro_torch.launch.mine` on tiny-er for P1–P6, enum and --use-iep
    (plus the graphzero IEP plans of P1 and P4, which fold a tail);
    counts held to the reference oracle's values;
 4. full size, wiki-vote-syn (8,192 vertices, 79,597 edges): the
    triangle count on both paths; P1 on the kernel path under the
    graphpi plan, the graphzero plan with and without its IEP tail and
    the naive plan (÷ |Aut|); both paths on a slice of the roots.  Then
    small-rmat: P1 under the graphpi, graphzero and naive plans, enum
    and IEP, on both paths;
 5. K1's launches in the named main-path runs: mask and count in the
    wiki-vote-syn P1 graphpi count, signed in the graphzero IEP count;
 6. K1's time per launch on the largest real main-path launch of each
    mode, beside its plain version's and the card's bound.

Every count of phases 3–4 sets K1's launch counters to 0 just before it
and reads them just after; a kernel-path count must launch exactly the
modes its plan needs, a portable-path count none.

Counts are integers and every comparison is exact (no tolerance).  The
last two lines are the kernels record and the device record (JSON).
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
    """Wraps `ops.level_expand` to keep, for each mode in `modes`, the
    arguments of the largest launch (by B·D) of one count — the inputs
    phase 6 times."""

    def __init__(self, ops, modes):
        self.ops = ops
        self.real = ops.level_expand
        self.modes = modes
        self.best = {}

    def __call__(self, cand, flat, starts, lens, extra=None,
                 cand_valid=None, **kw):
        mode = ("mask" if not kw.get("count")
                else "count" if kw.get("neg_from") is None else "signed")
        size = cand.numel()
        if mode in self.modes and size > self.best.get(mode, (0,))[0]:
            keep = [None if a is None else a.clone()
                    for a in (cand, starts, lens, extra, cand_valid)]
            self.best[mode] = (size, keep, dict(kw))
        return self.real(cand, flat, starts, lens, extra, cand_valid, **kw)

    def __enter__(self):
        self.ops.level_expand = self
        return self

    def __exit__(self, *exc):
        self.ops.level_expand = self.real
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
    return res.count // aut_divisor, wall, state.dispatches, res, launches


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[smoke] FAIL: torch.cuda.is_available() is False",
              flush=True)
        return 1
    from repro_torch.configs.graphpi import get_dataset, get_pattern
    from repro_torch.core.executor import (ExecutorConfig, auto_buckets,
                                           device_graph, triangle_plan)
    from repro_torch.device import gpu_report
    from repro_torch.kernels import intersect, ops
    from repro_torch.kernels.ref import level_expand_ref
    from repro_torch.launch import mine

    t_all = time.perf_counter()
    card = gpu_report()
    # ---- 1: card + build
    log(f"phase 1: card: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = intersect.build()
    intersect.load()
    log(f"phase 1: built {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.2f}s")
    for line in intersect.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"phase 1: ptxas: {line.strip()}")

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
            k: run_launches[k] - res.launches[k] for k in run_launches},
            tri, True)
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
        config, plan = mine.plan_for(house, stats, mode=mode, use_iep=iep)
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
    config, plan = mine.plan_for(house, stats, mode="graphpi")
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
            config, plan = mine.plan_for(house, sstats, mode=mode,
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

    # ---- 5: launch counters of the named main-path runs
    for mode in ("mask", "count", "signed"):
        n, what = main_launches[mode]
        log(f"phase 5: K1 {mode}: {n} launches in the {what} count")
        check(n > 0, f"K1 {mode} mode never launched in the {what} count")

    # ---- 6: per-launch time on the largest real launch of each mode
    best = {m: b for r in recorders for m, b in r.best.items()}
    kernels = []
    for mode in ("mask", "count", "signed"):
        check(mode in best, f"no recorded {mode} launch")
        _, (cand, starts, lens, extra, valid), kw = best[mode]
        args = (cand, arrays.flat, starts, lens, extra, valid)
        got = intersect.level_expand_cuda(*args, dirs=tuple(kw["dirs"]),
                                          count=kw["count"],
                                          neg_from=kw.get("neg_from"),
                                          window=kw["window"])
        want = level_expand_ref(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 != plain on recorded {mode}")
        errs.append(0.0)
        ms = time_ms(lambda: intersect.level_expand_cuda(
            *args, dirs=tuple(kw["dirs"]), count=kw["count"],
            neg_from=kw.get("neg_from"), window=kw["window"]))
        plain_ms = time_ms(lambda: level_expand_ref(*args, **kw), iters=5)
        bound_ms, bound_by = bound_of(cand, starts, lens, extra, valid,
                                      kw["count"], kw["window"])
        B, D = cand.shape
        log(f"phase 6: K1 {mode}: B={B} D={D} P={starts.shape[0]} "
            f"E={len(kw['dirs'])} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) on {card}")
        kernels.append({
            "name": f"level_expand.{mode}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/level_expand.cu",
            "replaces": "src/repro/kernels/intersect.py:220",
            "launches": main_launches[mode][0], "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        })
    log(f"done in {time.perf_counter() - t_all:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
