"""Multi-pod dry-run: one rank's step of every (arch × shape × mesh) cell
on the production grid, recorded op by op, and its roofline terms.

Counterpart of `repro/launch/dryrun.py`, with its flags and its
`[dryrun OK]` / `[dryrun FAIL]` lines, plus `--device` (default
`cuda`), which only the graph cell uses.  The reference lowers and
compiles each cell against 512 placeholder devices and reads XLA's
cost analysis; the port has no compiler to ask, so for each LM cell
this:
  1. opens a `fake` process group of the grid's world (256 ranks for
     one pod, 512 for two) as rank 0 (`fake_world`): its collectives
     return at once and move nothing;
  2. builds the grid with its model and data subgroups
     (`production_grid`);
  3. builds rank 0's pieces of the params (and of the optimizer state)
     and the batch (and the decode cache) on `meta` tensors: shapes and
     dtypes, no storage (`abstract_params`' counterpart);
  4. runs the train, prefill or decode step once under
     `roofline.op_cost.OpCost`, which records every aten op (K4 through
     its wrapper's `meta` route), the collectives' bytes and the peak;
  5. writes the roofline terms (`roofline.analysis`) as JSON.

The graph cell (`--arch graphpi`) cannot run on `meta` tensors: its
frontier sizes are data (`core/executor.py` reads them to size each
level).  It counts rank 0's stripe of the roots for real on `--device`
in one pass at the reference's capacity (K1 launched on a card; its
work is counted from `roofline.kernels`).

The fake group comes from `torch.testing._internal.distributed.fake_pg`,
a private module of PyTorch: `fake_world` checks for it and says so
where it is missing.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh multi --out artifacts/dryrun
  python -m repro_torch.launch.dryrun --arch graphpi --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch


def model_flops_estimate(cfg, shape) -> float:
    """6·N_active·D for train (fwd+bwd), 2·N_active·D for serving."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch            # one new token per sequence
    return 2.0 * n * tokens


def flash_kernel_flops(cfg, shape, mesh) -> float:
    """Per-DEVICE MXU flops of the stubbed Pallas flash-attention calls.

    Engages only where layers._flash_sharded would: prefill, Sq == Sk,
    S % 512 == 0, hd <= 128.  qk^T + pv = 4·B·H·S²·hd, halved for causal
    masking (block-skipped above the diagonal).  Sharding: batch over the
    data axes and — when H divides |model| — heads over `model`;
    otherwise the kernel is replicated over `model` (dp-only fallback)."""
    if shape.kind != "prefill" or cfg.n_heads == 0:
        return 0.0
    S, B = shape.seq_len, shape.global_batch
    if S % 512 or cfg.head_dim > 128:
        return 0.0
    from ..models.transformer import layer_kinds

    n_causal = sum(1 for k in layer_kinds(cfg) if k == "attn")
    # whisper: bidirectional encoder self-attn + per-decoder-layer cross
    n_full = cfg.enc_layers + (cfg.n_layers if cfg.family == "encdec" else 0)
    per_layer = 4.0 * B * cfg.n_heads * float(S) ** 2 * cfg.head_dim
    total = per_layer * (0.5 * n_causal + n_full)
    mdl = mesh.shape.get("model", 1)
    ndp = 1
    for a in ("pod", "data"):
        if a in mesh.shape and B % (ndp * mesh.shape[a]) == 0:
            ndp *= mesh.shape[a]
    shards = ndp * (mdl if cfg.n_heads % mdl == 0 else 1)
    return total / shards


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a `fake` process group of `world` ranks
    (PyTorch's test backend: collectives return at once, moving
    nothing); destroyed on exit."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry-run needs PyTorch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), a private "
            "module this PyTorch build lacks") from e
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already "
                           "initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_grid(mesh_name: str):
    """Rank 0's grid of the production mesh `mesh_name` in the open fake
    world, with its model and data subgroups (`make_grid`).  The
    multi-pod grid carries the ("pod", "data") axes `sharding.dp_axes`
    reads; its data group is the 32 ranks of both."""
    from .mesh import make_grid, make_production_grid

    like = make_production_grid(multi_pod=mesh_name == "multi")
    g = make_grid(model=like.model)
    return dataclasses.replace(g, axis_names=like.axis_names,
                               sizes=like.sizes)


def lower_cell(arch: str, shape_name: str, grid, mesh_name: str, *,
               opts=None):
    """Record rank 0's step of one LM cell on `meta`; returns (OpCost
    record, model_flops).  The counterpart of the reference's
    `lower_cell` (its lower + compile)."""
    from ..configs import SHAPES, get_config, input_specs
    from ..convert import shard_params
    from ..models import transformer as T
    from ..roofline.op_cost import OpCost
    from ..serve.serve_step import (cast_params_for_serving, make_decode,
                                    make_prefill)
    from ..train.optimizer import AdamWConfig, init_opt_state
    from ..train.train_step import TrainOptions, make_train_step

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mf = model_flops_estimate(cfg, shape)
    rec = OpCost(grid)
    if shape.kind == "train":
        batch = input_specs(cfg, shape)
        step = make_train_step(cfg, AdamWConfig(), opts or TrainOptions(),
                               device="meta", grid=grid)
        params = T.init(cfg, 0, "meta", shard=lambda part: shard_params(
            part, cfg, grid, zero=True))
        opt = init_opt_state(params)
        rec.hold(params, opt, batch)
        with rec:
            step(params, opt, batch)
        return rec, mf
    # serving holds its weights cast (`LMSession`), so the step's cast
    # is free, as it is there
    dtype = getattr(torch, cfg.dtype)
    params = T.init(cfg, 0, "meta",
                    cast=lambda p: cast_params_for_serving(p, dtype),
                    shard=lambda part: shard_params(part, cfg, grid))
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        fn = make_prefill(cfg, "meta", grid=grid)
        rec.hold(params, batch)
        with rec:
            fn(params, batch)
        return rec, mf
    B, S = shape.global_batch, shape.seq_len
    cache = T.init_cache(cfg, B, S, device="meta", grid=grid)
    tok = input_specs(cfg, shape)["tokens"]
    fn = make_decode(cfg, "meta", grid=grid, batch=B, max_seq=S)
    rec.hold(params, tok, cache)
    with rec:
        fn(params, tok, cache, S - 1)
    return rec, mf


def graphpi_graph():
    """The paper's cell's graph: rmat(16, 12, seed=0), 65k vertices."""
    from ..graph.datasets import rmat

    return rmat(16, 12, seed=0)


def graphpi_stripe(grid, *, device="cuda", graph=None):
    """The paper's cell as the reference's `lower_graphpi` builds it:
    house with the IEP plan of `search_configuration`, capacity 2^15,
    `auto_buckets`, and the grid's rank's stripe of the roots over its
    n data-axis ranks (16 or 32; rank d holds d, d + n, ...).  Returns
    (count, arrays, v0, plan, capacity): `count(indptr, degrees, flat,
    labs, v0)` is one pass of the single-device count function at that
    capacity, as the reference's lowered program."""
    from ..core.config_search import search_configuration
    from ..core.executor import (ExecutorConfig, _bs_iters, _make_count_fn,
                                 auto_buckets, device_graph)
    from ..core.pattern import house
    from ..core.perf_model import GraphStats
    from ..device import resolve_device

    dev = resolve_device(device)
    g = graphpi_graph() if graph is None else graph
    stats = GraphStats(g.n, g.m, tri_cnt=max(g.m, 1))  # plan-time proxy
    plan = search_configuration(house(), stats, use_iep=True).plan(house())
    cfg = ExecutorConfig(capacity=1 << 15, degree_buckets=auto_buckets(g))
    W = max(g.max_degree, 1)
    fn = _make_count_fn(plan, W, _bs_iters(W), cfg, device=dev)
    nsh = grid.data
    per = -(-g.n // nsh)
    v0 = np.full(nsh * per, g.n, dtype=np.int32)
    v0[: g.n] = np.arange(g.n, dtype=np.int32)
    v0 = v0.reshape(per, nsh).T[grid.data_rank]
    return (fn, device_graph(g, dev),
            torch.as_tensor(np.ascontiguousarray(v0), device=dev), plan,
            cfg.capacity)


def lower_graphpi(grid, mesh_name: str, *, device="cuda", graph=None):
    """Record the paper's cell (`graphpi_stripe`): rank 0's stripe
    counted for real on `device` under `OpCost` (K1 launched on a card,
    its work counted from `roofline.kernels`).  Returns (record, 0.0,
    {"count", "max_needed", "overflowed"}): rank 0's share of the count
    at capacity 2^15, exact where `max_needed` fits it, as the
    reference's program's.  Its collectives, the reference's psum and
    pmax of two scalars, are counted, not run."""
    from ..kernels import ops
    from ..roofline.op_cost import OpCost

    fn, a, v0, plan, cap = graphpi_stripe(grid, device=device, graph=graph)
    ops.prepare(v0.device)
    rec = OpCost(grid)
    rec.hold(a, v0)
    with rec:
        cnt, needed = fn(a.indptr, a.degrees, a.flat, a.labs, v0)
        cnt, needed = int(cnt), int(needed)
    rec.coll = {"all-reduce": 2.0 * 2 * 8}      # ring x2, two int64
    return rec, 0.0, {"count": cnt // plan.iep_divisor,
                      "max_needed": needed, "overflowed": needed > cap}


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str, *,
             device="cuda", graph=None):
    """One cell: its record written to `<out_dir>/<arch>__<shape>__
    <mesh>.json` and a `[dryrun OK]` line; returns the record."""
    from ..roofline.analysis import analyze
    from .mesh import make_production_grid

    like = make_production_grid(multi_pod=(mesh_name == "multi"))
    chips = like.size
    t0 = time.time()
    extra = {}
    with fake_world(chips):
        grid = production_grid(mesh_name)
        if arch == "graphpi":
            rec, mf, extra = lower_graphpi(grid, mesh_name, device=device,
                                           graph=graph)
        else:
            rec, mf = lower_cell(arch, shape_name, grid, mesh_name)
    dt = time.time() - t0
    r = analyze(arch, shape_name, mesh_name, chips, rec, mf)
    out = r.to_json()
    out["compile_seconds"] = dt             # the walk's seconds
    out["memory_analysis"] = (f"arguments={rec.args_bytes} "
                              f"high_water={rec.high}")
    out["kernel_calls"] = dict(rec.kernels)
    out["kernel_compares"] = rec.compares
    out.update(extra)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(
        f"[dryrun OK] {arch} × {shape_name} × {mesh_name}: "
        f"walk={dt:.1f}s compute={r.compute_s:.4f}s memory={r.memory_s:.4f}s "
        f"collective={r.collective_s:.4f}s bottleneck={r.bottleneck} "
        f"useful={r.useful_flops_ratio:.2f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="where the graph cell counts (the LM cells run "
                         "on meta tensors)")
    args = ap.parse_args(argv)

    from ..configs import ARCHS, supported_shapes

    cells = []
    if args.all:
        for a in ARCHS:
            for s in supported_shapes(a):
                cells.append((a, s))
        cells.append(("graphpi", "count"))
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        shapes = [args.shape] if args.shape else (
            ["count"] if args.arch == "graphpi"
            else supported_shapes(args.arch))
        cells = [(args.arch, s) for s in shapes]

    failures = []
    for a, s in cells:
        try:
            run_cell(a, s, args.mesh, args.out, device=args.device)
        except Exception as e:
            failures.append((a, s, repr(e)))
            print(f"[dryrun FAIL] {a} × {s} × {args.mesh}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")


if __name__ == "__main__":
    main()
