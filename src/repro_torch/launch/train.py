"""End-to-end training launcher (fault-tolerant).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 300 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

Counterpart of `repro/launch/train.py`, with its flags and its
`step k/N loss= gnorm= lr= tok/s=` lines, plus `--device` (default
`cuda`, which raises without a card; `--device cpu --smoke` trains the
reduced same-family config on the CPU).  Fault tolerance:

 * periodic atomic checkpoints of {"p": params, "o": opt_state}
   (`train/checkpoint.py`);
 * resume: picks up from LATEST automatically; the data pipeline is a
   pure function of the step, so the stream continues exactly;
 * SIGTERM / SIGINT (preemption) with `--ckpt-dir`: checkpoint after
   the current step, exit 0 (without one, as in the reference, the run
   goes on);
 * elastic: a checkpoint holds whole leaves, so a run resumes under
   another grid, or on one device, than the one that wrote it.

Sharded training: under torchrun the ranks form a data × model grid
(`--model-axis M`, any divisor of the world; `launch.mesh.make_grid`)
and train under the layout the reference's `pick_layout` gives
(`train.train_step`): 'tp2d', tensor parallelism over the model axis
and ZeRO-3 over the data axis, or 'dp_replicated' (whisper-base at a
model axis of 3 or 16), every leaf whole on every rank and the batch
split over all of them.  Gloo when
ranks share a card or run on the CPU, NCCL with a card each
(`mesh.backend_rule`).  Rank 0 prints the step lines and one `[train]
rank r:` line per rank (the last step it ran; its seconds a step,
median after the first;
its peak device memory; the last step's collectives by kind, with
their bytes); the ranks agree after every step whether a signal
arrived, so all of them checkpoint the same step; every rank exits
with the same code.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --device cpu --model-axis 2 --steps 4 --batch 4 --seq 16
"""
from __future__ import annotations

import argparse
import signal
import statistics
import sys
import time

from .mesh import leaves_group


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="tensor-parallel ranks per model replica (must "
                         "divide the torchrun world)")
    ap.add_argument("--layers", type=int, default=0,
                    help="decoder layers (default: the config's)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def _quiet(*_a, **_kw) -> None:
    pass


@leaves_group
def main(argv=None) -> int:
    args = parse_args(argv)

    from ..configs import get_config, get_smoke_config
    from ..device import resolve_device
    from ..parallel.sharding import pick_layout
    from ..train import checkpoint as ckpt
    from ..train.data import DataConfig, SyntheticLM
    from ..train.optimizer import AdamWConfig, init_opt_state
    from ..train.train_step import (TrainOptions, abstract_params,
                                    init_train_state, make_train_step,
                                    state_pieces)
    from .mesh import launched_sharded, shared_grid, shared_group

    group = grid = None
    log = print
    if launched_sharded():
        # remat (torch.utils.checkpoint) imports torch._dynamo at its
        # first call; imported while a process group is up, it keeps the
        # group referenced past `close_group`, whose gloo threads then
        # may abort the rank at exit: import it before the group
        import torch._dynamo  # noqa: F401

        group, device = shared_group(args.device)
        grid = shared_grid(model=args.model_axis)
        if group.rank() != 0:
            log = _quiet
    else:
        if args.model_axis != 1:
            raise ValueError(f"a model axis of {args.model_axis} does not "
                             f"divide the world of 1 rank(s) (train under "
                             f"torchrun --nproc-per-node)")
        device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    layout = None if grid is None else pick_layout(cfg, grid)
    step_fn = make_train_step(
        cfg, opt_cfg,
        TrainOptions(remat=True, q_chunk=0, loss_chunk=0,
                     accum_steps=args.accum),
        device=device, grid=grid, layout=layout)
    pieces = None if grid is None else state_pieces(cfg, grid, layout)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        like = abstract_params(cfg)
        tree, start = ckpt.restore(
            args.ckpt_dir, {"p": like, "o": init_opt_state(like)},
            device=device, pieces=pieces, grid=grid, cfg=cfg)
        params, opt_state = tree["p"], tree["o"]
        log(f"[train] resumed from step {start}")
    else:
        params, opt_state = init_train_state(cfg, seed=0, device=device,
                                             grid=grid, layout=layout)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch), cfg)
    stop = {"now": False}

    def _sig(_s, _f):
        stop["now"] = True

    saved = {s: signal.signal(s, _sig) for s in (signal.SIGTERM,
                                                  signal.SIGINT)}
    walls, collectives, stopping = [], {}, False
    try:
        t0 = time.time()
        tokens_done = 0
        for s in range(start, args.steps):
            before = _collectives()
            t1 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 data.batch(s))
            loss = float(metrics["loss"])        # waits for the step
            walls.append(time.perf_counter() - t1)
            collectives = _collectives(before)
            tokens_done += args.batch * args.seq
            if (s + 1) % args.log_every == 0:
                dt = time.time() - t0
                log(
                    f"step {s+1}/{args.steps} "
                    f"loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e} "
                    f"tok/s={tokens_done/dt:.0f}", flush=True)
            # the handler may set the flag during the reduction: the
            # ranks act on what they agreed, the flag is read again at
            # the next step
            stopping = (_any_rank(stop["now"]) if group is not None
                        else stop["now"])
            want_ckpt = args.ckpt_dir and (
                (s + 1) % args.ckpt_every == 0 or stopping
                or s + 1 == args.steps)
            if want_ckpt:
                ckpt.save(args.ckpt_dir, s + 1,
                          {"p": params, "o": opt_state}, pieces=pieces,
                          grid=grid)
                if stopping:
                    log(f"[train] preempted at step {s+1}; "
                        "checkpointed, exiting cleanly", flush=True)
                    break
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    if not (stopping and args.ckpt_dir):
        log("[train] done")
    if group is None:
        return 0
    from .mesh import agreed_exit

    for line in rank_lines(group, grid, device, walls, collectives,
                           start + len(walls), layout):
        log(line)
    return agreed_exit(group, 0)


def _collectives(before=None) -> dict:
    """`parallel.tp`'s collectives by kind: (calls, bytes), since
    `before` when given."""
    from ..parallel import tp

    now = {k: (tp.calls[k], tp.moved[k]) for k in tp.KINDS}
    if before is None:
        return now
    return {k: (n - before[k][0], b - before[k][1])
            for k, (n, b) in now.items() if n > before[k][0]}


def _any_rank(flag: bool) -> bool:
    """Whether any rank saw a signal (MAX over the world, a
    collective): every rank then checkpoints the same step."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(flag)], dtype=torch.int32)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def rank_lines(group, grid, device, walls, collectives, last,
               layout) -> list:
    """Every rank's `[train] rank r:` line (a collective): the last step
    it ran, seconds a step (the median after the first), peak device
    memory and the last step's collectives by kind, with their bytes;
    then the grid and its `layout`."""
    import torch

    from .mesh import gather

    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else 0.0)
    per_step = statistics.median(walls[1:] or walls) if walls else 0.0
    ranks = gather(group, (last, per_step, peak, collectives))
    return [f"[train] rank {r}: step={k} s/step={s:.4f} peak={gib:.2f}GiB "
            "collectives={" + ", ".join(
                f"{k}: {n} ({b / 2**20:.1f} MiB)"
                for k, (n, b) in coll.items()) + "}"
            for r, (k, s, gib, coll) in enumerate(ranks)] + [
        f"[train] grid data={grid.data} model={grid.model} over "
        f"{grid.size} ranks, layout {layout}"]


if __name__ == "__main__":
    sys.exit(main())
