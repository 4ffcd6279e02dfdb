"""End-to-end training launcher (fault-tolerant), on one device.

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
   goes on).

`--model-axis` other than 1 (tensor parallelism) raises: serving is
sharded (`parallel/sharding.py`), training not yet (ROADMAP.md, queue
1: training under sharding).
"""
from __future__ import annotations

import argparse
import signal
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.model_axis != 1:
        raise NotImplementedError(
            f"--model-axis {args.model_axis}: tensor parallelism in "
            "training is not ported yet (ROADMAP.md, queue 1: training "
            "under sharding); train on one device with --model-axis 1")

    from ..configs import get_config, get_smoke_config
    from ..device import resolve_device
    from ..train import checkpoint as ckpt
    from ..train.data import DataConfig, SyntheticLM
    from ..train.optimizer import AdamWConfig, init_opt_state
    from ..train.train_step import (TrainOptions, abstract_params,
                                    init_train_state, make_train_step)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    step_fn = make_train_step(
        cfg, opt_cfg,
        TrainOptions(remat=True, q_chunk=0, loss_chunk=0,
                     accum_steps=args.accum),
        device=device)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        like = abstract_params(cfg)
        tree, start = ckpt.restore(
            args.ckpt_dir, {"p": like, "o": init_opt_state(like)},
            device=device)
        params, opt_state = tree["p"], tree["o"]
        print(f"[train] resumed from step {start}")
    else:
        params, opt_state = init_train_state(cfg, seed=0, device=device)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch), cfg)
    stop = {"now": False}

    def _sig(_s, _f):
        stop["now"] = True

    saved = {s: signal.signal(s, _sig) for s in (signal.SIGTERM,
                                                  signal.SIGINT)}
    try:
        t0 = time.time()
        tokens_done = 0
        for s in range(start, args.steps):
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 data.batch(s))
            tokens_done += args.batch * args.seq
            if (s + 1) % args.log_every == 0:
                dt = time.time() - t0
                print(
                    f"step {s+1}/{args.steps} "
                    f"loss={float(metrics['loss']):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e} "
                    f"tok/s={tokens_done/dt:.0f}", flush=True)
            want_ckpt = args.ckpt_dir and (
                (s + 1) % args.ckpt_every == 0 or stop["now"]
                or s + 1 == args.steps)
            if want_ckpt:
                ckpt.save(args.ckpt_dir, s + 1, {"p": params, "o": opt_state})
                if stop["now"]:
                    print(f"[train] preempted at step {s+1}; "
                          "checkpointed, exiting cleanly", flush=True)
                    return 0
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    print("[train] done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
