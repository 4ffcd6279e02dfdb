"""Batched LM serving driver: prefill + greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 4 --prompt-len 2048 --gen 16

Counterpart of `repro/launch/serve.py` on one device: a thin client of
the serving Gateway (`repro_torch.serve.gateway`) that builds one
`LMSession` and schedules it as the Gateway's sole workload.  Every
configuration of `repro_torch.configs.ARCHS` serves (dense, moe, ssm,
hybrid, encdec, vlm); `--layers N` cuts the decoder to N layers for a
model that does not fit one card whole (jamba-v0.1-52b at 8, one
superblock; qwen2-vl-72b at 4).  Runs on the card by default
(`--device cuda`, which raises without one); `--device cpu --smoke`
runs the reduced same-family config on the CPU.  Prefill attention goes
through kernel K4 on a card; the line before the sample reports the
session's K4 launches.

Fault tolerance mirrors the reference: the decode loop checkpoints its
cache + tokens every --ckpt-every steps, and `--resume` reloads the
latest step and continues decoding.

Tensor parallelism: under torchrun every rank serves its shard of the
model, the ranks laid out as a data × model grid (`--model-axis M`,
any divisor of the world; `launch.mesh.make_grid`) under the layout
the reference's `pick_layout` gives.  Under 'tp2d': weights, heads,
experts, Mamba heads and the vocabulary split over the model axis
(`parallel.sharding`; attention whole on every model rank where its
heads do not divide the axis), the batch over the data axis.  Under
'dp_replicated' (a model whose state fits and whose heads the axis
does not divide: whisper-base at 3 or 16): every rank holds the whole
model and its rows of the batch, split over every rank.  Gloo when ranks
share a card or run on the CPU, NCCL with a card each
(`mesh.backend_rule`).  Rank 0 prints, with one `rank r:` line per rank
(its K4 launches, prefill seconds, decode ms/step, peak device memory
and the prefill's collectives), and every rank exits with the same
code.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve --arch qwen3-1.7b --smoke \
        --device cpu --model-axis 2
"""
from __future__ import annotations

import argparse
import sys

from .mesh import leaves_group


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache size (default prompt+gen)")
    ap.add_argument("--layers", type=int, default=0,
                    help="decoder layers (default: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest --ckpt-dir checkpoint "
                         "(cache+tokens+step) and continue decoding")
    ap.add_argument("--step-quantum", type=int, default=0,
                    help="decode steps per scheduler turn (0 = all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="tensor-parallel ranks per model replica (must "
                         "divide the torchrun world)")
    return ap.parse_args(argv)


def _quiet(*_a, **_kw) -> None:
    pass


@leaves_group
def main(argv=None) -> int:
    args = parse_args(argv)
    if args.resume and not args.ckpt_dir:
        print("[serve] --resume requires --ckpt-dir")
        return 2
    from ..serve.gateway import Gateway, LMDecodeWorkload, Share
    from ..serve.session import LMSession
    from .mesh import launched_sharded, shared_group

    group, device, log = None, args.device, print
    if launched_sharded():
        group, device = shared_group(args.device)
        if group.rank() != 0:
            log = _quiet
    elif args.model_axis != 1:
        raise ValueError(f"--model-axis {args.model_axis} needs a world of "
                         f"ranks it divides (torchrun --nproc-per-node)")
    session = LMSession(
        args.arch, smoke=args.smoke, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen, max_seq=args.max_seq,
        device=device, seed=args.seed, layers=args.layers,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        group=group, model_axis=args.model_axis,
    )
    gw = Gateway(device=session.device)
    gw.add(LMDecodeWorkload(session, resume=args.resume),
           Share(quantum=args.step_quantum or args.gen))
    gw.run()
    report(args, session, log)
    if group is None:
        return 0
    from .mesh import agreed_exit

    for line in rank_lines(group, session):
        log(line)
    return agreed_exit(group, 0)


def rank_lines(group, session) -> list:
    """Every rank's `rank r:` line (a collective): its K4 launches,
    prefill seconds, decode ms/step, peak device memory and the batch
    prefill's collectives by kind; then the grid and its layout."""
    import torch

    from .mesh import gather

    dev = session.device
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0)
    m = session.metrics()
    ranks = gather(group, (m["flash_launches"], m["prefill_seconds"],
                           m["ms_per_step"], peak,
                           session.prefill_collectives))
    g = session.grid
    return [f"[serve] rank {r}: K4 launches={k4} prefill={pre:.4f}s "
            f"decode={ms:.3f}ms/step peak={gib:.2f}GiB prefill collectives "
            + " ".join(f"{k}={n}" for k, n in coll.items())
            for r, (k4, pre, ms, gib, coll) in enumerate(ranks)] + [
        f"[serve] grid data={g.data} model={g.model} over {g.size} ranks, "
        f"layout {session.layout}"]


def report(args, session, log=print) -> None:
    """The launcher's lines about the served run."""
    m = session.metrics()
    B, S = args.batch, args.prompt_len
    if session.resumed_from is not None:
        log(f"[serve] resumed from checkpoint step {session.resumed_from} "
            f"(skipped prefill; {m['steps_total'] - session.resumed_from} "
            f"steps remained)")
    else:
        tp = B * S / m["prefill_seconds"] if m["prefill_seconds"] else 0.0
        log(f"[serve] prefill: {B}×{S} tokens in "
            f"{m['prefill_seconds']:.3f}s ({tp:.0f} tok/s)")
    steps = m["steps_done"] - (session.resumed_from or 0)
    log(f"[serve] decode: {steps} steps × {B} seqs in "
        f"{m['decode_seconds']:.3f}s ({m['decode_tok_s']:.1f} tok/s, "
        f"{m['ms_per_step']:.1f} ms/step)")
    log(f"[serve] device={session.device} flash launches="
        f"{m['flash_launches']}")
    out = session.tokens_out()
    log(f"[serve] sample tokens[0,:16] = {out[0, :16].tolist()}")


if __name__ == "__main__":
    sys.exit(main())
