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
"""
from __future__ import annotations

import argparse
import sys


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
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.resume and not args.ckpt_dir:
        print("[serve] --resume requires --ckpt-dir")
        return 2
    from ..serve.gateway import Gateway, LMDecodeWorkload, Share
    from ..serve.session import LMSession

    session = LMSession(
        args.arch, smoke=args.smoke, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen, max_seq=args.max_seq,
        device=args.device, seed=args.seed, layers=args.layers,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )
    gw = Gateway(device=session.device)
    gw.add(LMDecodeWorkload(session, resume=args.resume),
           Share(quantum=args.step_quantum or args.gen))
    gw.run()

    m = session.metrics()
    B, S = args.batch, args.prompt_len
    if session.resumed_from is not None:
        print(f"[serve] resumed from checkpoint step {session.resumed_from} "
              f"(skipped prefill; {m['steps_total'] - session.resumed_from} "
              f"steps remained)")
    else:
        tp = B * S / m["prefill_seconds"] if m["prefill_seconds"] else 0.0
        print(f"[serve] prefill: {B}×{S} tokens in "
              f"{m['prefill_seconds']:.3f}s ({tp:.0f} tok/s)")
    steps = m["steps_done"] - (session.resumed_from or 0)
    print(f"[serve] decode: {steps} steps × {B} seqs in "
          f"{m['decode_seconds']:.3f}s ({m['decode_tok_s']:.1f} tok/s, "
          f"{m['ms_per_step']:.1f} ms/step)")
    print(f"[serve] device={session.device} flash launches="
          f"{m['flash_launches']}")
    out = session.tokens_out()
    print(f"[serve] sample tokens[0,:16] = {out[0, :16].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
