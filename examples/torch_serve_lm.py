"""Serve a mixture-of-experts model with the port's resumable LMSession.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu] [--full]

The counterpart of `examples/serve_lm.py`: the serving path (LMSession
over `make_prefill` / `make_decode`) on granite-moe-1b-a400m — the
reduced config by default (2 layers, 4 experts top-2), `--full` for the
published width and depth (24 layers, 32 experts top-8; a card).
Prefill routes tokens to experts with capacity drops (`moe_sorted`) and
runs attention through kernel K4 on a card when the prompt length is a
multiple of 512; decode routes dropless (`moe_dense`).  Decode runs in
explicit step batches, the unit the serving Gateway schedules
(`python -m repro_torch.launch.gateway`).
"""
import argparse

from repro_torch.serve.session import LMSession


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the reduced one")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)

    session = LMSession("granite-moe-1b-a400m", smoke=not args.full,
                        batch=4, prompt_len=args.prompt_len, gen=args.gen,
                        device=args.device)
    cfg = session.cfg
    print(f"model: {cfg.name} [{cfg.family}] {cfg.n_layers} layers, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, "
          f"{cfg.param_count() / 1e6:.1f}M params on {session.device}")
    session.start()
    m = session.metrics()
    print(f"prefill: {session.B}x{session.S} tokens in "
          f"{m['prefill_seconds']:.3f}s, K4 launches={m['flash_launches']}")
    while session.remaining:
        session.decode_steps(4)        # the Gateway's step granularity
        print(f"decoded {session.step_i}/{session.gen} steps")
    m = session.metrics()
    print(f"decode: {m['decode_tok_s']:.1f} tok/s "
          f"({m['ms_per_step']:.1f} ms/step)")
    print(f"sample tokens[0,:8] = {session.tokens_out()[0, :8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
