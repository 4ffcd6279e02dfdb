"""Train a small LM end to end (fault-tolerant loop, real optimizer).

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] \
        [--steps 200]

The counterpart of `examples/train_lm.py`: the port's training path
(`repro_torch.launch.train`: `make_train_step` with remat, AdamW
updating the fp32 masters in place, atomic checkpoints) on the reduced
qwen3-family config.  Interrupt it (Ctrl-C) and rerun: it resumes from
the checkpoint, and the step-indexed data pipeline continues the exact
token stream.  The checkpoints go under the temporary directory unless
`--ckpt-dir` names one.
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    args = ap.parse_args(argv)
    return train_main([
        "--arch", "qwen3-1.7b", "--smoke",
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq", str(args.seq),
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50",
        "--log-every", "10",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
