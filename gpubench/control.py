"""The control of `correct`, and the program on other graphs.

The configurations state exact counts and no precision; the reference
counts exactly (int64, float64 products).  The control is the same
reference with its products and sums in float32 (TF32 off), put in the
program's place (`Control`): the harness's own run drives it through the
window and compares its counts with the reference's, exactly, so it has
to come out not correct.  It is the shortcut that would tempt a later
change, and one that breaks the stated guarantee.

    python3 gpubench/control.py --workload g500-s12.p1 --seeds 1 2 3

runs the cell once per seed with the control in the program's place, at
the cell's own size, and prints one JSON object a run: the seed,
`correct` and the numbers compared with their limits.  With
`--graph-seeds 2 3` it runs the program itself instead, over graphs
drawn from those graph seeds in place of the configuration's, so that
the comparison also sees other graphs than the one the cell times.  The
benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

if __package__ in (None, ""):      # run as a script, as run.py is
    import os

    _top = pathlib.Path(__file__).resolve().parent.parent
    _here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") != _here]
    sys.path[:0] = [str(_top), str(_top / "src")]
    for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                       ("TRITON_CACHE_DIR", "triton")):
        os.environ[_var] = str(_top / "build" / _sub)

import torch  # noqa: E402

from gpubench import reference  # noqa: E402
from gpubench.harness import ROOT, Catalog, Program, measure  # noqa: E402


class Control:
    """The reference one precision lower, in the program's place: each
    query's count is the float32 reference's over the same graph."""

    def __init__(self, g, config: dict, device):
        self.g = g

    def describe(self) -> str:
        return "the reference in float32, TF32 off"

    def ask(self, kinds) -> tuple[list[tuple[int, str]], int]:
        return [(reference.load(k.pattern).count(self.g, torch.float32), "")
                for k in kinds], 0


class Regraphed(Catalog):
    """The catalog with every configuration's graph drawn from
    `graph_seed` in place of its own."""

    def __init__(self, graph_seed: int, root: pathlib.Path = ROOT):
        super().__init__(root)
        self.graph_seed = graph_seed

    def config(self, name: str) -> dict:
        return {**super().config(name), "graph_seed": self.graph_seed}


def run(cat: Catalog, cell: str, seed: int, seconds: float, program,
        device: str = "cuda") -> dict:
    """One run of `cell` driving `program`: its seed, `correct`, the
    numbers compared and how many queries the window completed."""
    t = time.perf_counter()
    line = measure(cat, cell, seed, seconds, False, device=device,
                   t_start=t, program=program)
    return {"cell": cell, "seed": seed, "correct": line["correct"],
            "attempted": line["attempted"], "checks": line["checks"],
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpubench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--graph-seeds", type=int, nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 3
    if args.graph_seeds:
        for gs in args.graph_seeds:
            for seed in args.seeds:
                row = run(Regraphed(gs), args.workload, seed, args.seconds,
                          Program)
                print(json.dumps({"graph_seed": gs, **row}), flush=True)
        return 0
    for seed in args.seeds:
        row = run(Catalog(), args.workload, seed, args.seconds, Control)
        print(json.dumps({"program": "control", **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
