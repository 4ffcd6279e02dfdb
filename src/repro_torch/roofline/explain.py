"""Attribution tool for the roofline walk: which ops carry the bytes /
flops?  The counterpart of `repro/roofline/explain.py`, over one
rank's step recorded by `roofline.op_cost.OpCost` instead of HLO.

    PYTHONPATH=src python -m repro_torch.roofline.explain --arch granite-34b \\
        --shape decode_32k --mesh single --top 15

An op's signature is its aten name and its result's dtype and shape
(the kernels K1–K4: `kernel <launches key> -> [shape]`), so repeated
layers aggregate into one row.  The LM cells run on `meta` tensors;
the graph cell counts on `--device` (default cuda).
"""
from __future__ import annotations

from .op_cost import Contribution


def attribute(record) -> dict[str, Contribution]:
    """Per-signature totals of a recorded step (bytes, flops, count)."""
    return dict(record.by_sig)


def explain(record, top: int = 20) -> str:
    contrib = attribute(record)
    total_b = sum(c.bytes_ for c in contrib.values())
    total_f = sum(c.flops for c in contrib.values())
    lines = [f"total bytes={total_b:.3e}  total flops={total_f:.3e}",
             f"{'bytes':>12s} {'%':>6s} {'flops':>12s} {'n':>6s}  op"]
    for sig, c in sorted(contrib.items(), key=lambda kv: -kv[1].bytes_)[:top]:
        lines.append(
            f"{c.bytes_:12.3e} {100 * c.bytes_ / max(total_b, 1):6.2f} "
            f"{c.flops:12.3e} {c.count:6d}  {sig}"
        )
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="where the graph cell counts")
    args = ap.parse_args(argv)

    from ..launch import dryrun

    with dryrun.fake_world(512 if args.mesh == "multi" else 256):
        grid = dryrun.production_grid(args.mesh)
        if args.arch == "graphpi":
            rec = dryrun.lower_graphpi(grid, args.mesh,
                                       device=args.device)[0]
        else:
            rec, _ = dryrun.lower_cell(args.arch, args.shape, grid,
                                       args.mesh)
    print(explain(rec, args.top))


if __name__ == "__main__":
    main()
