"""Counting with the Inclusion–Exclusion Principle (paper §IV-D), on the
PyTorch port.

    PYTHONPATH=src python examples/torch_motif_counting_iep.py [--device cpu]

The counterpart of `examples/motif_counting_iep.py`.  When an
application only needs the NUMBER of embeddings, GraphPi replaces the
innermost k loops (whose pattern vertices are pairwise non-adjacent) by
a closed-form IEP evaluation over candidate-set cardinalities — on a
card, kernel K1's signed mode.  This example counts the paper's Fig. 6
motif (k = 3 independent tail) both ways and reports the speedup.
"""
import argparse
import time

import torch

from repro_torch.configs.graphpi import EXTRA_PATTERNS, get_dataset
from repro_torch.core.config_search import search_configuration
from repro_torch.core.executor import (
    ExecutorConfig, compute_stats, count_embeddings,
)
from repro_torch.core.oracle import count_embeddings_oracle
from repro_torch.core.plan import best_iep_k, build_plan
from repro_torch.kernels import ops


def _timed_count(graph, plan, cfg, device):
    """(count, seconds, K1 launches per mode) of one count."""
    ops.reset_launches()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = count_embeddings(graph, plan, cfg, device=device).count
    return (count, time.perf_counter() - t0,
            " ".join(f"{m}={ops.launches[m]}" for m in ops.K1_MODES))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    pattern = EXTRA_PATTERNS["fig6"]
    graph = get_dataset("tiny-er")
    stats = compute_stats(graph, device=args.device)
    print(f"pattern {pattern.name} (n={pattern.n}), graph {graph.name}, "
          f"device {args.device}")

    # Same configuration both ways (paper Fig. 10 methodology: fix the
    # schedule and restriction set; toggle only the IEP folding).
    res = search_configuration(pattern, stats)
    best = res.best
    k = best_iep_k(pattern, best.order, best.res_set)
    print(f"schedule={best.order} restrictions={best.res_set} "
          f"IEP-foldable tail k={k}")

    ecfg = ExecutorConfig(capacity=1 << 15)
    plan_enum = build_plan(pattern, best.order, best.res_set, iep_k=0)
    c_enum, t_enum, l_enum = _timed_count(graph, plan_enum, ecfg,
                                          args.device)
    plan_iep = build_plan(pattern, best.order, best.res_set, iep_k=k)
    c_iep, t_iep, l_iep = _timed_count(graph, plan_iep, ecfg, args.device)

    print(f"enumeration: count={c_enum}  {t_enum:.3f}s  (K1 {l_enum})")
    print(f"IEP (k={k}):  count={c_iep}  {t_iep:.3f}s  "
          f"(overcount divisor x={plan_iep.iep_divisor}; K1 {l_iep})")
    assert c_enum == c_iep, (c_enum, c_iep)
    if t_iep > 0:
        print(f"speedup {t_enum / t_iep:.1f}×")

    expect = count_embeddings_oracle(graph.n, graph.edge_array(), pattern)
    print(f"oracle = {expect}")
    assert expect == c_iep, (expect, c_iep)
    print("count == oracle  ✓")


if __name__ == "__main__":
    main()
