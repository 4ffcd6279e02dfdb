"""Quickstart on the PyTorch port: count a pattern in a graph with the
full GraphPi pipeline.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of `examples/quickstart.py`:
  1. define a pattern,
  2. generate restriction sets (Algorithm 1) and efficient schedules
     (2-phase generator),
  3. let the performance model pick the optimal configuration,
  4. count embeddings with the port's executor (kernel K1 on a card;
     `--device cpu` runs K1's plain version),
  5. verify against the pure-python oracle.
"""
import argparse
import math

from repro_torch.configs.graphpi import get_dataset
from repro_torch.core.config_search import search_configuration
from repro_torch.core.executor import (
    ExecutorConfig, compute_stats, count_embeddings,
)
from repro_torch.core.oracle import count_embeddings_oracle
from repro_torch.core.pattern import house
from repro_torch.core.restrictions import generate_restriction_sets
from repro_torch.core.schedule import generate_schedules
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    # 1. the House pattern (paper Fig. 5a): a rectangle with a roof apex
    pattern = house()
    print(f"pattern: {pattern}")
    print(f"|Aut| = {pattern.aut_count()} (mirror symmetry)")

    # 2. Algorithm 1 — multiple restriction sets, each kills all symmetry
    res_sets = generate_restriction_sets(pattern)
    print(f"\nAlgorithm 1 found {len(res_sets)} restriction sets:")
    for rs in res_sets[:4]:
        print("   ", " & ".join(f"id({a}) > id({b})" for a, b in rs))

    schedules = generate_schedules(pattern)
    print(f"2-phase generator kept {len(schedules)} of "
          f"{math.factorial(pattern.n)} schedules")

    # 3. data graph + performance-model configuration selection
    graph = get_dataset("tiny-er")
    stats = compute_stats(graph, device=args.device)
    print(f"\ngraph: {graph.name} |V|={graph.n} |E|={graph.m} "
          f"triangles={stats.tri_cnt}")
    res = search_configuration(pattern, stats, use_iep=True)
    best = res.best
    print(f"searched {len(res.all_configs)} configurations in "
          f"{res.preprocess_seconds * 1e3:.1f} ms")
    print(f"best: schedule={best.order} restrictions={best.res_set} "
          f"iep_k={best.iep_k}")

    # 4. count with the port's executor on the device
    plan = res.plan(pattern)
    ops.reset_launches()
    out = count_embeddings(graph, plan, ExecutorConfig(capacity=1 << 14),
                           device=args.device)
    print(f"\ncount = {out.count}  (device {args.device}; K1 launches "
          + " ".join(f"{m}={ops.launches[m]}" for m in ops.K1_MODES) + ")")

    # 5. verify
    expect = count_embeddings_oracle(graph.n, graph.edge_array(), pattern)
    print(f"oracle = {expect}")
    assert out.count == expect, (out.count, expect)
    print("count == oracle  ✓")


if __name__ == "__main__":
    main()
