"""End-to-end distributed pattern matching on the PyTorch port.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        examples/torch_distributed_match.py [--device cpu]

The counterpart of `examples/distributed_match.py`: one process per GPU
under `torch.distributed` (the backend rule of `launch/mesh.py`: NCCL
when every rank has its own card, gloo when ranks share one or run on
the CPU).  The outer-loop vertex tasks are striped over the ranks like
GraphPi's task partitioning (rank d takes roots d, d+W, ...), each rank
counts its stripe through K1 on its card, and the per-rank counts are
summed by one all_reduce per pass.  Every rank checks that the sharded
count equals its own single-device count and the brute-force oracle.
"""
import argparse
import sys
import time

from repro_torch.configs.graphpi import PATTERNS, get_dataset
from repro_torch.core.config_search import search_configuration
from repro_torch.core.executor import (
    ExecutorConfig, compute_stats, count_embeddings, count_embeddings_sharded,
)
from repro_torch.core.oracle import count_embeddings_oracle
from repro_torch.launch.mesh import leaves_group, shared_group


@leaves_group
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    group, device = shared_group(args.device)
    say = print if group.rank() == 0 else (lambda *a: None)

    # tiny-er keeps this demo quick; "small-rmat" (power-law) shows the
    # striped balancing at work
    graph = get_dataset("tiny-er")
    pattern = PATTERNS["P2"]                 # pentagon
    say(f"ranks: {group.size()}  graph: {graph.name} |V|={graph.n} "
        f"|E|={graph.m} max_deg={graph.max_degree}")

    cfg = ExecutorConfig(capacity=1 << 14)
    stats = compute_stats(graph, cfg, device=device)
    res = search_configuration(pattern, stats, use_iep=True)
    plan = res.plan(pattern)
    say(f"config: schedule={res.best.order} restr={res.best.res_set} "
        f"iep_k={res.best.iep_k}")

    t0 = time.perf_counter()
    single = count_embeddings(graph, plan, cfg, device=device)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = count_embeddings_sharded(graph, plan, group, cfg=cfg,
                                       device=device)
    t2 = time.perf_counter() - t0
    say(f"single-device count = {single.count}   ({t1:.3f}s)")
    say(f"sharded       count = {sharded.count}   ({t2:.3f}s over "
        f"{group.size()} ranks)")
    assert single.count == sharded.count, (single.count, sharded.count)
    expect = count_embeddings_oracle(graph.n, graph.edge_array(), pattern)
    assert expect == single.count, (expect, single.count)
    say(f"oracle = {expect}  ✓")
    return 0


if __name__ == "__main__":
    sys.exit(main())
