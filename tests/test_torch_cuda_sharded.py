"""Multi-GPU counting on a card: two ranks sharing one card (gloo, the
backend rule's choice), each counting its stripe of small-rmat through
K1, against the single-device count on the card and the portable path
on the CPU; each rank's K1 counters show exactly the plan's modes, and
a `QueryEngine(group=)` serves the same counts.

The test carries the `cuda` marker and skips without a card.  This file
imports neither JAX nor the reference package, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sharded.py
"""
import json
import os

import pytest
import torch
import torch.distributed as dist
from chip_smoke import kernel_modes
from torch_ranks import init_rank, spawn_ranks

from repro_torch.configs.graphpi import get_dataset, get_pattern
from repro_torch.core import executor as tx
from repro_torch.core.pattern import clique
from repro_torch.kernels import ops
from repro_torch.query import QueryEngine, QueryRequest

WORLD = 2
# The triangle (K1 count mode) and the 4-clique (mask and count): the
# portable path on the CPU counts them in seconds on small-rmat.
PATTERNS = {"triangle": get_pattern("triangle"), "clique4": clique(4)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 is CUDA C++; no CPU mode)")


def _plans(graph, stats):
    from repro_torch.query.cache import plan_for

    return {name: plan_for(p, stats)[1] for name, p in PATTERNS.items()}


def _card_rank(rank, world, rdv, out_dir):
    group, dev = init_rank(rank, world, rdv, device="cuda")
    small = get_dataset("small-rmat")
    stats = tx.compute_stats(small, device=dev)
    out = {"backend": dist.get_backend(group), "counts": {}, "launches": {}}
    for name, plan in _plans(small, stats).items():
        m = tx.ShardedMatcher(small, plan, group, device=dev)
        m.warmup()
        torch.cuda.synchronize(dev)
        ops.reset_launches()
        res = m.count()
        torch.cuda.synchronize(dev)
        out["launches"][name] = {k: ops.launches[k] for k in ops.K1_MODES}
        out["counts"][name] = [res.count, res.overflowed]
    eng = QueryEngine(small, device=dev, group=group, stats=stats)
    tickets = [eng.enqueue(QueryRequest(p)) for p in PATTERNS.values()]
    eng.run_pending()
    out["engine"] = [t.result.count for t in tickets]
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


@pytest.mark.cuda
def test_two_ranks_on_one_card_equal_single_device_and_cpu(tmp_path):
    _need_card()
    from repro_torch.kernels import intersect

    intersect.build()               # the ranks load what this built
    spawn_ranks(_card_rank, WORLD, tmp_path, str(tmp_path))
    recs = [json.loads((tmp_path / f"r{r}.json").read_text())
            for r in range(WORLD)]
    small = get_dataset("small-rmat")
    stats = tx.compute_stats(small, device="cuda")
    plans = _plans(small, stats)
    for name, plan in plans.items():
        card = tx.Matcher(small, plan, device="cuda").count().count
        cpu = tx.Matcher(small, plan, tx.ExecutorConfig(use_kernel=False),
                         device="cpu").count().count
        assert card == cpu
        for rec in recs:
            assert rec["backend"] == "gloo"
            assert rec["counts"][name] == [card, False]
            assert rec["engine"][list(plans).index(name)] == card
            got = {k for k, v in rec["launches"][name].items() if v}
            assert got == kernel_modes(plan), (name, rec["launches"])
