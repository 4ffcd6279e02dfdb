"""The graph serving front door on a card: small-rmat served through the
port's `Gateway` + `GraphQueryWorkload` over a live `QueryEngine` on
the card, with one mutation batch, against the portable path on the
CPU; K1's per-mode launch counters must show exactly the plans' modes,
every mask launch through the mask-and-compact kernels.

The test carries the `cuda` marker and skips without a card.  This file
imports neither JAX nor the reference package, so it also runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_serving.py
"""
import numpy as np
import pytest
import torch
from chip_smoke import kernel_modes

from repro_torch.configs.graphpi import get_dataset, get_pattern
from repro_torch.core.executor import ExecutorConfig
from repro_torch.core.pattern import clique
from repro_torch.kernels import intersect, ops
from repro_torch.query import QueryEngine, QueryRequest, relabeled_variant
from repro_torch.serve.gateway import Gateway, GraphQueryWorkload, Share

# The triangle (K1 count mode) and the 4-clique (mask and count): the
# portable path on the CPU counts them in seconds on small-rmat, where
# P1 takes minutes.
PATTERNS = (get_pattern("triangle"), clique(4))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 is CUDA C++; no CPU mode)")


def _serve(engine, requests):
    """Requests through a Gateway round over `engine`; returns counts and
    K1's launches in the rounds (counters set to 0 just before)."""
    gw = Gateway(device=engine.device)
    wl = gw.add(GraphQueryWorkload(engine, requests), Share(quantum=4))
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launches()
    gw.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return [r.count for r in wl.results()], dict(ops.launches), dict(
        intersect.compact_launches)


@pytest.mark.cuda
def test_live_gateway_on_card_equals_portable_cpu():
    _need_card()
    small = get_dataset("small-rmat")
    rng = np.random.default_rng(18)
    edges = set(map(tuple, small.edge_array().tolist()))
    ins = set()
    while len(ins) < 32:
        u, v = sorted(int(x) for x in rng.integers(0, small.n, 2))
        if u != v and (u, v) not in edges:
            ins.add((u, v))
    dels = sorted(edges)[::250]
    engines = {
        "card": QueryEngine(small, cfg=ExecutorConfig(), live=True,
                            device="cuda"),
        "cpu": QueryEngine(small, cfg=ExecutorConfig(use_kernel=False),
                           live=True, device="cpu")}
    got = {}
    for side, eng in engines.items():
        requests = [QueryRequest(p) for p in PATTERNS]
        requests.append(QueryRequest(relabeled_variant(PATTERNS[1], 3)))
        before, l0, c0 = _serve(eng, requests)
        eng.request_mutation("insert_edges", sorted(ins))
        eng.request_mutation("delete_edges", dels)
        after, l1, c1 = _serve(eng, [QueryRequest(p) for p in PATTERNS])
        got[side] = (before, after)
        s = eng.summary()["live"]
        assert s["matcher_rebinds"] == 2 and s["matcher_rebuilds"] == 0
        assert eng.cache.stats.n_searches == len(PATTERNS)
        plans = [e.plan for e in eng.cache.entries()]
        for launches, compact in ((l0, c0), (l1, c1)):
            if side == "card":
                want = set().union(*(kernel_modes(p) for p in plans))
                assert {k for k in ops.K1_MODES if launches[k]} == want
                assert compact == dict.fromkeys(compact, launches["mask"])
            else:
                assert not any(launches[k] for k in ops.K1_MODES)
    assert got["card"] == got["cpu"]
    before, after = got["card"]
    assert before[1] == before[2] and before[:2] != after
