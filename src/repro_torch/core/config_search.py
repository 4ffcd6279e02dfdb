"""Configuration selection: enumerate (schedule × restriction-set)
candidates, rank them with the performance model, return the best plan.

This is the paper's `configuration generation + performance prediction`
stage (Fig. 3) — all plan-time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

from .pattern import Pattern
from .perf_model import GraphStats, predict_cost
from .plan import MatchingPlan, best_iep_k, build_plan, max_iep_k
from .restrictions import RestrictionSet, generate_restriction_sets
from .schedule import Schedule, generate_schedules


@dataclass(frozen=True)
class Configuration:
    order: Schedule
    res_set: RestrictionSet
    iep_k: int
    predicted_cost: float


def config_to_dict(config: Configuration) -> dict:
    """JSON-serializable record of a searched configuration.

    `config_from_dict(config_to_dict(c)) == c` exactly (dataclass
    equality), including after a JSON round trip — the on-disk plan
    store (query/store.py) persists these so a replica restart replays
    the search result instead of re-ranking the configuration space.
    """
    return {
        "order": list(config.order),
        "res_set": [list(r) for r in config.res_set],
        "iep_k": int(config.iep_k),
        "predicted_cost": float(config.predicted_cost),
    }


def config_from_dict(d: dict) -> Configuration:
    return Configuration(
        order=tuple(int(v) for v in d["order"]),
        res_set=tuple((int(a), int(b)) for a, b in d["res_set"]),
        iep_k=int(d["iep_k"]),
        predicted_cost=float(d["predicted_cost"]),
    )


@dataclass
class SearchResult:
    best: Configuration
    all_configs: list[Configuration]
    n_schedules: int
    n_restriction_sets: int
    preprocess_seconds: float

    def plan(self, pattern: Pattern) -> MatchingPlan:
        return build_plan(
            pattern, self.best.order, self.best.res_set, iep_k=self.best.iep_k
        )


def search_configuration(
    pattern: Pattern,
    stats: GraphStats,
    *,
    use_iep: bool = False,
    max_restriction_sets: int | None = 64,
    max_schedules: int | None = None,
) -> SearchResult:
    """Rank every configuration with the cost model; pick the cheapest."""
    t0 = time.perf_counter()
    schedules = generate_schedules(pattern)
    if max_schedules is not None:
        schedules = schedules[:max_schedules]
    res_sets = generate_restriction_sets(pattern, max_sets=max_restriction_sets)
    if not res_sets:
        raise RuntimeError(f"no restriction sets for {pattern!r}")

    configs: list[Configuration] = []
    for order in schedules:
        for rs in res_sets:
            ks = {0}
            if use_iep:
                ks.add(best_iep_k(pattern, order, rs))
            for k in sorted(ks):
                cost = predict_cost(pattern, order, rs, stats, iep_k=k)
                configs.append(Configuration(order, rs, k, cost))
    configs.sort(key=lambda c: c.predicted_cost)
    return SearchResult(
        best=configs[0],
        all_configs=configs,
        n_schedules=len(schedules),
        n_restriction_sets=len(res_sets),
        preprocess_seconds=time.perf_counter() - t0,
    )


def graphzero_configuration(
    pattern: Pattern, stats: GraphStats, *, use_iep: bool = False
) -> Configuration:
    """Baseline emulating GraphZero: a single canonical restriction set and
    a degree-heuristic schedule (no data-aware cost model over sets).

    GraphZero orders vertices by (degree, connectivity) greedily and emits
    one symmetry-breaking set; we reproduce that flavour: schedule = the
    prefix-connected order that greedily maximizes (#connections to prefix,
    degree), restriction set = first set from Algorithm 1's DFS.
    """
    adj = pattern.adjacency()
    order: list[int] = []
    remaining = set(range(pattern.n))
    # seed: max-degree vertex
    order.append(max(remaining, key=lambda v: int(adj[v].sum())))
    remaining.remove(order[0])
    while remaining:
        nxt = max(
            remaining,
            key=lambda v: (
                sum(1 for u in order if adj[v, u]),
                int(adj[v].sum()),
            ),
        )
        # keep prefix-connectivity if at all possible
        connected = [v for v in remaining if any(adj[v, u] for u in order)]
        if connected:
            nxt = max(
                connected,
                key=lambda v: (
                    sum(1 for u in order if adj[v, u]),
                    int(adj[v].sum()),
                ),
            )
        order.append(nxt)
        remaining.remove(nxt)
    res_sets = generate_restriction_sets(pattern, max_sets=1)
    rs = res_sets[0]
    k = best_iep_k(pattern, tuple(order), rs) if use_iep else 0
    cost = predict_cost(pattern, tuple(order), rs, stats, iep_k=k)
    return Configuration(tuple(order), rs, k, cost)
