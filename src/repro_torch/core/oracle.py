"""Pure-Python reference matcher (the `ref` oracle for every executor path).

Recursive DFS exactly like the paper's generated nested loops — slow, but
obviously correct.  Used by unit/property tests and validation only.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .pattern import Pattern
from .plan import MatchingPlan


def _adj_sets(n: int, edges: np.ndarray) -> list[set[int]]:
    adj: list[set[int]] = [set() for _ in range(n)]
    for u, v in edges:
        u, v = int(u), int(v)
        if u == v:
            continue
        adj[u].add(v)
        adj[v].add(u)
    return adj


def count_injective_maps(
    n_vertices: int,
    edges: np.ndarray,
    pattern: Pattern,
    labels: Sequence[int] | np.ndarray | None = None,
) -> int:
    """#injective maps pattern→graph preserving pattern edges — and, for
    labeled patterns, mapping each labeled pattern vertex onto a data
    vertex of the same label (`labels` is the data graph's per-vertex
    label array; wildcard pattern positions match anything).

    Equals (#embeddings) × |Aut(pattern)| — label-preserving
    automorphisms when the pattern is labeled.
    """
    if pattern.labels is not None and labels is None:
        raise ValueError(
            f"labeled pattern {pattern.name!r} needs data-graph labels")
    adj = _adj_sets(n_vertices, edges)
    padj = pattern.adjacency()
    plabels = pattern.labels
    n = pattern.n
    assigned = [-1] * n
    used: set[int] = set()
    count = 0

    def label_ok(i: int, c: int) -> bool:
        if plabels is None or plabels[i] is None:
            return True
        return int(labels[c]) == plabels[i]

    def rec(i: int) -> None:
        nonlocal count
        if i == n:
            count += 1
            return
        # candidates: any vertex adjacent to all already-assigned neighbors
        earlier = [j for j in range(i) if padj[i, j]]
        if earlier:
            cand = set(adj[assigned[earlier[0]]])
            for j in earlier[1:]:
                cand &= adj[assigned[j]]
        else:
            cand = set(range(n_vertices))
        for c in sorted(cand):
            if c in used or not label_ok(i, c):
                continue
            assigned[i] = c
            used.add(c)
            rec(i + 1)
            used.remove(c)
        assigned[i] = -1

    rec(0)
    return count


def count_with_plan(
    n_vertices: int,
    edges: np.ndarray,
    plan: MatchingPlan,
    labels: Sequence[int] | np.ndarray | None = None,
) -> int:
    """Reference execution of a MatchingPlan (restrictions honored,
    enumeration only — IEP tail, if any, is enumerated explicitly and must
    produce plan.iep_divisor × the IEP count).  Labeled plans also honor
    plan.vlabels against the data graph's `labels` array."""
    if plan.vlabels is not None and labels is None:
        raise ValueError("labeled plan needs data-graph labels")
    adj = _adj_sets(n_vertices, edges)
    vlabels = plan.vlabels
    n = plan.n
    assigned = [-1] * n
    used: set[int] = set()
    count = 0
    # For reference purposes we always enumerate all n levels with the
    # PREFIX restrictions only (restrictions the IEP path keeps).
    restr = plan.restr

    def rec(i: int) -> None:
        nonlocal count
        if i == n:
            count += 1
            return
        preds = plan.preds[i]
        if preds:
            cand = set(adj[assigned[preds[0]]])
            for j in preds[1:]:
                cand &= adj[assigned[j]]
        else:
            cand = set(range(n_vertices))
        for c in sorted(cand):
            if c in used:
                continue
            if (vlabels is not None and vlabels[i] is not None
                    and int(labels[c]) != vlabels[i]):
                continue
            ok = True
            for (other, d) in restr[i]:
                if d > 0 and not (c > assigned[other]):
                    ok = False
                    break
                if d < 0 and not (c < assigned[other]):
                    ok = False
                    break
            if not ok:
                continue
            assigned[i] = c
            used.add(c)
            rec(i + 1)
            used.remove(c)
        assigned[i] = -1

    rec(0)
    return count


def count_embeddings_oracle(
    n_vertices: int,
    edges: np.ndarray,
    pattern: Pattern,
    labels: Sequence[int] | np.ndarray | None = None,
) -> int:
    """#distinct embeddings (subgraphs) = injective maps / |Aut|.

    For labeled patterns |Aut| is the label-preserving subgroup and the
    injective maps are label-constrained, so the quotient is the number
    of distinct LABELED subgraph instances."""
    maps = count_injective_maps(n_vertices, edges, pattern, labels=labels)
    aut = pattern.aut_count()
    assert maps % aut == 0, (maps, aut)
    return maps // aut
