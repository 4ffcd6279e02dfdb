"""2-phase computation-avoid schedule generation (paper §IV-B).

A schedule is an order (permutation of pattern vertices) in which the
matching loops assign vertices.  Of the n! candidates we keep only:

  Phase 1: prefix-connected orders — the i-th vertex must be adjacent (in
           the pattern) to at least one of the first i-1.
  Phase 2: orders whose last k vertices are pairwise non-adjacent, where
           k is the size of the pattern's maximum independent set.
"""
from __future__ import annotations

import itertools
from typing import Iterator, Sequence

import numpy as np

from .pattern import Pattern

Schedule = tuple[int, ...]


def is_prefix_connected(pattern: Pattern, order: Sequence[int]) -> bool:
    adj = pattern.adjacency()
    for i in range(1, len(order)):
        if not any(adj[order[i], order[j]] for j in range(i)):
            return False
    return True


def last_k_independent(pattern: Pattern, order: Sequence[int], k: int) -> bool:
    adj = pattern.adjacency()
    tail = order[len(order) - k :]
    return all(
        not adj[a, b] for a, b in itertools.combinations(tail, 2)
    )


def generate_schedules(
    pattern: Pattern, *, apply_phase2: bool = True
) -> list[Schedule]:
    """All efficient schedules after the 2-phase filter.

    Generation is a DFS that only extends prefix-connected orders (instead
    of filtering all n! post-hoc), then phase 2 prunes by the independent-
    set tail rule.
    """
    n = pattern.n
    adj = pattern.adjacency()
    k = pattern.max_independent_set_size() if apply_phase2 else 0
    out: list[Schedule] = []

    def extend(order: list[int], used: set[int]) -> None:
        if len(order) == n:
            out.append(tuple(order))
            return
        for v in range(n):
            if v in used:
                continue
            if order and not any(adj[v, u] for u in order):
                continue  # phase 1: must connect to the prefix
            order.append(v)
            used.add(v)
            extend(order, used)
            order.pop()
            used.remove(v)

    extend([], set())
    if apply_phase2:
        # Phase 2 can conflict with phase 1 (e.g. the 4-cycle: no prefix-
        # connected order ends in its only independent pair), so relax k
        # until schedules survive — k=1 imposes nothing.
        while k >= 2:
            kept = [o for o in out if last_k_independent(pattern, o, k)]
            if kept:
                return kept
            k -= 1
    return out


def all_schedules(pattern: Pattern) -> list[Schedule]:
    """Every permutation — used for evaluation figures (Fig. 9)."""
    return [tuple(p) for p in itertools.permutations(range(pattern.n))]


def predecessors(pattern: Pattern, order: Sequence[int]) -> list[list[int]]:
    """For each loop position i: positions j < i whose vertex is adjacent
    to order[i] in the pattern.  These define the candidate-set intersection
    for loop i."""
    adj = pattern.adjacency()
    preds: list[list[int]] = []
    for i, v in enumerate(order):
        preds.append([j for j in range(i) if adj[v, order[j]]])
    return preds
