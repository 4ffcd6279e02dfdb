"""Algorithm 1 — 2-cycle based automorphism elimination.

Generates MULTIPLE sets of partial-order restrictions, each of which
reduces the automorphism count of a pattern to exactly one.  A
restriction is a pair (a, b) meaning ``id(a) > id(b)`` (ids are data-graph
vertex ids of the embedding).

For labeled patterns `pattern.automorphisms()` is already the
label-preserving subgroup, so everything below transparently breaks the
SMALLER group: the completeness target becomes n!/|Aut_label| and the
generated sets carry fewer (or equal) restrictions than the unlabeled
skeleton's.  A pattern whose labels kill all symmetry yields the empty
restriction set.

This is plan-time code (pure Python); the paper reports 8ms..2.5s for
patterns up to size 7 (Table III) and ours is in the same ballpark.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Sequence

import numpy as np

from .pattern import Pattern, Perm, identity_perm, two_cycles_of

Restriction = tuple[int, int]  # (a, b)  ==  id(a) > id(b)
RestrictionSet = tuple[Restriction, ...]


@functools.lru_cache(maxsize=16)
def perm_matrix(n: int) -> np.ndarray:
    """All n! permutations as an (n!, n) int8 matrix (cached; n <= 8)."""
    return np.array(list(itertools.permutations(range(n))), dtype=np.int8)


def _acyclic_masks(n: int, succ: list[int]) -> bool:
    """Is the digraph given by successor bitmasks a DAG? (bitmask Kahn —
    this is the innermost call of Algorithm 1's search, so it avoids all
    per-node allocations)."""
    indeg = [0] * n
    for v in range(n):
        m = succ[v]
        while m:
            w = (m & -m).bit_length() - 1
            indeg[w] += 1
            m &= m - 1
    stack = [v for v in range(n) if indeg[v] == 0]
    seen = 0
    while stack:
        v = stack.pop()
        seen += 1
        m = succ[v]
        while m:
            w = (m & -m).bit_length() - 1
            indeg[w] -= 1
            if indeg[w] == 0:
                stack.append(w)
            m &= m - 1
    return seen == n


def _acyclic(n: int, edges: set[tuple[int, int]]) -> bool:
    """Is the directed graph on n vertices with `edges` a DAG?"""
    succ = [0] * n
    for a, b in edges:
        succ[a] |= 1 << b
    return _acyclic_masks(n, succ)


def no_conflict(perm: Perm, res_set: Sequence[Restriction]) -> bool:
    """True iff `perm` is NOT eliminated by `res_set` (paper's no_conflict).

    For each restriction (a,b) [id(a) > id(b)] add directed edges a->b and
    perm[a]->perm[b]; perm survives iff the graph stays acyclic.
    """
    n = len(perm)
    succ = [0] * n
    for a, b in res_set:
        succ[a] |= 1 << b
        succ[perm[a]] |= 1 << perm[b]
    return _acyclic_masks(n, succ)


def surviving_perms(
    perms: Sequence[Perm], res_set: Sequence[Restriction]
) -> list[Perm]:
    return [p for p in perms if no_conflict(p, res_set)]


def count_orders_satisfying(n: int, res_set: Sequence[Restriction]) -> int:
    """#permutations of (0..n-1) id-assignments satisfying all id(a)>id(b).

    Used by `validate`: pattern matching on K_n finds exactly this many
    embeddings when the restrictions are applied.  (Vectorized — this is
    on the hot path of Algorithm 1's leaf checks.)
    """
    perms = perm_matrix(n)
    ok = np.ones(len(perms), dtype=bool)
    for a, b in res_set:
        ok &= perms[:, a] > perms[:, b]
    return int(ok.sum())


def validate(pattern: Pattern, res_set: Sequence[Restriction]) -> bool:
    """Paper's validate(): run on K_n with and without restrictions.

    On K_n every injective assignment is an embedding, so
    ans_without = n! and correctness requires
    ans_with == n! / |Aut(pattern)|.
    """
    n = pattern.n
    auts = pattern.automorphisms()
    n_fact = 1
    for i in range(2, n + 1):
        n_fact *= i
    if n_fact % len(auts) != 0:  # Lagrange guarantees this never trips.
        return False
    return count_orders_satisfying(n, res_set) == n_fact // len(auts)


@functools.lru_cache(maxsize=256)
def generate_restriction_sets(
    pattern: Pattern, *, validate_sets: bool = True, max_sets: int | None = None
) -> list[RestrictionSet]:
    """Algorithm 1: all distinct restriction sets that kill every non-identity
    automorphism.

    Branches over which 2-cycle to break at each step, deduplicates by the
    frozen set of restrictions, and (optionally) verifies each candidate via
    the K_n validation from the paper.  Memoized per (pattern, flags): the
    benchmarks re-enter this for the same pattern many times.
    """
    auts = pattern.automorphisms()
    ident = identity_perm(pattern.n)
    n_fact = math.factorial(pattern.n)
    target = n_fact // len(auts)            # orders a COMPLETE set must keep
    results: list[RestrictionSet] = []
    seen_sets: set[frozenset[Restriction]] = set()
    # Memoize on (surviving-group, restriction-set) to prune repeated states.
    visited_states: set[tuple[frozenset[Perm], frozenset[Restriction]]] = set()

    def generate(pg: list[Perm], res_set: tuple[Restriction, ...]) -> None:
        if max_sets is not None and len(results) >= max_sets:
            return
        if len(pg) <= 1:
            key = frozenset(res_set)
            if key in seen_sets:
                return
            # The monotone prune below guarantees count == target here, so
            # the paper's K_n validation can only confirm; keep it as the
            # safety net the paper prescribes (it is cheap, vectorized).
            if validate_sets and not validate(pattern, res_set):
                return
            seen_sets.add(key)
            results.append(tuple(sorted(res_set)))
            return
        state = (frozenset(pg), frozenset(res_set))
        if state in visited_states:
            return
        visited_states.add(state)
        tried: set[tuple[int, int]] = set()
        for perm in pg:
            if perm == ident:
                continue
            for (u, v) in two_cycles_of(perm):
                for pair in ((u, v), (v, u)):  # both orientations are valid
                    if pair in tried:
                        continue
                    tried.add(pair)
                    new_set = res_set + (pair,)
                    # Monotone prune: adding restrictions only shrinks the
                    # set of surviving id-orders, and a complete set keeps
                    # exactly n!/|Aut| of them — if we are already below
                    # the target no extension can be valid.
                    if count_orders_satisfying(pattern.n, new_set) < target:
                        continue
                    remaining = [p for p in pg if no_conflict(p, new_set)]
                    # new_set must at least kill `perm` itself; identity
                    # always survives.
                    if len(remaining) < len(pg):
                        generate(remaining, new_set)

    generate(list(auts), ())
    # Prefer smaller sets first, then lexicographic for determinism.
    results.sort(key=lambda rs: (len(rs), rs))
    return results


def first_restriction_set(pattern: Pattern) -> RestrictionSet:
    """A single canonical set — this is what a GraphZero-style system gets.

    GraphZero generates exactly one set; we emulate it by taking the first
    set found by a deterministic DFS over Algorithm 1's branch tree (no
    performance-model selection among sets).
    """
    sets = generate_restriction_sets(pattern, max_sets=1)
    if not sets:
        raise RuntimeError(f"no restriction set found for {pattern!r}")
    return sets[0]


def restrictions_checkable_positions(
    res_set: Sequence[Restriction], order: Sequence[int]
) -> dict[int, list[Restriction]]:
    """Map loop position -> restrictions checkable there under `order`.

    A restriction (a,b) can be enforced at the loop of whichever of a/b is
    searched LAST in the schedule.
    """
    pos = {v: i for i, v in enumerate(order)}
    out: dict[int, list[Restriction]] = {}
    for (a, b) in res_set:
        p = max(pos[a], pos[b])
        out.setdefault(p, []).append((a, b))
    return out
