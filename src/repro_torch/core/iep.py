"""Counting with the Inclusion–Exclusion Principle (paper §IV-D, Alg. 2).

The innermost k loops traverse candidate sets S_1..S_k of pairwise
non-adjacent pattern vertices.  The number of ways to pick pairwise
DISTINCT (e_1..e_k), e_i ∈ S_i, is by inclusion–exclusion over the pair
collisions A_{i,j}.  Algorithm 2 factors every term over connected
components; aggregating all 2^(k(k-1)/2) pair-subsets that induce the same
component structure collapses the sum onto the partition lattice with
Möbius coefficients:

    |S_IEP| = Σ_{partitions P of {1..k}}  Π_{block B ∈ P} (-1)^{|B|-1} (|B|-1)!  ·  |∩_{i∈B} S_i|

(For k=2 this is |S1||S2| - |S1∩S2|; for k=3 the Π-coefficients give the
paper's +2 |S1∩S2∩S3| term.)  This is mathematically identical to the
paper's expansion but with Bell(k) terms instead of 2^(k(k-1)/2).

Each S_i is itself an intersection of data-graph neighborhoods (one per
pattern-predecessor of tail vertex i), so a block's intersection is the
intersection of the UNION of the predecessor sets — we deduplicate those
unions so the executor computes each distinct multi-way intersection once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence


def set_partitions(items: Sequence[int]):
    """Yield all partitions of `items` as lists of tuples."""
    items = list(items)
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for part in set_partitions(rest):
        # put `first` in its own block
        yield [(first,)] + part
        # or into each existing block
        for i in range(len(part)):
            yield part[:i] + [tuple((first,) + part[i])] + part[i + 1 :]


def bell_number(k: int) -> int:
    return sum(1 for _ in set_partitions(range(k)))


@dataclass(frozen=True)
class IEPPlan:
    """Static expansion used by the executor at the deepest surviving loop.

    unions:       distinct tuples of PREFIX loop positions; the executor
                  computes card_u = |∩_{q ∈ unions[u]} N(v_q)| (minus
                  already-used vertices lying in that intersection).
    terms:        (coeff, block_union_indices) — one per set partition;
                  value = coeff * Π_u card_{u}.
    k:            number of tail (IEP-folded) vertices.
    """

    k: int
    unions: tuple[tuple[int, ...], ...]
    terms: tuple[tuple[int, tuple[int, ...]], ...]


def build_iep_plan(tail_preds: Sequence[Sequence[int]]) -> IEPPlan:
    """tail_preds[i] = prefix loop positions feeding tail vertex i's
    candidate set S_i (i in 0..k-1)."""
    k = len(tail_preds)
    unions: list[tuple[int, ...]] = []
    union_index: dict[tuple[int, ...], int] = {}

    def intern(u: tuple[int, ...]) -> int:
        if u not in union_index:
            union_index[u] = len(unions)
            unions.append(u)
        return union_index[u]

    terms: list[tuple[int, tuple[int, ...]]] = []
    for part in set_partitions(range(k)):
        coeff = 1
        idxs = []
        for block in part:
            b = len(block)
            coeff *= (-1) ** (b - 1) * math.factorial(b - 1)
            merged = sorted(set(q for t in block for q in tail_preds[t]))
            idxs.append(intern(tuple(merged)))
        terms.append((coeff, tuple(sorted(idxs))))
    return IEPPlan(k=k, unions=tuple(unions), terms=tuple(terms))
