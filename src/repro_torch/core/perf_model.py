"""Accurate performance prediction model (paper §IV-C).

cost_i = l_i * (1 - f_i) * (c_i + cost_{i+1})      for 1 <= i <= n-1
cost_n = l_n * (1 - f_n)

 - l_i : candidate-set cardinality of the vertex searched at loop i,
         estimated from graph statistics:
             l_1            = |V|
             one neighborhood  = |V| * p1          (= 2|E|/|V|, avg degree)
             m neighborhoods   = |V| * p1 * p2^(m-1)
         with p1 = 2|E|/|V|^2 and p2 = tri_cnt*|V| / (2|E|)^2.
 - f_i : probability a partial embedding is filtered by the restrictions
         enforced at loop i; computed EXACTLY by streaming the n! relative
         orders through the restrictions in loop order (vectorized numpy).
 - c_i : merge-intersection work attributed to loop i.  Matching the
         generated nested-loop code, the partial intersection for a vertex
         with predecessor positions q1<q2<...<qm is extended at each qj
         (j>=2) at cost  card(∩ of j-1 nbhds) + card(single nbhd).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .pattern import Pattern
from .restrictions import Restriction, restrictions_checkable_positions
from .schedule import Schedule, predecessors


@dataclass(frozen=True)
class GraphStats:
    """Data-graph statistics the model needs (paper: |V|, |E|, tri_cnt)."""

    n_vertices: int
    n_edges: int  # undirected edge count
    tri_cnt: int  # number of triangles

    @property
    def p1(self) -> float:
        return 2.0 * self.n_edges / max(self.n_vertices, 1) ** 2

    @property
    def p2(self) -> float:
        if self.n_edges == 0:
            return 0.0
        return self.tri_cnt * self.n_vertices / float(2.0 * self.n_edges) ** 2

    @property
    def avg_degree(self) -> float:
        return 2.0 * self.n_edges / max(self.n_vertices, 1)


def predicted_frontier_occupancy(
    stats: GraphStats, degrees, threshold: int
) -> float:
    """Predicted fraction of frontier rows whose base degree > threshold.

    Bucket sizing input for `executor.auto_buckets(stats=...)`.  At any
    loop depth ≥ 1 a frontier row binds its base vertex by traversing an
    edge into it, so under the model's uniform-traversal assumption
    P(base = v) ∝ deg(v): the occupancy of the degree range above
    `threshold` is its EDGE-weighted share, not the vertex-count share
    the 4×-margin heuristic padded.  Clustering concentrates frontiers
    on the head further — restriction-surviving rows preferentially sit
    inside closed wedges — which the model bounds with the p2/p1 ratio
    (how much likelier two neighbors of a common vertex are adjacent
    than a random pair), clamped to [1, 4] so pathological triangle
    counts cannot blow the layout up past the legacy margin."""
    deg = np.asarray(degrees, dtype=np.int64)
    total = float(deg.sum())
    if total <= 0:
        return 0.0
    share = float(deg[deg > threshold].sum()) / total
    amp = 1.0 if stats.p1 <= 0 else min(max(stats.p2 / stats.p1, 1.0), 4.0)
    return min(share * amp, 1.0)


def intersection_cardinality(stats: GraphStats, m: int) -> float:
    """Expected |N(v1) ∩ ... ∩ N(vm)|;  m=0 means the full vertex set."""
    if m == 0:
        return float(stats.n_vertices)
    return stats.n_vertices * stats.p1 * stats.p2 ** (m - 1)


def filter_probabilities(
    n: int, res_set: Sequence[Restriction], order: Schedule
) -> list[float]:
    """f_i per loop (0-indexed list of length n), computed exactly.

    Streams all n! relative-magnitude assignments through the restrictions
    in the order the generated code would check them.
    """
    from .restrictions import perm_matrix

    perms = perm_matrix(n)
    # column v of `perms` is id(v) for that assignment
    alive = np.ones(len(perms), dtype=bool)
    by_pos = restrictions_checkable_positions(res_set, order)
    f = [0.0] * n
    for i in range(n):
        if i not in by_pos:
            continue
        mask = np.ones(len(perms), dtype=bool)
        for (a, b) in by_pos[i]:
            mask &= perms[:, a] > perms[:, b]
        before = int(alive.sum())
        alive &= mask
        after = int(alive.sum())
        f[i] = 0.0 if before == 0 else (before - after) / before
    return f


def loop_cardinalities(
    pattern: Pattern, order: Schedule, stats: GraphStats
) -> list[float]:
    """l_i per loop position (0-indexed)."""
    preds = predecessors(pattern, order)
    return [intersection_cardinality(stats, len(p)) for p in preds]


def intersection_costs(
    pattern: Pattern, order: Schedule, stats: GraphStats
) -> list[float]:
    """c_i per loop position: merge work performed inside loop i.

    For a vertex at position p with predecessor positions q1<...<qm, the
    generated code extends its partial intersection at each qj (j >= 2);
    the extension at qj costs card(∩ j-1) + card(1) merge steps
    (sorted-merge is O(n+m)).  Loops with a single predecessor reuse N(v)
    directly (no merge cost) — same as the paper's example where
    c2 = |N(v_A)| + |N(v_B)| for the first real intersection.
    """
    n = pattern.n
    preds = predecessors(pattern, order)
    c = [0.0] * n
    for p in range(n):
        qs = preds[p]
        for j in range(1, len(qs)):
            at = qs[j]  # extension happens right after vertex at qs[j] binds
            c[at] += intersection_cardinality(stats, j) + intersection_cardinality(
                stats, 1
            )
    return c


def predict_cost(
    pattern: Pattern,
    order: Schedule,
    res_set: Sequence[Restriction],
    stats: GraphStats,
    *,
    iep_k: int = 0,
) -> float:
    """Total predicted cost of a configuration (schedule × restriction set).

    With iep_k > 0 the innermost iep_k loops are replaced by an IEP
    evaluation: their traversal cost collapses into a per-(n-k)-prefix
    term-evaluation cost (a fixed number of merge intersections).
    """
    n = pattern.n
    l = loop_cardinalities(pattern, order, stats)
    c = intersection_costs(pattern, order, stats)
    f = filter_probabilities(n, res_set, order)

    last = n - iep_k if iep_k > 0 else n
    if iep_k > 0:
        # Cost of evaluating all IEP terms for one prefix.  The executor
        # aggregates onto the partition lattice (Bell(k) terms) and computes
        # each distinct neighborhood-union intersection once; bound the
        # merge work by k single-neighborhood merges per term.
        from .iep import bell_number

        n_terms = float(bell_number(iep_k))
        iep_eval = n_terms * iep_k * intersection_cardinality(stats, 1)
    else:
        iep_eval = 0.0

    cost = 0.0
    for i in reversed(range(last)):
        if i == last - 1:
            # Innermost surviving loop: paper's base case l_n*(1-f_n); when
            # IEP replaces the tail, each surviving prefix additionally pays
            # the term-evaluation cost.
            cost = l[i] * (1.0 - f[i]) * (1.0 + c[i] + iep_eval)
        else:
            cost = l[i] * (1.0 - f[i]) * (c[i] + cost)
    return cost
