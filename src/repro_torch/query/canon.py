"""Canonical labeling and stable hashing for query patterns.

Two isomorphic patterns submitted as queries must resolve to ONE plan
cache entry: embedding counts are isomorphism-invariant, and the
configuration search + JIT warmup are the expensive part of a cold
query, so identity must be decided structurally, not by label.

Canonical form = the vertex relabeling whose sorted edge tuple is
lexicographically minimal.  The search runs over label permutations
compatible with 1-WL color refinement (colors are rank-normalized, so
the cell structure and cell ORDER are isomorphism-invariant); within
that restriction minimality is still a complete invariant — equal
canonical edge tuples literally describe the same graph, so
key(G1) == key(G2)  ⟺  G1 ≅ G2.  Pattern sizes are tiny (n ≤ 8), and
refinement usually cuts the n! enumeration to a few hundred candidates;
the result is lru-cached per Pattern anyway.

The stable hash is sha256 over (n, canonical edges) — stable across
processes and Python hash randomization, safe to persist or ship
between serving replicas.

Vertex labels join the scheme as INITIAL 1-WL cells: labeled vertices
seed refinement with (label, degree) instead of degree alone, so cells
never mix labels and the canonical search only ranges over
label-preserving relabelings.  The key payload appends the canonical
label tuple, so a labeled pattern and its unlabeled skeleton — or two
different label assignments of one skeleton — can never collide on a
cache entry or store digest.  Unlabeled patterns take the exact
pre-label code path and keep their historical digests.
"""
from __future__ import annotations

import functools
import hashlib
import itertools
import math

import numpy as np

from ..core.pattern import Pattern, Perm


def _wl_cells(pattern: Pattern) -> list[tuple[int, ...]]:
    """1-WL color-refinement cells, ordered by (rank-normalized) color.

    Rank normalization — replacing each round's signature by its rank
    among the round's sorted distinct signatures — keeps colors
    isomorphism-invariant while staying cheap to compare."""
    n = pattern.n
    adj = pattern.adjacency()
    nbrs = [tuple(int(u) for u in np.nonzero(adj[v])[0]) for v in range(n)]
    if pattern.labels is None:
        colors = [len(nbrs[v]) for v in range(n)]
    else:
        # Labels seed the initial partition: cells never mix labels, and
        # ordering by actual label VALUE (wildcards first) keeps the cell
        # order invariant across label-isomorphic presentations.
        sigs0 = [
            ((-1 if pattern.labels[v] is None else pattern.labels[v]),
             len(nbrs[v]))
            for v in range(n)
        ]
        ranks0 = {s: i for i, s in enumerate(sorted(set(sigs0)))}
        colors = [ranks0[sigs0[v]] for v in range(n)]
    for _ in range(n):
        sigs = [
            (colors[v], tuple(sorted(colors[u] for u in nbrs[v])))
            for v in range(n)
        ]
        ranks = {s: i for i, s in enumerate(sorted(set(sigs)))}
        new = [ranks[sigs[v]] for v in range(n)]
        if new == colors:
            break
        colors = new
    return [
        tuple(v for v in range(n) if colors[v] == c)
        for c in sorted(set(colors))
    ]


# Candidate-permutation budget for the canonical search.  Pattern sizes
# are n <= 8 in this system (worst case 8! = 40320), but query_serve
# accepts arbitrary inline patterns — a large single-cell pattern (big
# cycle/clique) would degenerate to n! and hang the request stream, so
# refuse it up front instead.
_MAX_CANDIDATES = 1_000_000


@functools.lru_cache(maxsize=4096)
def _canonical_order(pattern: Pattern) -> Perm:
    """order[i] = original vertex placed at canonical position i."""
    cells = _wl_cells(pattern)
    n_candidates = 1
    for cell in cells:
        n_candidates *= math.factorial(len(cell))
    if n_candidates > _MAX_CANDIDATES:
        raise ValueError(
            f"pattern {pattern.name or 'anon'} (n={pattern.n}) needs "
            f"{n_candidates} candidate labelings to canonicalize "
            f"(budget {_MAX_CANDIDATES}); patterns this symmetric are "
            f"not servable"
        )
    best_key: tuple | None = None
    best: Perm | None = None
    for parts in itertools.product(
        *(itertools.permutations(cell) for cell in cells)
    ):
        order = tuple(v for part in parts for v in part)
        pos = {v: i for i, v in enumerate(order)}
        key = tuple(sorted(
            (min(pos[u], pos[v]), max(pos[u], pos[v]))
            for u, v in pattern.edges
        ))
        if best_key is None or key < best_key:
            best_key, best = key, order
    assert best is not None
    return best


def canonical_form(pattern: Pattern) -> Pattern:
    """The canonically relabeled pattern (name preserved for reporting)."""
    return pattern.relabel(_canonical_order(pattern))


def canonical_key(pattern: Pattern) -> str:
    """Stable hex digest identifying the pattern's (label-)isomorphism class.

    Labeled patterns append their canonical label tuple to the hashed
    payload ("*" marks a wildcard position); unlabeled patterns hash the
    historical (n, edges) payload unchanged, so every pre-label digest —
    and thus every v1 store record — stays valid.
    """
    form = canonical_form(pattern)
    payload = f"{form.n}|" + ";".join(f"{u},{v}" for u, v in form.edges)
    if form.labels is not None:
        payload += "|L:" + ",".join(
            "*" if lab is None else str(lab) for lab in form.labels
        )
    return hashlib.sha256(payload.encode()).hexdigest()


def relabeled_variant(pattern: Pattern, seed: int = 0) -> Pattern:
    """A random isomorphic variant (shuffled vertex labels).  Edge order
    and endpoint orientation are not varied because Pattern itself
    normalizes both at construction — relabeling is the only edge
    presentation a caller can actually observe.  Used by tests and the
    synthetic serving workloads to exercise cache hits on re-queries."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(pattern.n)
    edges = tuple((int(perm[u]), int(perm[v])) for u, v in pattern.edges)
    labels = None
    if pattern.labels is not None:
        out: list[int | None] = [None] * pattern.n
        for v, lab in enumerate(pattern.labels):
            out[int(perm[v])] = lab
        labels = tuple(out)
    return Pattern(pattern.n, edges,
                   name=f"{pattern.name or 'anon'}-iso{seed}",
                   labels=labels)
