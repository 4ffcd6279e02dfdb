"""Pattern representation and automorphism (permutation) group.

A pattern is a small undirected graph (n <= 8 in practice), optionally
vertex-labeled: ``labels[v]`` is the label id vertex v must match in the
data graph, or None for a wildcard position.  Labels shrink the
automorphism group to the label-preserving subgroup, so labeled patterns
need fewer (or equal) symmetry-breaking restrictions than their
unlabeled skeletons.  All plan-time machinery here is pure Python/numpy
— the paper does the same (Table III: preprocessing is milliseconds).
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

Edge = tuple[int, int]
Perm = tuple[int, ...]


@dataclass(frozen=True)
class Pattern:
    """An undirected pattern graph on vertices 0..n-1."""

    n: int
    edges: tuple[Edge, ...]
    name: str = ""
    labels: tuple[int | None, ...] | None = None

    def __post_init__(self) -> None:
        seen = set()
        for (u, v) in self.edges:
            if not (0 <= u < self.n and 0 <= v < self.n):
                raise ValueError(f"edge {(u, v)} out of range for n={self.n}")
            if u == v:
                raise ValueError(f"self-loop {(u, v)} not allowed")
            key = (min(u, v), max(u, v))
            if key in seen:
                raise ValueError(f"duplicate edge {(u, v)}")
            seen.add(key)
        # Canonicalize edge ordering.
        object.__setattr__(
            self, "edges", tuple(sorted((min(u, v), max(u, v)) for u, v in self.edges))
        )
        if self.labels is not None:
            if len(self.labels) != self.n:
                raise ValueError(
                    f"labels has {len(self.labels)} entries for n={self.n}"
                )
            norm = []
            for lab in self.labels:
                if lab is None:
                    norm.append(None)
                    continue
                lab = int(lab)
                if lab < 0:
                    raise ValueError(f"label {lab} must be >= 0")
                norm.append(lab)
            # All-wildcard is the unlabeled pattern: normalize so the two
            # spellings share one canonical key / cache entry / store digest.
            if all(lab is None for lab in norm):
                object.__setattr__(self, "labels", None)
            else:
                object.__setattr__(self, "labels", tuple(norm))

    # ---------------------------------------------------------------- helpers
    @property
    def m(self) -> int:
        return len(self.edges)

    def adjacency(self) -> np.ndarray:
        adj = np.zeros((self.n, self.n), dtype=bool)
        for u, v in self.edges:
            adj[u, v] = adj[v, u] = True
        return adj

    def neighbors(self, v: int) -> tuple[int, ...]:
        adj = self.adjacency()
        return tuple(int(u) for u in np.nonzero(adj[v])[0])

    def degree(self, v: int) -> int:
        return len(self.neighbors(v))

    def is_connected(self) -> bool:
        if self.n == 0:
            return True
        adj = self.adjacency()
        seen = {0}
        stack = [0]
        while stack:
            u = stack.pop()
            for w in np.nonzero(adj[u])[0]:
                w = int(w)
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return len(seen) == self.n

    def is_labeled(self) -> bool:
        return self.labels is not None

    def skeleton(self) -> "Pattern":
        """The unlabeled pattern with the same edges (identity if unlabeled)."""
        if self.labels is None:
            return self
        return Pattern(self.n, self.edges, name=self.name)

    def with_labels(self, labels: Sequence[int | None] | None) -> "Pattern":
        return Pattern(self.n, self.edges, name=self.name,
                       labels=None if labels is None else tuple(labels))

    # ----------------------------------------------------------- group theory
    def automorphisms(self) -> list[Perm]:
        """All permutations p with (u,v) in E  <=>  (p[u],p[v]) in E,
        restricted to the label-preserving subgroup when labeled
        (labels[p[v]] == labels[v] for every v, wildcards included).

        Brute force over n! — fine for pattern sizes (n<=8 → 40320).
        Cached per pattern: Algorithm 1's K_n validation calls this at
        every leaf of its search tree.
        """
        return list(_automorphisms_cached(self))

    def aut_count(self) -> int:
        return len(self.automorphisms())

    def max_independent_set_size(self) -> int:
        """k = size of the largest set of pairwise non-adjacent vertices."""
        adj = self.adjacency()
        best = 0
        for mask in range(1 << self.n):
            verts = [i for i in range(self.n) if mask >> i & 1]
            if len(verts) <= best:
                continue
            if all(not adj[a, b] for a, b in itertools.combinations(verts, 2)):
                best = len(verts)
        return best

    def relabel(self, order: Sequence[int]) -> "Pattern":
        """Relabel so that order[i] becomes vertex i (i.e. schedule-major)."""
        pos = {v: i for i, v in enumerate(order)}
        edges = tuple((pos[u], pos[v]) for u, v in self.edges)
        labels = None
        if self.labels is not None:
            out: list[int | None] = [None] * self.n
            for v, lab in enumerate(self.labels):
                out[pos[v]] = lab
            labels = tuple(out)
        return Pattern(self.n, edges, name=self.name, labels=labels)

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        """JSON-serializable record; `from_dict` round-trips exactly.

        The "labels" key is emitted only for labeled patterns so unlabeled
        records are byte-identical to the pre-label (store v1) encoding.
        """
        d = {"n": self.n, "edges": [list(e) for e in self.edges],
             "name": self.name}
        if self.labels is not None:
            d["labels"] = list(self.labels)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Pattern":
        labels = d.get("labels")
        return Pattern(int(d["n"]),
                       tuple((int(u), int(v)) for u, v in d["edges"]),
                       name=str(d.get("name", "")),
                       labels=None if labels is None else tuple(
                           None if lab is None else int(lab) for lab in labels))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        lab = f", labels={list(self.labels)}" if self.labels is not None else ""
        return (f"Pattern({self.name or 'anon'}, n={self.n}, "
                f"edges={list(self.edges)}{lab})")


@functools.lru_cache(maxsize=1024)
def _automorphisms_cached(pattern: "Pattern") -> tuple[Perm, ...]:
    adj = pattern.adjacency()
    labels = pattern.labels
    auts: list[Perm] = []
    for p in itertools.permutations(range(pattern.n)):
        ok = True
        if labels is not None:
            for v in range(pattern.n):
                if labels[p[v]] != labels[v]:
                    ok = False
                    break
        if ok:
            for u, v in pattern.edges:
                if not adj[p[u], p[v]]:
                    ok = False
                    break
        if ok:
            auts.append(tuple(p))
    return tuple(auts)


# --------------------------------------------------------------- cycle algebra
def perm_to_cycles(p: Perm) -> list[tuple[int, ...]]:
    """Disjoint-cycle decomposition of a permutation."""
    seen = [False] * len(p)
    cycles = []
    for start in range(len(p)):
        if seen[start]:
            continue
        cyc = [start]
        seen[start] = True
        nxt = p[start]
        while nxt != start:
            cyc.append(nxt)
            seen[nxt] = True
            nxt = p[nxt]
        cycles.append(tuple(cyc))
    return cycles


@functools.lru_cache(maxsize=65536)
def two_cycles_of(p: Perm) -> list[tuple[int, int]]:
    """All 2-cycles (u, p[u]) with p[p[u]] == u and p[u] != u.

    This is the paper's line-11 test `vertex == perm[perm[vertex]]`.
    """
    out = []
    for u in range(len(p)):
        v = p[u]
        if v != u and p[v] == u and u < v:
            out.append((u, v))
    return out


def identity_perm(n: int) -> Perm:
    return tuple(range(n))


# ------------------------------------------------------------ pattern library
def clique(n: int, name: str | None = None) -> Pattern:
    return Pattern(n, tuple(itertools.combinations(range(n), 2)), name or f"clique{n}")


def cycle(n: int, name: str | None = None) -> Pattern:
    return Pattern(n, tuple((i, (i + 1) % n) for i in range(n)), name or f"cycle{n}")


def path(n: int, name: str | None = None) -> Pattern:
    return Pattern(n, tuple((i, i + 1) for i in range(n - 1)), name or f"path{n}")


def star(n: int, name: str | None = None) -> Pattern:
    return Pattern(n, tuple((0, i) for i in range(1, n)), name or f"star{n}")


def house() -> Pattern:
    """House (Fig. 5a): square 0-1-2-3 plus roof apex 4 on edge (0,1).

    |Aut| = 2 (mirror symmetry).
    """
    return Pattern(5, ((0, 1), (1, 2), (2, 3), (0, 3), (0, 4), (1, 4)), "house")


def rectangle() -> Pattern:
    """4-cycle (Fig. 4a)."""
    return cycle(4, "rectangle")


def triangle() -> Pattern:
    return clique(3, "triangle")
