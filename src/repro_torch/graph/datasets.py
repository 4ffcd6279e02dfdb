"""Graph generators and loaders.

The container is offline, so the paper's SNAP graphs are stood in for by
synthetic generators matched to their |V|/|E| scale (DESIGN.md §10).  The
edge-list loader accepts the exact SNAP format, so the real datasets plug
in unchanged on a connected machine.
"""
from __future__ import annotations

import numpy as np

from .csr import GraphCSR


def complete_graph(n: int) -> GraphCSR:
    iu = np.triu_indices(n, k=1)
    edges = np.stack([iu[0], iu[1]], axis=1)
    return GraphCSR.from_edges(n, edges, name=f"K{n}")


def erdos_renyi(n: int, m: int, seed: int = 0, name: str = "") -> GraphCSR:
    """~m undirected edges sampled uniformly (dedup may shave a few)."""
    rng = np.random.default_rng(seed)
    # oversample to survive dedup/self-loop removal
    k = int(m * 1.2) + 16
    e = rng.integers(0, n, size=(k, 2), dtype=np.int64)
    e = e[e[:, 0] != e[:, 1]][:m]
    return GraphCSR.from_edges(n, e, name=name or f"ER({n},{m})")


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    name: str = "",
    relabel_by_degree: bool = True,
) -> GraphCSR:
    """R-MAT power-law generator (Graph500 parameters by default).

    Produces the heavy-tailed degree distributions that make the paper's
    load-balancing (fine-grained task partitioning) matter.
    """
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # quadrant probabilities (a, b, c, d)
        go_right = r >= a + b          # dst high bit
        go_down = ((r >= a) & (r < a + b)) | (r >= a + b + c)  # src high bit
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    edges = np.stack([src, dst], axis=1)
    return GraphCSR.from_edges(
        n, edges, relabel_by_degree=relabel_by_degree, name=name or f"RMAT{scale}"
    )


def random_labels(
    n: int, n_labels: int, seed: int = 0, skew: float = 1.0
) -> np.ndarray:
    """Per-vertex labels 0..n_labels-1 with a geometric-ish skew.

    skew=1.0 is uniform; skew>1 makes low label ids more common (real
    property graphs are dominated by a few frequent types).  Every label
    id is guaranteed at least one vertex when n >= n_labels so per-label
    CSR views and question inventories never see an empty class.
    """
    if n_labels < 1:
        raise ValueError("n_labels must be >= 1")
    rng = np.random.default_rng(seed)
    w = skew ** -np.arange(n_labels, dtype=np.float64)
    labels = rng.choice(n_labels, size=n, p=w / w.sum()).astype(np.int32)
    if n >= n_labels:
        # pin one representative per label at random positions
        pos = rng.choice(n, size=n_labels, replace=False)
        labels[pos] = np.arange(n_labels, dtype=np.int32)
    return labels


def labeled_rmat(
    scale: int,
    edge_factor: int = 8,
    n_labels: int = 4,
    seed: int = 0,
    skew: float = 1.5,
    name: str = "",
) -> GraphCSR:
    """R-MAT skeleton with skewed random vertex labels — the synthetic
    property graph used by the labeled benchmarks.  Labels are drawn
    AFTER the degree relabel so label classes cut across the degree
    distribution (typed hubs and typed leaves both exist)."""
    g = rmat(scale, edge_factor, seed=seed,
             name=name or f"LRMAT{scale}x{n_labels}")
    labels = random_labels(g.n, n_labels, seed=seed + 1, skew=skew)
    return GraphCSR(n=g.n, m=g.m, indptr=g.indptr, indices=g.indices,
                    degrees=g.degrees, name=g.name, labels=labels)


def labeled_er(
    n: int,
    m: int,
    n_labels: int = 4,
    seed: int = 0,
    skew: float = 1.5,
    name: str = "",
) -> GraphCSR:
    """Erdős–Rényi skeleton with skewed random vertex labels."""
    rng = np.random.default_rng(seed)
    k = int(m * 1.2) + 16
    e = rng.integers(0, n, size=(k, 2), dtype=np.int64)
    e = e[e[:, 0] != e[:, 1]][:m]
    labels = random_labels(n, n_labels, seed=seed + 1, skew=skew)
    return GraphCSR.from_edges(n, e, labels=labels,
                               name=name or f"LER({n},{m},{n_labels})")


def load_edge_list(path: str, name: str = "") -> GraphCSR:
    """SNAP-style whitespace edge list; '#' comments allowed."""
    edges = np.loadtxt(path, dtype=np.int64, comments="#").reshape(-1, 2)
    n = int(edges.max()) + 1
    return GraphCSR.from_edges(n, edges, name=name or path)


# --------------------------------------------------------------------------
# Named synthetic stand-ins scaled like the paper's datasets (Table I).
# (wiki-vote 7.1K/100.8K, mico 96.6K/1.1M, patents 3.8M/16.5M, ...)
# Only the first two are sized for CPU-quick runs; the rest gate behind
# explicit benchmark flags.
# --------------------------------------------------------------------------
_NAMED = {
    "wiki-vote-syn": lambda: rmat(13, 12, seed=1, name="wiki-vote-syn"),
    "mico-syn": lambda: rmat(17, 11, seed=2, name="mico-syn"),
    "patents-syn": lambda: rmat(22, 4, seed=3, name="patents-syn"),
    "tiny-er": lambda: erdos_renyi(256, 2048, seed=4, name="tiny-er"),
    "small-rmat": lambda: rmat(10, 8, seed=5, name="small-rmat"),
    # Property-graph stand-ins: the questions benchmark pins tiny-labeled
    # (small enough for the brute-force oracle to answer every question).
    "tiny-labeled": lambda: labeled_er(
        256, 1536, n_labels=4, seed=11, name="tiny-labeled"),
    "small-labeled-rmat": lambda: labeled_rmat(
        10, 8, n_labels=4, seed=12, name="small-labeled-rmat"),
}


def named_dataset(name: str) -> GraphCSR:
    if name not in _NAMED:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(_NAMED)}")
    return _NAMED[name]()
