"""GraphPi workload configuration: evaluation patterns and datasets.

The paper's Fig. 7 shows six patterns P1..P6 but only as an image; the
text pins down P1/P2 (the two GraphZero patterns — the House and the
Pentagon) and says P4's top 4 vertices form a rectangle (Fig. 11
discussion).  We reconstruct the rest as a representative spread of
sizes 5-7 with |Aut| from 2 to 48 — the properties the paper's
evaluation stresses (symmetry-heavy patterns, non-trivial independent
sets for IEP, schedule spaces large enough that selection matters).

Dataset stand-ins are synthetic RMAT/ER graphs scaled like Table I
(the container is offline); `graph.datasets.load_edge_list` accepts the
real SNAP files unchanged.
"""
from __future__ import annotations

from ..core.pattern import Pattern, clique, cycle, house
from ..graph.datasets import named_dataset

# --------------------------------------------------------------------------
# P1..P6 (reconstruction documented above; |Aut| verified by tests)
# --------------------------------------------------------------------------
PATTERNS: dict[str, Pattern] = {
    # P1: House — rectangle + roof apex (GraphZero pattern).      |Aut| = 2
    "P1": house(),
    # P2: Pentagon — 5-cycle (GraphZero pattern).                 |Aut| = 10
    "P2": cycle(5, "pentagon"),
    # P3: Hexagon — 6-cycle.                                      |Aut| = 12
    "P3": cycle(6, "hexagon"),
    # P4: Rectangle + apex on a diagonal (top 4 vertices form a
    #     rectangle, as the Fig. 11 discussion requires).         |Aut| = 4
    "P4": Pattern(5, ((0, 1), (1, 2), (2, 3), (0, 3), (0, 4), (2, 4)),
                  name="rect-diag-apex"),
    # P5: Prism — two triangles joined by a perfect matching.     |Aut| = 12
    "P5": Pattern(6, ((0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5),
                      (0, 3), (1, 4), (2, 5)), name="prism"),
    # P6: Hexagon + center (wheel W6) — 7 vertices, high symmetry,
    #     independent-set tail of size 3 for IEP.                 |Aut| = 12
    "P6": Pattern(7, ((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (0, 5),
                      (6, 0), (6, 1), (6, 2), (6, 3), (6, 4), (6, 5)),
                  name="wheel6"),
}

# Extra patterns used by tests / IEP ablations.
EXTRA_PATTERNS: dict[str, Pattern] = {
    "triangle": clique(3),
    "rectangle": cycle(4, "rectangle"),
    "clique4": clique(4),
    "clique5": clique(5),
    # The paper's Fig. 6 motif: D, E, F pairwise non-adjacent (k = 3),
    # each attached to two vertices of the triangle A-B-C.
    "fig6": Pattern(6, ((0, 1), (1, 2), (0, 2), (0, 3), (1, 3),
                        (1, 4), (2, 4), (0, 5), (2, 5)), name="fig6"),
}


def get_pattern(name: str) -> Pattern:
    if name in PATTERNS:
        return PATTERNS[name]
    if name in EXTRA_PATTERNS:
        return EXTRA_PATTERNS[name]
    raise KeyError(
        f"unknown pattern {name!r}; have {sorted(PATTERNS) + sorted(EXTRA_PATTERNS)}"
    )


# --------------------------------------------------------------------------
# dataset tiers for the benchmarks (paper Table I stand-ins)
# --------------------------------------------------------------------------
QUICK_DATASETS = ["tiny-er", "small-rmat"]          # seconds on CPU
FULL_DATASETS = ["wiki-vote-syn", "mico-syn"]       # minutes on CPU
SCALE_DATASETS = ["patents-syn"]                    # dry-run / scaling only


def get_dataset(name: str):
    return named_dataset(name)
