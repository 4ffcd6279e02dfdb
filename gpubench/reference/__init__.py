"""Plain references, one module per pattern, found by the pattern's
name in a traffic mix.  Each module holds `EDGES` (the pattern it counts,
on vertices 0..k-1) and `count(graph, dtype)`: the exact number of the
pattern's embeddings (subgraphs, not maps) in a `graphgen.DeviceCSR`,
worked out from the CSR alone in plain PyTorch.  `dtype` float64 is the
reference; float32 is the control, the same arithmetic one precision
lower.  Nothing here imports the program."""
from __future__ import annotations

import importlib
import itertools


def load(name: str):
    """The reference module for pattern `name`."""
    return importlib.import_module(f"{__name__}.{name}")


def same_pattern(k: int, edges, ref_edges) -> bool:
    """Whether `edges` on k vertices is isomorphic to `ref_edges`."""
    want = {frozenset(e) for e in ref_edges}
    have = [tuple(e) for e in edges]
    if len(have) != len(want) or max(max(e) for e in ref_edges) + 1 != k:
        return False
    return any({frozenset((p[u], p[v])) for u, v in have} == want
               for p in itertools.permutations(range(k)))
