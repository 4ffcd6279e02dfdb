"""The one traffic generator: reads a mix from `traffic/<mix>.json` and
hands out the requests of a closed loop.

A mix file holds:

    {"loop": "closed",
     "clients": 1,                 # requests outstanding at once
     "queries": [                  # drawn by weight, from the seed
        {"pattern": "house",       # names reference/<pattern>.py
         "edges": [[0, 1], ...],   # the pattern, as the program gets it
         "mode": "graphpi", "use_iep": false, "weight": 1}]}

A closed loop sends a client's next request once its previous one has
completed; with C clients each engine round takes the C outstanding
requests.
"""
from __future__ import annotations

import random
from dataclasses import dataclass


@dataclass(frozen=True)
class Query:
    """One kind of request of a mix."""

    pattern: str
    edges: tuple
    mode: str
    use_iep: bool
    weight: float

    @property
    def vertices(self) -> int:
        return max(max(e) for e in self.edges) + 1


def queries(mix: dict) -> list[Query]:
    if mix.get("loop") != "closed":
        raise ValueError(f"only closed loops are generated, got "
                         f"{mix.get('loop')!r}")
    out = [Query(q["pattern"], tuple(tuple(e) for e in q["edges"]),
                 q.get("mode", "graphpi"), bool(q.get("use_iep", False)),
                 float(q.get("weight", 1))) for q in mix["queries"]]
    if not out or any(q.weight <= 0 for q in out):
        raise ValueError("a mix needs queries, each of positive weight")
    return out


class Requests:
    """The mix's requests in the order the seed draws them."""

    def __init__(self, mix: dict, seed: int):
        self.kinds = queries(mix)
        self.clients = int(mix.get("clients", 1))
        if self.clients < 1:
            raise ValueError("a closed loop needs at least one client")
        self._rng = random.Random(seed)
        self._weights = [q.weight for q in self.kinds]

    def round(self) -> list[Query]:
        """The next round: one request per client."""
        return self._rng.choices(self.kinds, self._weights, k=self.clients)
