"""MatchingPlan — a fully static compilation of one *configuration*
(schedule × restriction set [× IEP]) that the torch executor consumes.

All pattern vertices are relabeled to schedule order: loop position i
assigns pattern vertex i.  Everything here is plain Python data; the
executor closes over it so every jitted shape/branch is static.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import itertools

import numpy as np

from .iep import IEPPlan, build_iep_plan
from .pattern import Pattern
from .restrictions import Restriction, RestrictionSet
from .schedule import Schedule, predecessors


class IEPInvalidError(ValueError):
    """IEP folding is unsound for this (schedule, restriction set, k)."""


def iep_multiplicity(
    pattern: Pattern, surviving: Sequence[Restriction]
) -> int | None:
    """Per-subgraph overcount x under partial restrictions R'.

    Every subgraph instance with generic id ranking σ is found
    m(σ) = #{p ∈ Aut : σ∘p ⊨ R'} times.  The paper (§IV-D) derives x via
    `no_conflict`, but that counts *consistent* perms, which overestimates
    (e.g. triangle with R'={id0>id1}: no_conflict gives 5, the true
    multiplicity is 3).  We compute m(σ) exactly for all σ ∈ S_n and
    return it when constant; a non-constant m means no single divisor is
    correct and IEP must be rejected for this configuration — a soundness
    condition the paper does not state.
    """
    from .restrictions import perm_matrix

    n = pattern.n
    auts = pattern.automorphisms()
    sigmas = perm_matrix(n)
    m = np.zeros(len(sigmas), dtype=np.int64)
    for p in auts:
        ok = np.ones(len(sigmas), dtype=bool)
        for (a, b) in surviving:
            ok &= sigmas[:, p[a]] > sigmas[:, p[b]]
        m += ok
    if not (m == m[0]).all():
        return None
    return int(m[0])


@dataclass(frozen=True)
class MatchingPlan:
    pattern: Pattern            # original labeling
    order: Schedule             # schedule (original vertex ids)
    n: int
    # per loop position i (schedule-relabeled):
    preds: tuple[tuple[int, ...], ...]       # adjacent earlier positions
    neqs: tuple[tuple[int, ...], ...]        # earlier positions needing !=
    # restrictions at position i: (other_pos, dir); dir=+1 → v_i > v_other
    restr: tuple[tuple[tuple[int, int], ...], ...]
    iep: IEPPlan | None         # folded tail, or None (enumeration to depth n)
    iep_divisor: int            # x in ans = ans_IEP / x  (1 when iep is None)
    res_set: RestrictionSet     # original labeling (for reporting)
    # vertex label required at loop position i (None = wildcard);
    # None altogether for unlabeled patterns.
    vlabels: tuple[int | None, ...] | None = None

    @property
    def depth(self) -> int:
        """Number of explicit loops (prefix length)."""
        return self.n - (self.iep.k if self.iep else 0)


def build_plan(
    pattern: Pattern,
    order: Schedule,
    res_set: Sequence[Restriction],
    *,
    iep_k: int = 0,
) -> MatchingPlan:
    n = pattern.n
    if sorted(order) != list(range(n)):
        raise ValueError(f"order {order} is not a permutation of 0..{n-1}")
    if iep_k > 0 and pattern.labels is not None:
        # IEP folds the tail into closed-form cardinalities over unlabeled
        # candidate sets; per-label tail sets are future work, so labeled
        # plans always enumerate to depth n (best_iep_k returns 0 for them).
        raise ValueError("IEP folding is not supported for labeled patterns")
    pos = {v: i for i, v in enumerate(order)}
    rel = pattern.relabel(order)          # position-major pattern
    preds = tuple(tuple(p) for p in predecessors(rel, tuple(range(n))))
    if any(len(preds[i]) == 0 for i in range(1, n)):
        raise ValueError("schedule is not prefix-connected")

    # Restrictions (a, b): id(a) > id(b); enforce at max position.
    restr: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for (a, b) in res_set:
        pa, pb = pos[a], pos[b]
        if pa > pb:
            restr[pa].append((pb, +1))    # v_pa > v_pb
        else:
            restr[pb].append((pa, -1))    # v_pb < v_pa
    # != constraints for earlier non-neighbors (neighbors are != for free —
    # no self loops in the data graph).
    neqs = tuple(
        tuple(j for j in range(i) if j not in preds[i]) for i in range(n)
    )

    iep_plan = None
    divisor = 1
    if iep_k > 0:
        tail = list(range(n - iep_k, n))
        rel_adj = rel.adjacency()
        for a in tail:
            for b in tail:
                if a < b and rel_adj[a, b]:
                    raise ValueError(
                        f"IEP tail {tail} is not an independent set in the "
                        f"relabeled pattern"
                    )
        surviving = tuple(
            (a, b) for (a, b) in res_set if max(pos[a], pos[b]) < n - iep_k
        )
        divisor = iep_multiplicity(pattern, surviving)
        if divisor is None:
            raise IEPInvalidError(
                f"surviving restrictions {surviving} give a non-constant "
                f"per-subgraph multiplicity; IEP with k={iep_k} is unsound "
                f"for schedule {order}"
            )
        iep_plan = build_iep_plan([preds[t] for t in tail])
        restr = [r if i < n - iep_k else [] for i, r in enumerate(restr)]

    return MatchingPlan(
        pattern=pattern,
        order=tuple(order),
        n=n,
        preds=preds,
        neqs=neqs,
        restr=tuple(tuple(r) for r in restr),
        iep=iep_plan,
        iep_divisor=divisor,
        res_set=tuple(res_set),
        vlabels=rel.labels,
    )


# ----------------------------------------------------------- serialization
def plan_to_dict(plan: MatchingPlan) -> dict:
    """JSON-serializable record of a compiled plan.

    The full derived structure is persisted (not just the build_plan
    inputs) so `plan_from_dict` reconstructs the exact MatchingPlan
    without re-running the IEP soundness validation — the on-disk plan
    store's load path must stay O(read), and dataclass equality with
    the original plan is what the round-trip tests pin down.
    """
    out = {
        "pattern": plan.pattern.to_dict(),
        "order": list(plan.order),
        "n": int(plan.n),
        "preds": [list(p) for p in plan.preds],
        "neqs": [list(q) for q in plan.neqs],
        "restr": [[list(r) for r in level] for level in plan.restr],
        "iep": None if plan.iep is None else {
            "k": int(plan.iep.k),
            "unions": [list(u) for u in plan.iep.unions],
            "terms": [[int(c), list(idxs)] for c, idxs in plan.iep.terms],
        },
        "iep_divisor": int(plan.iep_divisor),
        "res_set": [list(r) for r in plan.res_set],
    }
    if plan.vlabels is not None:
        # v2 field; omitted for unlabeled plans so v1 records stay
        # byte-identical and keep loading.
        out["vlabels"] = list(plan.vlabels)
    return out


def plan_from_dict(d: dict) -> MatchingPlan:
    iep = None
    if d["iep"] is not None:
        iep = IEPPlan(
            k=int(d["iep"]["k"]),
            unions=tuple(tuple(int(q) for q in u)
                         for u in d["iep"]["unions"]),
            terms=tuple((int(c), tuple(int(i) for i in idxs))
                        for c, idxs in d["iep"]["terms"]),
        )
    return MatchingPlan(
        pattern=Pattern.from_dict(d["pattern"]),
        order=tuple(int(v) for v in d["order"]),
        n=int(d["n"]),
        preds=tuple(tuple(int(p) for p in ps) for ps in d["preds"]),
        neqs=tuple(tuple(int(q) for q in qs) for qs in d["neqs"]),
        restr=tuple(tuple((int(c), int(s)) for c, s in level)
                    for level in d["restr"]),
        iep=iep,
        iep_divisor=int(d["iep_divisor"]),
        res_set=tuple((int(a), int(b)) for a, b in d["res_set"]),
        vlabels=None if d.get("vlabels") is None else tuple(
            None if lab is None else int(lab) for lab in d["vlabels"]),
    )


def best_iep_k(
    pattern: Pattern, order: Schedule, res_set: Sequence[Restriction]
) -> int:
    """Largest SOUND k: tail independent AND constant multiplicity.

    Labeled patterns always get k=0 (see build_plan)."""
    if pattern.labels is not None:
        return 0
    pos = {v: i for i, v in enumerate(order)}
    n = pattern.n
    k = max_iep_k(pattern, order)
    while k >= 1:
        surviving = tuple(
            (a, b) for (a, b) in res_set if max(pos[a], pos[b]) < n - k
        )
        if iep_multiplicity(pattern, surviving) is not None:
            return k
        k -= 1
    return 0


def max_iep_k(pattern: Pattern, order: Schedule) -> int:
    """Largest k such that the last k scheduled vertices are pairwise
    non-adjacent (candidates for IEP folding).  0 for labeled patterns:
    IEP folding is unlabeled-only (see build_plan)."""
    if pattern.labels is not None:
        return 0
    rel = pattern.relabel(order).adjacency()
    n = pattern.n
    k = 1
    while k < n:
        tail = range(n - k - 1, n)
        ok = all(
            not rel[a, b]
            for a in tail
            for b in tail
            if a < b
        )
        if not ok:
            break
        k += 1
    return min(k, n - 1)  # keep at least one explicit loop
