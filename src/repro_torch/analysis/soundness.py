"""Pass 1 — plan/restriction soundness, proved without touching a graph.

A copy of `repro/analysis/soundness.py` (numpy only).

GraphPi's counting correctness rests on plan-time invariants that are
only enforced at construction time; this pass re-proves them for any
(Pattern, Schedule, RestrictionSet, IEP split) — or a whole persisted
`MatchingPlan` record — so the PlanStore fsck and the CI gate can catch
schema drift, buggy writers, or hand-edited records before they serve a
wrong count.

What "sound" means here (paper §IV, GraphZero's linear-ordering form):

  * partition: the automorphism group acting on id-orders must tile S_n
    so every subgraph instance is found EXACTLY once — for every order
    σ, #{p ∈ Aut : σ∘p satisfies R} == 1.  This single condition
    implies both the paper's validate() count
    (#satisfying orders == n!/|Aut|, i.e. the multi-set of |Aut|
    transformed sets covers all n! orders) and survivor elimination
    (only the identity survives `no_conflict`).  All three are checked
    independently — they fail differently under different corruptions.
  * schedule: a permutation of 0..n-1, prefix-connected (every loop
    intersects at least one earlier neighborhood — otherwise candidate
    generation is unseeded and the executor's predecessor gather is
    ill-defined).
  * restrictions are checkable where scheduled: each (a, b) is enforced
    at max(pos[a], pos[b]); under an IEP split only positions < depth
    are enumerated, so tail restrictions must be dropped AND the
    surviving prefix set must give a CONSTANT per-subgraph multiplicity
    (plan.py's `iep_multiplicity`) matching the plan's divisor.
  * IEP tail: the folded vertices must be pairwise non-adjacent in the
    schedule-relabeled pattern.
  * derived-field drift (plans only): preds/neqs/restr/iep are persisted
    pre-derived for O(read) loads; they must equal a fresh
    `build_plan` of the same inputs bit-for-bit.

Everything is pure Python/numpy over n ≤ 8 patterns — milliseconds,
same ballpark as the paper's plan-time stage (Table III).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..core.pattern import Pattern, Perm, identity_perm
from ..core.restrictions import (
    Restriction, count_orders_satisfying, perm_matrix, surviving_perms,
)
from ..core.schedule import Schedule, is_prefix_connected
from .findings import ERROR, INFO, Finding


def _err(rule: str, location: str, message: str) -> Finding:
    return Finding(ERROR, rule, location, message)


# ------------------------------------------------------- restriction sets
def partition_multiplicities(
    pattern: Pattern, res_set: Sequence[Restriction]
) -> np.ndarray:
    """m[σ] = #{p ∈ Aut : σ∘p satisfies res_set} for every σ ∈ S_n.

    A restriction set is sound iff m == 1 everywhere: each subgraph
    instance (generic id ranking σ) is counted exactly once.  This is
    the full-set case of plan.py's `iep_multiplicity`.
    """
    n = pattern.n
    sigmas = perm_matrix(n)
    m = np.zeros(len(sigmas), dtype=np.int64)
    for p in pattern.automorphisms():
        ok = np.ones(len(sigmas), dtype=bool)
        for (a, b) in res_set:
            ok &= sigmas[:, p[a]] > sigmas[:, p[b]]
        m += ok
    return m


def verify_restriction_set(
    pattern: Pattern,
    res_set: Sequence[Restriction],
    *,
    complete: bool = True,
    location: str = "",
) -> list[Finding]:
    """Prove `res_set` sound for `pattern` (no graph needed).

    `complete=False` (the naive-mode shape: empty set, count divided by
    |Aut| afterwards) skips the automorphism-elimination proofs and only
    validates structure.
    """
    loc = location or f"{pattern.name or 'pattern'} res_set={tuple(res_set)}"
    out: list[Finding] = []
    n = pattern.n

    seen: set[tuple[int, int]] = set()
    for (a, b) in res_set:
        if not (0 <= a < n and 0 <= b < n) or a == b:
            out.append(_err(
                "restriction-range", loc,
                f"restriction ({a}, {b}) is malformed for n={n}"))
        elif (a, b) in seen:
            out.append(_err(
                "restriction-range", loc, f"duplicate restriction ({a}, {b})"))
        elif (b, a) in seen:
            out.append(_err(
                "restriction-range", loc,
                f"contradictory pair ({a}, {b}) and ({b}, {a}): no id order "
                f"can satisfy both"))
        seen.add((a, b))
    if out or not complete:
        return out            # group-theory proofs need well-formed input

    auts = pattern.automorphisms()
    ident = identity_perm(n)
    survivors = surviving_perms(auts, tuple(res_set))
    if survivors != [ident]:
        extra = [p for p in survivors if p != ident]
        out.append(_err(
            "restriction-survivors", loc,
            f"{len(extra)} non-identity automorphism(s) survive, e.g. "
            f"{extra[0] if extra else survivors}; every embedding would be "
            f"found multiple times"))

    target = math.factorial(n) // len(auts)
    got = count_orders_satisfying(n, tuple(res_set))
    if got != target:
        out.append(_err(
            "restriction-order-count", loc,
            f"{got} id-orders satisfy the set; a complete set keeps exactly "
            f"n!/|Aut| = {target} (GraphZero: the |Aut| transformed sets "
            f"must tile all n! orders)"))

    m = partition_multiplicities(pattern, res_set)
    if not (m == 1).all():
        over = int((m > 1).sum())
        under = int((m == 0).sum())
        out.append(_err(
            "restriction-partition", loc,
            f"automorphism orbits do not partition the order space: "
            f"{over} orders counted multiple times, {under} never counted"))
    return out


# --------------------------------------------------------------- schedules
def verify_schedule(
    pattern: Pattern, order: Schedule, *, location: str = ""
) -> list[Finding]:
    loc = location or f"{pattern.name or 'pattern'} order={tuple(order)}"
    out: list[Finding] = []
    if sorted(order) != list(range(pattern.n)):
        out.append(_err(
            "schedule-permutation", loc,
            f"order {tuple(order)} is not a permutation of 0..{pattern.n - 1}"))
        return out
    if not is_prefix_connected(pattern, order):
        out.append(_err(
            "schedule-connected", loc,
            "schedule is not prefix-connected: some loop has no earlier "
            "neighbor to intersect against (unseeded candidate set)"))
    return out


# ----------------------------------------------------------- configurations
def verify_configuration(
    pattern: Pattern,
    order: Schedule,
    res_set: Sequence[Restriction],
    iep_k: int = 0,
    *,
    expected_divisor: int | None = None,
    complete: bool = True,
    location: str = "",
) -> list[Finding]:
    """Prove a whole (schedule × restriction set × IEP split) sound."""
    loc = location or (f"{pattern.name or 'pattern'} order={tuple(order)} "
                       f"iep_k={iep_k}")
    out = verify_schedule(pattern, order, location=loc)
    out += verify_restriction_set(
        pattern, res_set, complete=complete, location=loc)
    if any(f.rule in ("schedule-permutation", "restriction-range")
           for f in out):
        return out            # position math below needs sane input
    n = pattern.n
    if not (0 <= iep_k < n):
        out.append(_err(
            "iep-split-range", loc,
            f"iep_k={iep_k} out of range for n={n} (need 0 <= k < n: at "
            f"least one explicit loop)"))
        return out

    pos = {v: i for i, v in enumerate(order)}
    depth = n - iep_k

    # restrictions landing at folded positions >= depth are never
    # enumerated; build_plan drops them into the divisor, so here they
    # are only an observation — the iep-multiplicity check below is what
    # proves the drop sound
    if iep_k > 0:
        for (a, b) in res_set:
            p = max(pos[a], pos[b])
            if p >= depth:
                out.append(Finding(
                    INFO, "restriction-folded", loc,
                    f"restriction ({a}, {b}) lands at folded position {p} "
                    f">= depth {depth}; dropped into the IEP divisor"))

        rel_adj = pattern.relabel(order).adjacency()
        tail = range(depth, n)
        bad = [(int(a), int(b)) for a in tail for b in tail
               if a < b and rel_adj[a, b]]
        if bad:
            out.append(_err(
                "iep-tail-independent", loc,
                f"IEP tail positions {list(tail)} are not an independent "
                f"set (adjacent pairs {bad}): the closed-form cardinality "
                f"product is invalid"))

        from ..core.plan import iep_multiplicity

        surviving = tuple((a, b) for (a, b) in res_set
                          if max(pos[a], pos[b]) < depth)
        div = iep_multiplicity(pattern, surviving)
        if div is None:
            out.append(_err(
                "iep-multiplicity", loc,
                f"surviving restrictions {surviving} give a NON-CONSTANT "
                f"per-subgraph multiplicity; no single divisor makes "
                f"IEP k={iep_k} exact for this schedule"))
        elif expected_divisor is not None and div != expected_divisor:
            out.append(_err(
                "iep-multiplicity", loc,
                f"recorded IEP divisor {expected_divisor} != recomputed "
                f"multiplicity {div}; the replayed count would be off by "
                f"{expected_divisor}/{div}x"))
    elif expected_divisor is not None and expected_divisor != 1:
        out.append(_err(
            "iep-multiplicity", loc,
            f"divisor {expected_divisor} recorded without an IEP tail "
            f"(k=0 always divides by 1)"))
    return out


# ----------------------------------------------------------------- plans
def verify_plan(plan, *, mode: str = "graphpi",
                location: str = "") -> list[Finding]:
    """Prove a compiled/persisted `MatchingPlan` sound end to end.

    Beyond the configuration proofs this cross-checks every persisted
    DERIVED field (preds/neqs/restr/iep/divisor) against a fresh
    `build_plan` of the same inputs: the store's load path is O(read)
    by design (plan_to_dict persists the derivation), which is exactly
    where schema drift or a buggy writer silently corrupts counts.
    """
    from ..core.plan import build_plan

    loc = location or (f"plan[{plan.pattern.name or 'anon'} "
                       f"order={tuple(plan.order)}]")
    iep_k = plan.iep.k if plan.iep is not None else 0
    out = verify_configuration(
        plan.pattern, plan.order, plan.res_set, iep_k,
        expected_divisor=plan.iep_divisor,
        complete=(mode != "naive"),
        location=loc,
    )
    if plan.n != plan.pattern.n:
        out.append(_err(
            "plan-derived-drift", loc,
            f"plan.n={plan.n} != pattern.n={plan.pattern.n}"))
    # every persisted positional restriction must be checkable where it
    # is scheduled: against an EARLIER position, at an ENUMERATED one —
    # a tampered/drifted entry here compares against a vertex that is
    # unassigned (or never materialized) at check time
    depth = plan.depth
    for i, entries in enumerate(plan.restr):
        for (other, _dir) in entries:
            if not (0 <= other < i) or i >= depth:
                out.append(_err(
                    "restriction-checkable", loc,
                    f"restr[{i}] entry (other={other}, dir={_dir}) is not "
                    f"checkable: needs 0 <= other < {i} < depth {depth}"))
    if any(f.rule in ("schedule-permutation", "restriction-range",
                      "iep-split-range") for f in out):
        return out
    try:
        rebuilt = build_plan(plan.pattern, plan.order, plan.res_set,
                             iep_k=iep_k)
    except Exception as e:          # noqa: BLE001 — any rebuild failure
        out.append(_err(
            "plan-rebuild", loc,
            f"build_plan rejects the plan's own inputs: {e}"))
        return out
    # vlabels is derived too: it must be the pattern's labels permuted to
    # schedule order — a record whose labels and vlabels disagree serves
    # a different typed query than its key claims
    for field in ("preds", "neqs", "restr", "iep", "iep_divisor",
                  "vlabels"):
        want = getattr(rebuilt, field)
        got = getattr(plan, field)
        if got != want:
            out.append(_err(
                "plan-derived-drift", loc,
                f"persisted {field}={got!r} != derived {want!r} for the "
                f"recorded (pattern, order, res_set, iep_k)"))
    return out
