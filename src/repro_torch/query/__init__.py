# Pattern-query serving (the reference's DESIGN.md §5): canonical
# pattern identity (canon, a copy), plan/matcher memoization (cache) and
# the batched request engine over a resident graph (engine).  The plan
# store arrives with its own slice.
from .canon import canonical_form, canonical_key, relabeled_variant
from .cache import CacheEntry, PlanCache
from .engine import (
    AdmissionRejected, PlannedQuery, QueryEngine, QueryRequest, QueryResult,
    Rejection, Ticket,
)

__all__ = [
    "AdmissionRejected",
    "CacheEntry",
    "PlanCache",
    "PlannedQuery",
    "QueryEngine",
    "QueryRequest",
    "QueryResult",
    "Rejection",
    "Ticket",
    "canonical_form",
    "canonical_key",
    "relabeled_variant",
]
