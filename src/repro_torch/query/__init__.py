# Pattern-query serving (the reference's DESIGN.md §5): canonical
# pattern identity (canon, a copy), plan/matcher memoization (cache),
# the persistent on-disk plan index (store) and the batched request
# engine over a resident graph (engine).
from .canon import canonical_form, canonical_key, relabeled_variant
from .cache import CacheEntry, PlanCache
from .engine import (
    AdmissionRejected, PlannedQuery, QueryEngine, QueryRequest, QueryResult,
    Rejection, Ticket,
)
from .store import PlanStore, StoreRecord

__all__ = [
    "AdmissionRejected",
    "CacheEntry",
    "PlanCache",
    "PlanStore",
    "PlannedQuery",
    "QueryEngine",
    "QueryRequest",
    "QueryResult",
    "Rejection",
    "StoreRecord",
    "Ticket",
    "canonical_form",
    "canonical_key",
    "relabeled_variant",
]
