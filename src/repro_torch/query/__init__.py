# Canonical pattern identity (copied from the reference's query/canon.py).
from .canon import canonical_form, canonical_key, relabeled_variant

__all__ = ["canonical_form", "canonical_key", "relabeled_variant"]
