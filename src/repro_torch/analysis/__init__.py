# The static soundness verifier's plan pass (copies of the reference's
# `analysis/findings.py` and `analysis/soundness.py`), which the plan
# store's loader and `PlanStore.fsck()` run over every record.
from .findings import ERROR, INFO, WARNING, Finding, has_errors
from .soundness import verify_plan

__all__ = ["ERROR", "INFO", "WARNING", "Finding", "has_errors",
           "verify_plan"]
