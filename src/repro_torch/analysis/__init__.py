# The port's static soundness verifier: plan/restriction soundness
# proofs (soundness, a copy of the reference's, which the plan store's
# loader and `PlanStore.fsck()` run over every record), K1's contract
# over the executor's call shapes (kernel_contracts) and the
# repo-invariant AST lint (lint), all reporting structured Finding
# records.  Front doors: `python -m repro_torch.analysis` and
# `PlanStore.fsck()`.
from .findings import (
    ERROR, INFO, WARNING, Finding, error_count, format_findings, has_errors,
)
from .kernel_contracts import (
    LevelExpandSpec, abstract_eval_spec, check_graph_contract, check_spec,
    executor_specs,
)
from .lint import lint_source, lint_tree
from .soundness import (
    verify_configuration, verify_plan, verify_restriction_set,
    verify_schedule,
)

__all__ = [
    "ERROR",
    "INFO",
    "WARNING",
    "Finding",
    "LevelExpandSpec",
    "abstract_eval_spec",
    "check_graph_contract",
    "check_spec",
    "error_count",
    "executor_specs",
    "format_findings",
    "has_errors",
    "lint_source",
    "lint_tree",
    "verify_configuration",
    "verify_plan",
    "verify_restriction_set",
    "verify_schedule",
]
