"""Structured findings — the one output type every analysis pass emits.

A copy of `repro/analysis/findings.py` (numpy only).

A Finding is deliberately flat (severity, rule, location, message) so
passes compose: the CLI concatenates lists from independent passes, the
PlanStore fsck keys them per record digest, and tests assert on stable
`rule` identifiers instead of message text.

Severity policy (DESIGN.md §6):
  error    the checked object is UNSOUND — serving it can return wrong
           counts or crash on device; gates CI, quarantines fsck records.
  warning  suspicious but not provably wrong (e.g. a contract that holds
           only because of a current default); never gates.
  info     observations useful in reports (e.g. pass statistics).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITIES = (ERROR, WARNING, INFO)


@dataclass(frozen=True)
class Finding:
    severity: str            # one of ERROR / WARNING / INFO
    rule: str                # stable kebab-case rule id (tests key on it)
    location: str            # "path.py:12" | "P1 order=(0,1,2)" | digest
    message: str             # human-readable diagnosis

    def __post_init__(self) -> None:
        if self.severity not in _SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {_SEVERITIES}")

    def line(self) -> str:
        return f"{self.severity.upper():<7} [{self.rule}] " \
               f"{self.location}: {self.message}"


def has_errors(findings: Iterable[Finding]) -> bool:
    return any(f.severity == ERROR for f in findings)


def error_count(findings: Iterable[Finding]) -> int:
    return sum(1 for f in findings if f.severity == ERROR)


def format_findings(findings: Sequence[Finding], *, header: str = "") -> str:
    out = [header] if header else []
    sev_rank = {ERROR: 0, WARNING: 1, INFO: 2}
    for f in sorted(findings, key=lambda f: (sev_rank[f.severity],
                                             f.location, f.rule)):
        out.append("  " + f.line())
    if not findings:
        out.append("  (no findings)")
    return "\n".join(out)
