"""Rule framework of the hot-path contract checker (port of
``repro.analysis.core``; the reference's DESIGN.md §12 has the catalog).

Every serving-path invariant is a ``Rule`` with a stable id and
severity.  Rules ``check()`` a context dict and return structured
``Finding``s; ``run_rules`` aggregates them into a ``Report`` that renders
for humans, serializes to JSON for CI, and answers "is this step clean?"
with one bit.  ``Report.render()`` and ``Report.to_json()`` are the
reference's, character for character, so reports of the two packages
compare directly.

Contract for ``Rule.check(ctx)``:

  * return ``None``  -> the rule does not apply to this context (e.g. the
    all-gather rule on a single-device engine); recorded as *skipped*;
  * return ``[]``    -> the rule ran and the invariant holds;
  * return findings  -> violations, each carrying the rule's id/severity.

Rules are registered at import time in a global ``REGISTRY`` keyed by id;
the registry is what the CLI runner, the engine's ``verify_contracts``
hook, and the completeness test ("every rule has a mutation test")
enumerate.  Adding a rule = subclass + ``register()`` + a mutation test
in ``tests/test_torch_analysis.py`` that violates the invariant and
asserts the rule fires.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, List, Optional, Sequence


class Severity(enum.IntEnum):
    """Ordered so max() over findings yields the report's worst level."""
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.name


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured violation: which rule, how bad, where, and the
    machine-readable details a driver needs to act on it."""
    rule_id: str
    severity: Severity
    message: str
    subject: str = ""                 # e.g. "decode", "src/repro/x.py:12"
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"rule": self.rule_id, "severity": self.severity.name,
                "subject": self.subject, "message": self.message,
                "details": self.details}


class Rule:
    """Base rule: id / severity / one-line invariant + ``check``."""
    id: str = ""
    severity: Severity = Severity.ERROR
    invariant: str = ""               # one line, shown in reports/docs
    origin: str = ""                  # which PR introduced the contract

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        raise NotImplementedError

    def finding(self, message: str, subject: str = "",
                **details: Any) -> Finding:
        return Finding(self.id, self.severity, message, subject, details)


REGISTRY: Dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if not rule.id:
        raise ValueError(f"rule {rule!r} has no id")
    if rule.id in REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id}")
    REGISTRY[rule.id] = rule
    return rule


def all_rules() -> List[Rule]:
    return [REGISTRY[k] for k in sorted(REGISTRY)]


@dataclasses.dataclass
class Report:
    """Aggregated outcome of one checker pass over one subject."""
    subject: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    rules_run: List[str] = dataclasses.field(default_factory=list)
    rules_skipped: List[str] = dataclasses.field(default_factory=list)

    @property
    def clean(self) -> bool:
        """No ERROR-severity findings (warnings don't gate)."""
        return not self.errors

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity is Severity.ERROR]

    def by_severity(self) -> Dict[str, int]:
        out = {s.name: 0 for s in Severity}
        for f in self.findings:
            out[f.severity.name] += 1
        return out

    def to_json(self) -> Dict[str, Any]:
        return {
            "subject": self.subject,
            "clean": self.clean,
            "rules_run": sorted(self.rules_run),
            "rules_skipped": sorted(self.rules_skipped),
            "summary": self.by_severity(),
            "findings": [f.to_json() for f in self.findings],
        }

    def render(self) -> str:
        """Human report: worst findings first, one line per finding plus
        an indented detail line when there are details to show."""
        lines = [f"contract report [{self.subject}]: "
                 f"{'CLEAN' if self.clean else 'VIOLATIONS'} "
                 f"({len(self.rules_run)} rules run, "
                 f"{len(self.rules_skipped)} skipped, "
                 f"{len(self.findings)} findings)"]
        for f in sorted(self.findings, key=lambda f: -f.severity):
            where = f" [{f.subject}]" if f.subject else ""
            lines.append(f"  {f.severity.name:7s} {f.rule_id}{where}: "
                         f"{f.message}")
            if f.details:
                lines.append(f"          {json.dumps(f.details, default=str)}")
        return "\n".join(lines)


class ContractViolation(ValueError):
    """Raised by ``ServingEngine(verify_contracts=True)`` / the CLI when
    a pass produces ERROR-severity findings; carries the full report."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__(
            f"{len(report.errors)} contract violation(s) on "
            f"{report.subject!r}:\n{report.render()}")


def run_rules(rules: Sequence[Rule], ctx: Dict[str, Any],
              subject: str = "") -> Report:
    """Run ``rules`` over one context; a rule returning None is recorded
    as skipped (not applicable), [] as run-and-clean."""
    rep = Report(subject=subject)
    for rule in rules:
        found = rule.check(ctx)
        if found is None:
            rep.rules_skipped.append(rule.id)
        else:
            rep.rules_run.append(rule.id)
            rep.findings.extend(found)
    return rep
