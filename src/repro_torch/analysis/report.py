"""Violation record + report shared by the three analysis passes.

Every rule in ``repro_torch.analysis`` (flow / dispatch / lint) reports findings
as :class:`Violation` values — a stable, JSON-serializable shape so the CLI
can aggregate passes, the CI gate can upload one artifact, and tests can
assert "this fixture fires exactly rule X and nothing else" without parsing
formatted text.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule firing at one location.

    ``rule``  — stable rule ID (``FLOW-F64``, ``DISP-COUNT``, ``TH002`` ...).
    ``where`` — the audited unit: a hot-path name for jaxpr rules, a
    ``path:line`` for source rules.
    ``message`` — human-readable detail (what was found vs what the
    contract requires).
    """

    rule: str
    where: str
    message: str

    def format(self) -> str:
        return f"{self.rule} @ {self.where}: {self.message}"


def rule_ids(violations: Iterable[Violation]) -> set[str]:
    """Distinct rule IDs in a violation list (test helper)."""
    return {v.rule for v in violations}


def format_report(violations: list[Violation], checked: list[str]) -> str:
    """One text block: every violation, then the pass/fail summary line."""
    lines = [v.format() for v in violations]
    lines.append(
        f"repro_torch.analysis: {len(checked)} units checked, "
        f"{len(violations)} violation(s)"
        + ("" if violations else " — clean")
    )
    return "\n".join(lines)


def write_json(path: str, violations: list[Violation],
               checked: list[str]) -> None:
    """The CI artifact: machine-readable violation report."""
    doc = {
        "checked": checked,
        "violations": [dataclasses.asdict(v) for v in violations],
        "clean": not violations,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
