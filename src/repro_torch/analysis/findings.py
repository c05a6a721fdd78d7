"""The one reporting currency of ``repro_torch.analysis``: :class:`Finding`.

The port's copy of ``repro.analysis.findings``.  The plan verifier
(``analysis.verifier``) and the specialization census
(``analysis.recompile``) report through this dataclass, so one gate and
one JSON schema cover both.  A finding names the rule that produced it, a
severity (only ``"error"`` gates), a location (``path:line`` — for plan
findings the path is the synthetic ``plan:<query>/<engine>`` and the line
the GAO level), the defect, and a fix hint.

Suppression: a source line carrying ``# repro: noqa-<rule>`` silences
that rule on that line (source passes only — plan findings have no source
line to annotate); the marker is the JAX package's, so one annotation
serves both packages.
"""
from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field

#: severities, most severe first.  Only ``error`` fails the CI gate.
SEVERITIES = ("error", "warning", "note")

#: inline suppression marker: ``# repro: noqa-<rule-id>``.
NOQA_RE = re.compile(r"#\s*repro:\s*noqa-([A-Za-z0-9_-]+)")


@dataclass(frozen=True)
class Finding:
    """One defect reported by a static pass.

    ``rule`` is the catalog id (``V101`` … for the plan verifier,
    kebab-case names for lint rules), ``severity`` one of
    :data:`SEVERITIES`, ``path``/``line`` the location (``line`` 0 when
    the finding has no source anchor), ``message`` the defect statement
    and ``hint`` how to fix it.
    """

    rule: str
    severity: str
    path: str
    line: int
    message: str
    hint: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"options: {SEVERITIES}")

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        out = f"{loc}: {self.severity} [{self.rule}] {self.message}"
        if self.hint:
            out += f"  (fix: {self.hint})"
        return out

    def to_dict(self) -> dict:
        return asdict(self)


class PlanVerificationError(ValueError):
    """A plan failed static verification.  Carries the error-severity
    :class:`Finding` list that rejected it (``.findings``); the message
    is their one-line formats joined."""

    def __init__(self, findings: list):
        self.findings = list(findings)
        super().__init__("; ".join(f.format() for f in self.findings)
                         or "plan verification failed")


@dataclass
class FindingReport:
    """A batch of findings plus the gate decision over them."""

    findings: list = field(default_factory=list)

    def errors(self) -> list:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def gate_passes(self) -> bool:
        return not self.errors()

    def to_json(self, **meta) -> str:
        doc = {**meta,
               "n_findings": len(self.findings),
               "n_errors": len(self.errors()),
               "gate": "pass" if self.gate_passes else "fail",
               "findings": [f.to_dict() for f in self.findings]}
        return json.dumps(doc, indent=2, sort_keys=True)


def suppressed(finding: Finding, source_lines: list[str]) -> bool:
    """True when the finding's source line carries its noqa marker."""
    if not finding.line or finding.line > len(source_lines):
        return False
    line = source_lines[finding.line - 1]
    return finding.rule in NOQA_RE.findall(line)


def filter_suppressed(findings: list[Finding],
                      sources: dict[str, str]) -> list[Finding]:
    """Drop findings whose anchor line carries ``# repro: noqa-<rule>``.

    ``sources`` maps path -> file text for every path findings may
    reference; paths not in the map (e.g. synthetic ``plan:*`` paths)
    are never suppressed.
    """
    out = []
    split: dict[str, list[str]] = {}
    for f in findings:
        if f.path in sources:
            lines = split.setdefault(f.path, sources[f.path].splitlines())
            if suppressed(f, lines):
                continue
        out.append(f)
    return out
