"""Machine-readable findings: (rule, file:line, message, severity).

The port's copy of ``repro.analysis.findings``: the JSON is the same, field
for field, so the two packages' outputs and baselines read alike.
"""
from __future__ import annotations

import dataclasses
import json

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # e.g. "HS001"
    path: str  # repo-relative posix path
    line: int  # 1-indexed
    message: str
    severity: str = ERROR
    # the stripped source line (or a stable label for trace-level findings):
    # baselines key on it so entries survive unrelated line drift
    context: str = ""

    def key(self) -> tuple:
        return (self.rule, self.path, self.context)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.severity}: " \
               f"{self.message}"


def to_json(findings: list) -> str:
    return json.dumps([f.to_dict() for f in findings], indent=2,
                      sort_keys=True)


def sort_findings(findings: list) -> list:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule, f.message))
