"""Inline suppressions and the checked-in baseline.

Inline syntax (same line as the finding, or a standalone comment on the
line(s) above it)::

    x = int(n_qual)  # boomlint: ignore[HS001] one sync per round is the contract

    # boomlint: ignore[HS001,RC001] reason may span
    # further plain comment lines
    x = int(n_qual)

A standalone suppression comment applies to the next non-comment,
non-blank line. The baseline is a JSON file of finding keys
(rule, path, stripped source line) so entries survive unrelated line
drift; matched entries are consumed (multiset semantics).

The port's copy of ``repro.analysis.suppressions``: the syntax and the
baseline's JSON are the same, so a baseline written by one package reads
back in the other. The port's entries may also carry a ``reason`` (what
the finding reads and why it is parked); it is not part of the key, the
reference ignores it, and ``save`` writes back the reasons it was given.
"""
from __future__ import annotations

import json
import re

SUPPRESS_RE = re.compile(
    r"#\s*boomlint:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*(.*)")


def parse_suppressions(source: str) -> dict:
    """-> {line_number: set(rule_ids)} of suppressed lines (1-indexed)."""
    out: dict = {}
    lines = source.splitlines()
    for i, line in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        if line.strip().startswith("#"):
            # standalone comment: also covers the next code line
            j = i
            while j < len(lines) and (not lines[j].strip()
                                      or lines[j].strip().startswith("#")):
                j += 1
            if j < len(lines):
                out.setdefault(j + 1, set()).update(rules)
    return out


def split_suppressed(findings: list, suppressions_by_path: dict) -> tuple:
    """-> (active, suppressed) given {path: {line: rules}} maps."""
    active, suppressed = [], []
    for f in findings:
        rules = suppressions_by_path.get(f.path, {}).get(f.line, set())
        (suppressed if f.rule in rules else active).append(f)
    return active, suppressed


class Baseline:
    def __init__(self, entries: list | None = None,
                 reasons: dict | None = None):
        self.entries = list(entries or [])
        self.reasons = dict(reasons or {})  # key -> reason

    @classmethod
    def load(cls, path) -> "Baseline":
        with open(path) as fh:
            data = json.load(fh)
        entries = [(e["rule"], e["path"], e.get("context", ""))
                   for e in data.get("entries", [])]
        reasons = {k: e["reason"] for k, e in
                   zip(entries, data.get("entries", [])) if e.get("reason")}
        return cls(entries, reasons)

    @classmethod
    def from_findings(cls, findings: list,
                      reasons: dict | None = None) -> "Baseline":
        keys = [f.key() for f in findings]
        return cls(keys, {k: r for k, r in (reasons or {}).items()
                          if k in keys})

    def save(self, path) -> None:
        entries = []
        for key in sorted(self.entries):
            e = dict(zip(("rule", "path", "context"), key))
            if key in self.reasons:
                e["reason"] = self.reasons[key]
            entries.append(e)
        with open(path, "w") as fh:
            json.dump({"version": 1, "entries": entries}, fh, indent=2,
                      sort_keys=True)
            fh.write("\n")

    def filter(self, findings: list) -> list:
        """Drop findings matching a baseline entry (each entry consumes at
        most one finding)."""
        budget: dict = {}
        for key in self.entries:
            budget[key] = budget.get(key, 0) + 1
        out = []
        for f in findings:
            k = f.key()
            if budget.get(k, 0) > 0:
                budget[k] -= 1
            else:
                out.append(f)
        return out

