"""Scan orchestration: file collection, suppressions, baseline.

The reference's runner first collects every module's jit entries for
RC001; the port has no jit, so it lints each file on its own.
"""
from __future__ import annotations

import os

from repro_torch.analysis import astpass
from repro_torch.analysis.config import LintConfig
from repro_torch.analysis.findings import Finding, sort_findings
from repro_torch.analysis.suppressions import (
    Baseline, parse_suppressions, split_suppressed,
)


def collect_files(paths: list) -> list:
    files = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            files.extend(os.path.join(root, n) for n in sorted(names)
                         if n.endswith(".py"))
    return files


def _relpath(path: str) -> str:
    return os.path.relpath(path).replace(os.sep, "/")


def run_paths(paths: list, cfg: LintConfig | None = None,
              baseline: Baseline | None = None) -> dict:
    """Run level 1 (and level 2 when ``cfg.runtime``) over ``paths``.

    Returns ``{"active": [...], "suppressed": [...], "baselined": n,
    "runtime": {...}}`` — ``active`` is what should gate CI; ``runtime``
    holds level 2's report (host reads by function, the kernels' compiled
    resources), empty without level 2."""
    cfg = cfg or LintConfig()
    findings = []
    suppress_maps: dict = {}
    for f in collect_files(paths):
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        rel = _relpath(f)
        try:
            findings.extend(astpass.lint_source(f, src, cfg, relpath=rel))
        except SyntaxError as e:
            findings.append(Finding("XX000", rel, e.lineno or 1,
                                    f"syntax error: {e.msg}"))
        suppress_maps[rel] = parse_suppressions(src)

    report: dict = {}
    if cfg.runtime:
        from repro_torch.analysis import runtimepass
        found, report = runtimepass.run_runtime_checks(cfg)
        findings.extend(found)

    findings = sort_findings(findings)
    active, suppressed = split_suppressed(findings, suppress_maps)
    baselined = 0
    if baseline is not None:
        before = len(active)
        active = baseline.filter(active)
        baselined = before - len(active)
    return {"active": active, "suppressed": suppressed,
            "baselined": baselined, "runtime": report}
