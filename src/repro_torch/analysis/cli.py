"""boomlint CLI for the port.

    PYTHONPATH=src python -m repro_torch.analysis.cli src/repro_torch \\
        --baseline boomlint_torch.baseline.json [--no-runtime] \\
        [--ptxas-logs DIR] [--json]

Exit code 0 iff no unsuppressed, unbaselined findings. Level 2 (CM001 and
PL001's compiled resources) runs unless ``--no-runtime``; it reads the
``nvcc -Xptxas -v`` reports from ``--ptxas-logs DIR`` or from beside the
built libraries, and a missing report is a finding. ``--json`` emits
``{"findings": [...], "host_reads": {function: n}, "runtime": {...}}`` on
stdout (each finding as ``findings.to_json`` writes it; ``runtime`` is
level 2's report: host-read sites and collectives by function, the
kernels' compiled resources); ``--write-baseline`` snapshots the current
findings so pre-existing debt can be ratcheted down without blocking CI,
keeping the ``reason`` of every entry of ``--baseline`` that is still
found.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.config import LintConfig
from repro_torch.analysis.findings import to_json
from repro_torch.analysis.runner import run_paths
from repro_torch.analysis.suppressions import Baseline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="boomlint",
        description="host-sync, epoch/cache and kernel-resource lint for "
                    "the port's serving stack (AST + runtime)")
    p.add_argument("paths", nargs="+", help="files or directories to scan")
    p.add_argument("--json", action="store_true",
                   help="emit findings as JSON on stdout")
    p.add_argument("--baseline", default=None,
                   help="baseline file of accepted findings (JSON)")
    p.add_argument("--write-baseline", default=None, metavar="PATH",
                   help="write current active findings to PATH and exit 0")
    p.add_argument("--no-runtime", action="store_true",
                   help="skip level 2 (the serving functions' host reads "
                        "and collectives, the kernels' ptxas reports)")
    p.add_argument("--ptxas-logs", default=None, metavar="DIR",
                   help="directory of nvcc -Xptxas -v reports "
                        "(<source>.log or lib<source>-*.log; default: "
                        "beside the built libraries)")
    return p


def main(argv: list | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = LintConfig(runtime=not args.no_runtime,
                     ptxas_logs=args.ptxas_logs)
    baseline = Baseline.load(args.baseline) if args.baseline else None

    result = run_paths(args.paths, cfg,
                       baseline=None if args.write_baseline else baseline)
    active = result["active"]

    if args.write_baseline:
        Baseline.from_findings(
            active, baseline.reasons if baseline else None).save(
                args.write_baseline)
        print(f"boomlint: wrote {len(active)} finding(s) to "
              f"{args.write_baseline}")
        return 0

    if args.json:
        runtime = result["runtime"]
        print(json.dumps({
            "findings": json.loads(to_json(active)),
            "host_reads": {label: r["host_reads"] for label, r in
                           runtime.get("functions", {}).items()},
            "runtime": runtime}, indent=2, sort_keys=True))
    else:
        for f in active:
            print(f.render())
        tail = []
        if result["suppressed"]:
            tail.append(f"{len(result['suppressed'])} suppressed")
        if result["baselined"]:
            tail.append(f"{result['baselined']} baselined")
        status = f"boomlint: {len(active)} finding(s)"
        if tail:
            status += " (" + ", ".join(tail) + ")"
        print(status, file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(main())
