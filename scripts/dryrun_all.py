"""Every (arch × shape) cell of the dry-run on both production meshes,
cells in parallel processes.

    python3 scripts/dryrun_all.py [--workers 6] [--timeout 1500]
        [--out chiprun_out/dryrun_all.jsonl]

Runs ``python -m repro_torch.launch.dryrun --arch A --shape S
--both-meshes`` for each cell, ``--workers`` at a time (each its own
process: the fake world is one per process), each under ``--timeout``
seconds; a cell that fails or runs out of time is recorded with its
error. The records go to ``--out`` (JSON lines) and a table to standard
output. No card is needed (meta tensors), but a full-size cell traces the
whole model, so run it where memory and cores are plentiful. The figures
are dry-run predictions on the fake world with the H100 SXM constants of
``repro_torch/launch/dryrun.py``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cell(arch: str, shape: str, timeout: float, device_type: str) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as d:
        out = f"{d}/cell.jsonl"
        t = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--both-meshes", "--device-type",
                 device_type, "--out", out], env=env, cwd=ROOT,
                capture_output=True, text=True, timeout=timeout)
            err = proc.stderr[-2000:] if proc.returncode else ""
        except subprocess.TimeoutExpired:
            err = f"timeout after {timeout:.0f} s"
        recs = ([json.loads(line) for line in open(out)]
                if os.path.exists(out) else [])
    wall = time.perf_counter() - t
    done = {r["mesh"] for r in recs}
    for mesh in ("16x16", "2x16x16"):
        if mesh not in done:
            recs.append({"arch": arch, "shape": shape, "mesh": mesh,
                         "error": err or "no record"})
    for r in recs:
        r["cell_wall_s"] = wall
    return recs


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--timeout", type=float, default=1500)
    ap.add_argument("--device-type", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "dryrun_all.jsonl"))
    args = ap.parse_args(argv)
    cells = [(a, s) for a in configs.ARCHS for s in SHAPES]
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    recs = []
    with concurrent.futures.ThreadPoolExecutor(args.workers) as pool:
        futs = [pool.submit(_cell, a, s, args.timeout, args.device_type)
                for a, s in cells]
        for f in concurrent.futures.as_completed(futs):
            for r in f.result():
                recs.append(r)
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(r) + "\n")
                print(json.dumps({k: r.get(k) for k in (
                    "arch", "shape", "mesh", "flops_per_dev",
                    "bytes_per_dev", "peak_hbm_gib", "dominant", "skipped",
                    "error", "where")}), flush=True)
    failed = [r for r in recs if "error" in r]
    print(f"{len(recs)} records, {len(failed)} errors")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
