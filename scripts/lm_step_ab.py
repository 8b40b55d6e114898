"""The bf16 generation timings of ``chip_smoke.py`` (phase 13 (c),
``stablelm-1.6b``; phase 14 (c), ``mamba2-370m`` and ``zamba2-2.7b``:
prefill and decode-step times, kernels, peak memory) on two source trees
of the repository, alternated in one call to the card.

    python3 scripts/lm_step_ab.py OTHER_TREE

``OTHER_TREE`` is a checkout of another commit (e.g. unpacked with
``git archive``). Each run is a fresh Python process importing that tree's
``chip_smoke`` and ``repro_torch`` and timing the three models one after
the other; the trees run in the order other, this, this, other, twice.
Prints one JSON line a run, then each tree's median over its runs of every
number, and writes both to ``chiprun_out/lm_step_ab.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROUNDS = 2  # other, this, this, other; twice: four runs of each tree
KEYS = ("prefill_ms", "prefill_device_ms", "decode_step_ms_median",
        "decode_step_ms_min", "decode_step_ms_max", "decode_step_device_ms",
        "decode_step_idle_share", "peak_memory_bytes", "prefill_bound_ms",
        "decode_bound_ms")
ONE_RUN = """
import json, sys
import torch
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
res = {}
for name, fn in (("stablelm-1.6b", lambda: c.lm_generate_timed(dev)),
                 ("mamba2-370m", lambda: c.ssm_generate_timed("mamba2-370m",
                                                              dev)),
                 ("zamba2-2.7b", lambda: c.ssm_generate_timed("zamba2-2.7b",
                                                              dev))):
    out = fn()
    r = {k: out[k] for k in json.loads(sys.argv[2])}
    for step in ("decode_step", "prefill"):
        r[step + "_kernels"] = out["profiles"][step]["launches"]
    res[name] = r
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(res))
"""


def run(tree: pathlib.Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", ONE_RUN, str(tree),
                           json.dumps(KEYS)], capture_output=True, text=True,
                          timeout=900)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    if proc.returncode or not lines:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    return json.loads(lines[0][len("RESULT "):])


def medians(runs: list) -> dict:
    """{tree: {model: {number: median over that tree's runs}}}."""
    out = {}
    for label in ("other", "this"):
        mine = [r for r in runs if r["tree"] == label]
        out[label] = {m: {k: float(np.median([r[m][k] for r in mine]))
                          for k in mine[0][m]}
                      for m in mine[0] if m != "tree"}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=pathlib.Path)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for _ in range(ROUNDS):
        for label, tree in (("other", args.other.resolve()), ("this", ROOT),
                            ("this", ROOT), ("other", args.other.resolve())):
            r = dict(tree=label, **run(tree))
            print(json.dumps(r), flush=True)
            runs.append(r)
    summary = medians(runs)
    print(json.dumps(dict(medians=summary)), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "lm_step_ab.json").write_text(json.dumps(
        dict(device=smi, runs=runs, medians=summary), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
