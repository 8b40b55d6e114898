"""The dry-run's witness cells (``launch.dryrun.WITNESS_CELLS``: the
smallest smoke cells that gave each error torch 2.11's DTensor raised in
the production cells) on torch's fake process group, on this checkout or
on another tree's step code.

    python3 scripts/dryrun_witness.py [--tree DIR] [--device-type cuda]
        [--out chiprun_out/dryrun_witness.jsonl]

The cells are this checkout's; ``--tree`` runs them through
``DIR/src``'s ``repro_torch.launch.dryrun.run_cell`` and the code under
it (an older commit unpacked with ``git archive``, to show which cells
it fails). Each record is the cell's, or its error and the port's frames
in the traceback (``where``). It writes one JSON line a cell to
``--out`` and a line a cell to standard output, and exits 0 whatever
the cells give. No card is needed; ``--device-type`` names the fake
mesh's (``cpu`` where torch has no CUDA).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--device-type", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "dryrun_witness.jsonl"))
    args = ap.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.launch import dryrun as tree_dryrun

    # this checkout's cells, run by the tree's step code
    spec = importlib.util.spec_from_file_location(
        "witness_cells", ROOT / "src" / "repro_torch" / "launch" /
        "dryrun.py")
    cells = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cells)
    cells.run_cell = tree_dryrun.run_cell
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    n_err = 0
    for cell in cells.WITNESS_CELLS:
        head = {"witness": cells.witness_id(cell), "tree": str(tree),
                "refused_before": cell["refused"]}
        t = time.perf_counter()
        try:
            rec = dict(head, **cells.run_witness(
                cell, device_type=args.device_type, verbose=False))
        except Exception as e:  # noqa: BLE001 — recorded, the run goes on
            n_err += 1
            rec = dict(head, error=f"{type(e).__name__}: {e}",
                       where=cells._where(e))
        rec["seconds"] = time.perf_counter() - t
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec.get(k) for k in (
            "witness", "seconds", "flops_per_dev", "peak_hbm_gib",
            "dominant", "error")})[:400], flush=True)
    print(f"{len(cells.WITNESS_CELLS)} witness cells on {tree}: "
          f"{n_err} errors")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
