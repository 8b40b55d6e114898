"""BoomHQ dry-run: the distributed full-scan path of a multi-vector hybrid
query at production scale, on one rank of the production mesh.

Port of ``repro.launch.dryrun_boomhq``. DB: 2 vector columns × 768 dims,
4 scalar columns, ``rows_per_dev`` rows on each rank of the 16×16 mesh's
data axis (1,048,576 by default: 268M rows on 256 ranks). Variants:
  C0  f32 DB, one query per step      (paper-faithful baseline)
  C1  f32 DB, 64-query batch          (amortize the DB read over queries)
  C2  int8 DB + per-row scales, 64-q  (4× less memory per pass)

Each variant runs the port's ``vectordb.distributed.
sharded_masked_scan_batched`` as rank 0 of the fake world
(``launch/mesh.fake_world``) on meta tensors (shapes, no storage) and
counts its local operations with ``launch/dryrun.DeviceCounter``; the
per-query terms use the H100 SXM constants of ``launch/dryrun.py``. The
figures are dry-run predictions, not measurements. The port's exact int8
product runs in float64 (``int8_dot``), so C2's FLOPs and bytes count
that product as it is dispatched.

Usage: python -m repro_torch.launch.dryrun_boomhq [--rows-per-dev N]
       [--multi-pod] [--out f] [--device-type cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.launch.dryrun import (H100_HBM_BW, H100_LINK_BW,
                                       H100_PEAK_FLOPS, DeviceCounter)
from repro_torch.launch.mesh import (PRODUCTION, data_axes, fake_world,
                                     make_production_mesh)
from repro_torch.vectordb.distributed import sharded_masked_scan_batched
from repro_torch.vectordb.predicates import Predicates

VARIANTS = (("C0_f32_q1", dict(q_batch=1, int8=False)),
            ("C1_f32_q64", dict(q_batch=64, int8=False)),
            ("C2_int8_q64", dict(q_batch=64, int8=True)))


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def run_variant(name: str, *, q_batch: int, int8: bool, rows_per_dev: int,
                d: int = 768, n_vec: int = 2, m: int = 4, k: int = 10,
                multi_pod: bool = False, device_type: str = "cuda",
                verbose: bool = True) -> dict:
    n_dev = 1
    for s in PRODUCTION[multi_pod][0]:
        n_dev *= s
    t0 = time.perf_counter()
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
        daxes = data_axes(mesh)
        n_data = 1
        for a in daxes:
            n_data *= mesh.size(mesh.mesh_dim_names.index(a))
        n = rows_per_dev * n_data
        vt = torch.int8 if int8 else torch.float32
        vectors = tuple(_meta((rows_per_dev, d), vt) for _ in range(n_vec))
        scales = tuple(_meta((rows_per_dev,)) for _ in range(n_vec))
        scalars = _meta((rows_per_dev, m))
        qs = tuple(_meta((q_batch, d)) for _ in range(n_vec))
        w = _meta((q_batch, n_vec))
        preds = Predicates(active=_meta((q_batch, m), torch.bool),
                           lo=_meta((q_batch, m)), hi=_meta((q_batch, m)))
        fn = sharded_masked_scan_batched(mesh, daxes, k=k, n_vec=n_vec,
                                         int8=int8)
        counter = DeviceCounter()
        counter.hold([vectors, scales if int8 else [], scalars, qs, w,
                      preds.active, preds.lo, preds.hi])
        arg_bytes = counter.live
        with counter:
            fn(vectors, scales if int8 else None, scalars, preds, qs, w)
    rep = counter.report()
    dt = time.perf_counter() - t0
    flops_q = rep["flops"] / q_batch
    bytes_q = rep["bytes"] / q_batch
    coll_q = rep["collectives"]["total"] / q_batch
    model_flops_q = 2.0 * n * d * n_vec / n_data  # scoring flops a device
    rec = {
        "variant": name, "q_batch": q_batch, "int8": int8,
        "rows": n, "rows_per_dev": rows_per_dev, "n_dev": n_dev,
        "flops_per_dev_per_q": flops_q, "bytes_per_dev_per_q": bytes_q,
        "coll_bytes_per_dev_per_q": coll_q,
        "collectives": rep["collectives"],
        "compute_s": flops_q / H100_PEAK_FLOPS,
        "memory_s": bytes_q / H100_HBM_BW,
        "collective_s": coll_q / H100_LINK_BW,
        "useful_flop_ratio": model_flops_q / flops_q if flops_q else 0.0,
        "db_gib_per_dev": (rows_per_dev * d * n_vec * (1 if int8 else 4)
                           + rows_per_dev * m * 4) / 2**30,
        "arg_gib_per_dev": arg_bytes / 2**30,
        "peak_gib_per_dev": rep["peak_bytes"] / 2**30,
        "run_s": dt,
    }
    rec["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                          key=lambda t: rec[t])
    if verbose:
        print(f"[boomhq-scan {name}] per-query/dev: flops={flops_q:.3e} "
              f"bytes={bytes_q:.3e} coll={coll_q:.3e}B | "
              f"compute={rec['compute_s'] * 1e3:.3f}ms "
              f"memory={rec['memory_s'] * 1e3:.3f}ms "
              f"coll={rec['collective_s'] * 1e3:.4f}ms -> {rec['dominant']}"
              f" | db/dev={rec['db_gib_per_dev']:.2f}GiB peak/dev="
              f"{rec['peak_gib_per_dev']:.2f}GiB ({dt:.1f}s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-dev", type=int, default=1_048_576)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device-type", default="cuda",
                    help="the fake mesh's device type")
    args = ap.parse_args(argv)
    recs = [run_variant(name, rows_per_dev=args.rows_per_dev,
                        multi_pod=args.multi_pod,
                        device_type=args.device_type, **kw)
            for name, kw in VARIANTS]
    if args.out:
        with open(args.out, "a") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
