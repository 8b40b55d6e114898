"""Recall at the paper's 200,000 rows of ``part``: the JAX package beside the
PyTorch port, on the same table and the same unseen queries.

    PYTHONPATH=src python3 crosscheck/recall_witness.py [--rows N]

The port runs on the CUDA card (``--device cpu`` rehearses at a small
``--rows``), the JAX package on whatever backend its installation finds
(the log names it); off a TPU it scores through its plain reference
path, its Pallas kernel being TPU-only. The data and
the queries are those of ``chip_smoke.py`` (``part`` seed 0, 128
conjunctive queries seed 3 + 128 DNF queries seed 4, recall target 0.9).
It reports, as mean recall@10 against each package's ``flat.ground_truth``:

  1. the JAX package's ``BatchedHybridExecutor`` under ``default_plan`` on
     its own IVF indexes (k-means, 32 clusters per column);
  2. the port's ``BatchedHybridExecutor`` under ``default_plan`` on those
     JAX indexes carried across (``convert.ivf_index``), with the number of
     queries whose ids differ from the JAX package's;
  3. the port under ``default_plan`` on its own indexes (as ``chip_smoke.py``
     builds them);
  4. the plan ceiling: per query, the best recall of any plan in
     ``rewriter.candidate_plans`` (the grid the learned planner's labels are
     drawn from) on the port's own indexes — no plan the planner can learn
     does better on that query;
  5. fixed graph plans (``chip_smoke.py``'s third pass: beam 8, 4 hops,
     k_i = 2k; and the grid's largest knobs: beam 16, 8 hops, k_i = 8k),
     each through the JAX package on its own degree-16 graphs, the port on
     those graphs carried across (``convert.graph_index``) and the port on
     its own graphs (``graph.build`` on the card), with the share of the
     port's graph edges that the JAX graph also holds.

Everything goes to ``chiprun_out/recall_witness.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

# a JAX on the card takes memory as it needs it, leaving the rest to torch
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402

from repro.bench import datasets as jds  # noqa: E402
from repro.bench import queries as jq  # noqa: E402
from repro.core.executor import PGVECTOR as J_PGVECTOR  # noqa: E402
from repro.core.executor import recall_at_k as j_recall  # noqa: E402
from repro.core.query import ExecutionPlan as JPlan  # noqa: E402
from repro.core.query import SubqueryParams as JSub  # noqa: E402
from repro.core.query import default_plan as j_default_plan  # noqa: E402
from repro.serve.batch import BatchedHybridExecutor as JBX  # noqa: E402
from repro.vectordb import flat as jflat  # noqa: E402
from repro.vectordb import graph as jgraph  # noqa: E402
from repro.vectordb import ivf as jivf  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.bench import datasets as tds  # noqa: E402
from repro_torch.bench import queries as tq  # noqa: E402
from repro_torch.core.executor import PGVECTOR, HybridExecutor  # noqa: E402
from repro_torch.core.executor import recall_at_k  # noqa: E402
from repro_torch.core.query import ExecutionPlan, SubqueryParams  # noqa: E402
from repro_torch.core.query import default_plan  # noqa: E402
from repro_torch.core.rewriter import candidate_plans  # noqa: E402
from repro_torch.serve.batch import BatchedHybridExecutor  # noqa: E402
from repro_torch.vectordb import flat as tflat  # noqa: E402
from repro_torch.vectordb import graph as tgraph  # noqa: E402
from repro_torch.vectordb import ivf as tivf  # noqa: E402
from repro_torch.vectordb.predicates import eval_mask  # noqa: E402

N_CLUSTERS = 32
GRAPH_DEGREE = 16  # BoomHQConfig's default
GRAPH_KNOBS = ((8, 4, 2), (16, 8, 8))  # (beam, hops, k_mult)
BATCH = 32
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def workload(qmod, table, n: int) -> list:
    return qmod.gen_workload(table, n // 2, n_vec_used=2, seed=3) + \
        qmod.gen_dnf_workload(table, n // 2, n_vec_used=2, seed=4)


def batched(run, queries: list) -> list:
    out = []
    for s in range(0, len(queries), BATCH):
        out.extend(run(queries[s:s + BATCH]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="the port's device (cpu: a small rehearsal)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("recall_witness: the port side needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev_name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    log(f"jax {jax.__version__} on {jax.default_backend()}; torch "
        f"{torch.__version__} on {dev_name}")

    jt = jds.make("part", rows=args.rows, seed=0)
    tt = tds.make("part", rows=args.rows, seed=0, device=dev)
    for a, b in zip(jt.vectors, tt.vectors):
        if not np.array_equal(np.asarray(a), b.cpu().numpy()):
            raise AssertionError("the two packages made different tables")
    jwl, twl = workload(jq, jt, args.queries), workload(tq, tt, args.queries)
    for qj, qt in zip(jwl, twl):
        if qj.weights != qt.weights or not all(
                np.array_equal(np.asarray(a), b.cpu().numpy())
                for a, b in zip(qj.query_vectors, qt.query_vectors)):
            raise AssertionError("the two packages made different queries")
    log(f"table {args.rows} rows and {len(twl)} queries, equal on both sides")

    sel = [float(eval_mask(q.predicates, tt.scalars).float().mean())
           for q in twl]
    j_gt = [np.asarray(jflat.ground_truth(jt, list(q.query_vectors),
                                          list(q.weights), q.predicates,
                                          q.k)[0]) for q in jwl]
    t_gt = [tflat.ground_truth(tt, list(q.query_vectors), list(q.weights),
                               q.predicates, q.k)[0].cpu().numpy()
            for q in twl]
    gt_same = sum(set(a.tolist()) == set(b.tolist())
                  for a, b in zip(j_gt, t_gt))
    log(f"ground truth: {gt_same}/{len(twl)} queries with equal id sets")

    # 1. the JAX package on its own indexes
    jidx = [jivf.build(v, N_CLUSTERS, seed=i, metric=jt.schema.metric)
            for i, v in enumerate(jt.vectors)]
    jbx = JBX(jt, jidx, J_PGVECTOR)
    t = time.perf_counter()
    j_res = batched(lambda qs: jbx.execute_batch(
        qs, [j_default_plan(q.n_vec, J_PGVECTOR) for q in qs]), jwl)
    j_rec = [j_recall(np.asarray(ids), g) for (ids, _), g in zip(j_res, j_gt)]
    log(f"1. JAX default_plan, JAX indexes: mean recall "
        f"{np.mean(j_rec):.4f} ({time.perf_counter() - t:.1f} s)")

    # 2. the port on the JAX indexes carried across
    cidx = [convert.ivf_index(np.asarray(x.centroids),
                              np.asarray(x.sorted_rows),
                              np.asarray(x.offsets), x.metric, device=dev)
            for x in jidx]
    cbx = BatchedHybridExecutor(tt, cidx, PGVECTOR)
    c_res = batched(lambda qs: cbx.execute_batch(
        qs, [default_plan(q.n_vec, PGVECTOR) for q in qs]), twl)
    c_rec = [recall_at_k(ids, g) for (ids, _), g in zip(c_res, t_gt)]
    c_diff = sum(set(np.asarray(a).tolist()) != set(np.asarray(b).tolist())
                 for (a, _), (b, _) in zip(c_res, j_res))
    log(f"2. port default_plan, JAX indexes carried across: mean recall "
        f"{np.mean(c_rec):.4f}; {c_diff} queries' ids differ from JAX's")

    # 3. the port on its own indexes
    oidx = [tivf.build(v, N_CLUSTERS, seed=i, metric=tt.schema.metric)
            for i, v in enumerate(tt.vectors)]
    obx = BatchedHybridExecutor(tt, oidx, PGVECTOR)
    o_res = batched(lambda qs: obx.execute_batch(
        qs, [default_plan(q.n_vec, PGVECTOR) for q in qs]), twl)
    o_rec = [recall_at_k(ids, g) for (ids, _), g in zip(o_res, t_gt)]
    log(f"3. port default_plan, port indexes: mean recall "
        f"{np.mean(o_rec):.4f}")

    # 4. the best plan of the labelling grid, query by query
    ex = HybridExecutor(tt, oidx, PGVECTOR)
    t = time.perf_counter()
    ceil, best = [], []
    for q, g in zip(twl, t_gt):
        recs = [(recall_at_k(ex.execute(q, p)[0], g), p.describe())
                for p in candidate_plans(q.n_vec, q.weights)]
        r, d = max(recs, key=lambda x: x[0])
        ceil.append(r)
        best.append(d)
    ceil = np.asarray(ceil)
    sel_np = np.asarray(sel)
    log(f"4. plan ceiling over the labelling grid, port indexes: mean "
        f"{ceil.mean():.4f}; {int((ceil >= 0.9).sum())}/{len(ceil)} queries "
        f"reach 0.9, {int((ceil >= 0.95).sum())} reach the labels' 0.95 "
        f"({time.perf_counter() - t:.1f} s)")
    strata = {}
    for lo, hi in ((0.0, 0.08), (0.08, 0.5), (0.5, 1.01)):
        m = (sel_np >= lo) & (sel_np < hi)
        strata[f"{lo}-{min(hi, 1.0)}"] = dict(
            n=int(m.sum()),
            ceiling=float(ceil[m].mean()) if m.any() else None,
            jax_default=float(np.mean(np.asarray(j_rec)[m])) if m.any()
            else None)
        log(f"   selectivity [{lo}, {min(hi, 1.0)}): {int(m.sum())} queries, "
            f"ceiling {strata[f'{lo}-{min(hi, 1.0)}']['ceiling']}, JAX "
            f"default_plan {strata[f'{lo}-{min(hi, 1.0)}']['jax_default']}")

    # 5. fixed graph plans: JAX graphs, JAX graphs carried across, port graphs
    t = time.perf_counter()
    with jax.default_matmul_precision("highest"):  # fp32, as the port
        jgr = [jgraph.build(v, GRAPH_DEGREE, metric=jt.schema.metric)
               for v in jt.vectors]
    j_build_s = time.perf_counter() - t
    t = time.perf_counter()
    tgr = [tgraph.build(v, GRAPH_DEGREE, metric=tt.schema.metric)
           for v in tt.vectors]
    t_build_s = time.perf_counter() - t
    overlap = []
    for jg, tg in zip(jgr, tgr):
        a, b = np.asarray(jg.neighbors), tg.neighbors.cpu().numpy()
        hit = ((b[:, :, None] == a[:, None, :]) & (b[:, :, None] >= 0)).any(-1)
        overlap.append(float(hit.sum() / max((b >= 0).sum(), 1)))
    log(f"5. graphs of degree {GRAPH_DEGREE}: JAX build {j_build_s:.1f} s, "
        f"port build {t_build_s:.1f} s; share of the port's edges the JAX "
        f"graph holds, by column: {[round(x, 4) for x in overlap]}")
    cgr = [convert.graph_index(np.asarray(g.neighbors),
                               np.asarray(g.entry_points), g.metric,
                               device=dev) for g in jgr]
    jgbx = JBX(jt, jidx, J_PGVECTOR, graphs=jgr)
    cgbx = BatchedHybridExecutor(tt, cidx, PGVECTOR, graphs=cgr)
    ogbx = BatchedHybridExecutor(tt, oidx, PGVECTOR, graphs=tgr)
    graph_rows = []
    for bw, nh, km in GRAPH_KNOBS:
        def plans(plan_cls, sub_cls, qs, bw=bw, nh=nh, km=km):
            return [plan_cls("graph", tuple(sub_cls(k_mult=km, iterative=False)
                                            for _ in range(q.n_vec)),
                             beam_width=bw, n_hops=nh) for q in qs]

        jg_res = batched(lambda qs: jgbx.execute_batch(
            qs, plans(JPlan, JSub, qs)), jwl)
        cg_res = batched(lambda qs: cgbx.execute_batch(
            qs, plans(ExecutionPlan, SubqueryParams, qs)), twl)
        og_res = batched(lambda qs: ogbx.execute_batch(
            qs, plans(ExecutionPlan, SubqueryParams, qs)), twl)
        row = dict(
            beam_width=bw, n_hops=nh, k_mult=km,
            jax_graphs_jax=float(np.mean([j_recall(np.asarray(ids), g)
                                          for (ids, _), g in zip(jg_res,
                                                                 j_gt)])),
            jax_graphs_port=float(np.mean([recall_at_k(ids, g) for (ids, _), g
                                           in zip(cg_res, t_gt)])),
            port_graphs_port=float(np.mean([recall_at_k(ids, g)
                                            for (ids, _), g in zip(og_res,
                                                                   t_gt)])),
            port_ids_differ_from_jax=sum(
                set(np.asarray(a).tolist()) != set(np.asarray(b).tolist())
                for (a, _), (b, _) in zip(cg_res, jg_res)))
        graph_rows.append(row)
        log(f"   graph plan beam {bw}, {nh} hops, k_i = {km}k: mean recall "
            f"JAX on JAX graphs {row['jax_graphs_jax']:.4f}, port on JAX "
            f"graphs {row['jax_graphs_port']:.4f} "
            f"({row['port_ids_differ_from_jax']} queries' ids differ), port "
            f"on port graphs {row['port_graphs_port']:.4f}")

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "recall_witness.json").write_text(json.dumps(dict(
        rows=args.rows, queries=len(twl), device=dev_name,
        jax=f"{jax.__version__} {jax.default_backend()}",
        gt_equal=gt_same, jax_default_recall=float(np.mean(j_rec)),
        port_default_recall_jax_indexes=float(np.mean(c_rec)),
        port_ids_differ_from_jax=c_diff,
        port_default_recall_own_indexes=float(np.mean(o_rec)),
        plan_ceiling=float(ceil.mean()),
        ceiling_reaches_0_9=int((ceil >= 0.9).sum()),
        ceiling_reaches_0_95=int((ceil >= 0.95).sum()),
        strata=strata,
        graph_build_s=dict(jax=j_build_s, port=t_build_s),
        graph_edge_overlap=overlap, graph_plans=graph_rows,
        per_query=[dict(selectivity=s, jax_default=float(a),
                        port_default_jax_idx=float(b),
                        port_default_own_idx=float(c), ceiling=float(d),
                        best_plan=e)
                   for s, a, b, c, d, e in zip(sel, j_rec, c_rec, o_rec,
                                               ceil, best)],
        seconds=time.perf_counter() - T0), indent=1))
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
