"""Recall after data updates: the JAX package beside the PyTorch port, on the
same fitted state, the same inserted rows and the same unseen queries.

    PYTHONPATH=src python3 scripts/update_witness.py [--rows N]

The port fits BoomHQ on the card exactly as ``chip_smoke.py`` phase 4 does
(``part`` seed 0 at 200,000 rows, its ``smoke_config`` with the graph tier
and its ``smoke_workloads``); its fitted state — IVF indexes, histograms, graphs, data
encoder, query-encoder edges and rewriter — is exported through numpy into
a JAX ``BoomHQ`` on the same table. Then both packages take
``chip_smoke.py``'s two skewed inserts (+10% and +40% of the rows, the
copy of ``benchmarks/data_updates._skewed_insert``) through
``BoomHQ.insert(finetune=True)``. Before and after each insert it reports,
per package, the mean recall@10 against that package's
``flat.ground_truth`` of ``execute_batch`` (learned plans, batches of 32)
and of ``default_plan`` through the batched executor, the share of
queries whose learned plans agree across the packages, and the share
whose ids agree. ``--device cpu`` rehearses at a small ``--rows``.

The check it exits non-zero on: at every stage the port's gap between
learned and ``default_plan`` recall lies within ``GAP_SPREAD`` (0.02) of
the JAX package's on the same state — the post-insert floor restated as
a claim the reference itself meets.

Everything goes to ``chiprun_out/update_witness.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

# a JAX on the card takes memory as it needs it, leaving the rest to torch
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAP_SPREAD = 0.02  # |port gap - JAX gap| allowed at every stage
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.boomhq import BoomHQ as JBoomHQ  # noqa: E402
from repro.core.boomhq import BoomHQConfig as JConfig  # noqa: E402
from repro.core.data_encoder import DataEncoderConfig as JDEC  # noqa: E402
from repro.core.executor import HybridExecutor as JHybridExecutor  # noqa: E402
from repro.core.executor import recall_at_k as j_recall  # noqa: E402
from repro.core.query import MHQ as JMHQ  # noqa: E402
from repro.core.query import default_plan as j_default_plan  # noqa: E402
from repro.core.query_encoder import QueryEncoder as JQueryEncoder  # noqa: E402
from repro.core.rewriter import MHQRewriter as JRewriter  # noqa: E402
from repro.core.rewriter import RewriterConfig as JRC  # noqa: E402
from repro.serve.batch import BatchedHybridExecutor as JBX  # noqa: E402
from repro.vectordb import flat as jflat  # noqa: E402
from repro.vectordb import predicates as jpred  # noqa: E402
from repro.vectordb.graph import GraphIndex as JGraphIndex  # noqa: E402
from repro.vectordb.histogram import Histograms as JHistograms  # noqa: E402
from repro.vectordb.ivf import IVFIndex as JIVFIndex  # noqa: E402
from repro.vectordb.table import ScalarCol as JScalarCol  # noqa: E402
from repro.vectordb.table import Table as JTable  # noqa: E402
from repro.vectordb.table import TableSchema as JSchema  # noqa: E402
from repro.vectordb.table import VectorCol as JVectorCol  # noqa: E402

from repro_torch.bench import datasets as tds  # noqa: E402
from repro_torch.core.boomhq import BoomHQ  # noqa: E402
from repro_torch.core.executor import recall_at_k  # noqa: E402
from repro_torch.core.query import default_plan  # noqa: E402
from repro_torch.serve.batch import BatchedHybridExecutor  # noqa: E402
from repro_torch.vectordb import flat as tflat  # noqa: E402
from repro_torch.vectordb.predicates import Predicates, PredicateSet  # noqa: E402

BATCH = 32


def _smoke():
    """``chip_smoke.py`` as a module: its configuration, workloads and
    insert copy."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(t0, msg):
    print(f"[{time.perf_counter() - t0:7.1f}s] {msg}", flush=True)


def _np(x):
    return x.detach().cpu().numpy()


def _mlp(m) -> dict:
    out = {}
    for i, layer in enumerate(m.layers):
        p = {"w": jnp.asarray(_np(layer.w))}
        if layer.b is not None:
            p["b"] = jnp.asarray(_np(layer.b))
        out[f"l{i}"] = p
    return out


def jax_table(t) -> JTable:
    s = t.schema
    schema = JSchema(tuple(JVectorCol(c.name, c.dim) for c in s.vector_cols),
                     tuple(JScalarCol(c.name, c.kind, c.n_categories)
                           for c in s.scalar_cols), metric=s.metric)
    return JTable.from_numpy(schema, [_np(v) for v in t.vectors],
                             _np(t.scalars))


def jax_boomhq(bq, jcfg: JConfig) -> JBoomHQ:
    """A fitted JAX ``BoomHQ`` holding the port instance's state."""
    jt = jax_table(bq.table)
    jbq = JBoomHQ(jt, jcfg)  # builds throwaway indexes, replaced below
    jbq.indexes = [JIVFIndex(jnp.asarray(_np(i.centroids)),
                             jnp.asarray(_np(i.sorted_rows)),
                             jnp.asarray(_np(i.offsets)), i.metric)
                   for i in bq.indexes]
    jbq.hists = JHistograms(jnp.asarray(_np(bq.hists.edges)),
                            jnp.asarray(_np(bq.hists.prefix)),
                            jnp.asarray(_np(bq.hists.n_rows)))
    jbq.graphs = None if bq.graphs is None else tuple(
        JGraphIndex(jnp.asarray(_np(g.neighbors)),
                    jnp.asarray(_np(g.entry_points)), g.metric)
        for g in bq.graphs)
    jbq.executor = JHybridExecutor(jt, jbq.indexes, jbq.engine,
                                   graphs=jbq.graphs)
    de = bq.data_encoder
    jbq.data_encoder.params = {
        "frozen": [{k: jnp.asarray(_np(getattr(f, k)))
                    for k in ("w0", "b0", "w1", "b1")} for f in de.frozen],
        "trainable": [_mlp(m) for m in de.trainable],
        "ae_enc": _mlp(de.ae_enc), "ae_dec": _mlp(de.ae_dec)}
    jbq.data_encoder.edges = jnp.asarray(_np(de.edges))
    jbq.qenc = JQueryEncoder(jt, jbq.indexes, jbq.hists, jbq.data_encoder)
    jbq.qenc._edges = jnp.asarray(_np(bq.qenc._edges))
    rw = bq.rewriter
    jbq.rewriter = JRewriter(rw.in_dim, rw.n_vec, jcfg.rewriter)
    jbq.rewriter.params = {name: _mlp(getattr(rw, name)) for name in
                           ("trunk", "strategy", "per_col", "precision",
                            "graph")}
    jbq._fitted = True
    return jbq


def jax_query(q, m: int) -> JMHQ:
    p = q.predicates
    if isinstance(p, Predicates):
        jp = jpred.Predicates(active=jnp.asarray(_np(p.active)),
                              lo=jnp.asarray(_np(p.lo)),
                              hi=jnp.asarray(_np(p.hi)))
    elif isinstance(p, PredicateSet):
        jp = jpred.PredicateSet(active=jnp.asarray(_np(p.active)),
                                lo=jnp.asarray(_np(p.lo)),
                                hi=jnp.asarray(_np(p.hi)),
                                clause_valid=jnp.asarray(_np(p.clause_valid)))
    else:
        raise TypeError(type(p))
    return JMHQ(query_vectors=tuple(jnp.asarray(_np(v))
                                    for v in q.query_vectors),
                weights=tuple(float(w) for w in q.weights), predicates=jp,
                k=q.k, recall_target=q.recall_target)


def measure(bq, jbq, queries, jqueries) -> dict:
    """Learned and default-plan recall in both packages, plan and id
    agreement."""
    gt = [_np(tflat.ground_truth(bq.table, list(q.query_vectors),
                                 list(q.weights), q.predicates, q.k)[0])
          for q in queries]
    jgt = [np.asarray(jflat.ground_truth(jbq.table, list(q.query_vectors),
                                         list(q.weights), q.predicates,
                                         q.k)[0]) for q in jqueries]
    got, want, same_plan, mix = [], [], 0, {}
    for s in range(0, len(queries), BATCH):
        tq_, jq_ = queries[s: s + BATCH], jqueries[s: s + BATCH]
        plans = bq.optimize_batch(tq_)
        for p in plans:
            st = bq.executor.legalize(p).strategy
            mix[st] = mix.get(st, 0) + 1
        pt = [p.describe() for p in plans]
        pj = [p.describe() for p in jbq.optimize_batch(jq_)]
        same_plan += sum(a == b for a, b in zip(pt, pj))
        got.extend(bq.execute_batch(tq_))
        want.extend(jbq.execute_batch(jq_))
    robust = BatchedHybridExecutor(bq.table, bq.indexes, bq.engine,
                                   graphs=bq.graphs).execute_batch(
        queries, [default_plan(q.n_vec, bq.engine) for q in queries])
    jrobust = JBX(jbq.table, jbq.indexes, jbq.engine,
                  graphs=jbq.graphs).execute_batch(
        jqueries, [j_default_plan(q.n_vec, jbq.engine) for q in jqueries])
    out = dict(
        rows=bq.table.n_rows,
        port_learned=float(np.mean([recall_at_k(i, g)
                                    for (i, _), g in zip(got, gt)])),
        port_default_plan=float(np.mean([recall_at_k(i, g) for (i, _), g
                                         in zip(robust, gt)])),
        jax_learned=float(np.mean([j_recall(np.asarray(i), g)
                                   for (i, _), g in zip(want, jgt)])),
        jax_default_plan=float(np.mean([j_recall(np.asarray(i), g)
                                        for (i, _), g in zip(jrobust, jgt)])),
        port_plan_mix=mix, same_plans=same_plan / len(queries),
        same_ids=float(np.mean([np.array_equal(np.asarray(a[0]),
                                               np.asarray(b[0]))
                                for a, b in zip(got, want)])),
        same_ground_truth=float(np.mean([np.array_equal(a, b)
                                         for a, b in zip(gt, jgt)])))
    out["port_gap"] = out["port_learned"] - out["port_default_plan"]
    out["jax_gap"] = out["jax_learned"] - out["jax_default_plan"]
    out["gap_within_spread"] = bool(
        abs(out["port_gap"] - out["jax_gap"]) <= GAP_SPREAD)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queries", type=int, default=None)
    args = ap.parse_args()
    smoke = _smoke()
    rows = args.rows or smoke.ROWS
    n_serve = args.queries or smoke.N_SERVE
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("update_witness: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
            .splitlines()[0] if dev.type == "cuda" else "cpu")
    log(t0, f"jax {jax.__version__} on {jax.devices()[0].platform}; "
        f"torch {torch.__version__} on {dev} ({card})")
    table = tds.make("part", rows=rows, seed=0, device=dev)
    fit_wl, queries = smoke.smoke_workloads(table, n_serve)
    cfg = smoke.smoke_config()
    bq = BoomHQ(table, cfg)
    bq.fit(fit_wl)
    log(t0, "port fitted")
    # the same configuration; the port's graphs are carried in
    jbq = jax_boomhq(bq, JConfig(
        n_clusters=cfg.n_clusters, graph_degree=0,
        encoder=JDEC(**dataclasses.asdict(cfg.encoder)),
        rewriter=JRC(**dataclasses.asdict(cfg.rewriter))))
    m = table.schema.n_scalar
    jqueries = [jax_query(q, m) for q in queries]
    log(t0, "state carried into the JAX package")
    stages = [dict(stage="before", **measure(bq, jbq, queries, jqueries))]
    log(t0, json.dumps(stages[-1]))
    inserted = 0
    for ratio in smoke.UPDATE_RATIOS:
        add = int(rows * ratio) - inserted
        vecs, scal = smoke.skewed_insert(bq.table, add, smoke.UPDATE_SEED
                                         + int(ratio * 1e4))
        t = time.perf_counter()
        bq.insert(vecs, scal, finetune=True)
        t_port = time.perf_counter() - t
        t = time.perf_counter()
        jbq.insert(vecs, scal, finetune=True)
        t_jax = time.perf_counter() - t
        inserted += add
        stages.append(dict(stage=f"+{add}", port_insert_s=t_port,
                           jax_insert_s=t_jax,
                           **measure(bq, jbq, queries, jqueries)))
        log(t0, json.dumps(stages[-1]))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "update_witness.json").write_text(json.dumps(dict(
        rows=rows, queries=len(queries), device=card,
        jax_platform=jax.devices()[0].platform,
        stages=stages, seconds=time.perf_counter() - t0), indent=1))
    bad = [st["stage"] for st in stages if not st["gap_within_spread"]]
    if bad:
        log(t0, f"the port's gap to default_plan is more than {GAP_SPREAD} "
            f"from the JAX package's at {bad}")
        return 1
    log(t0, "done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
