"""BoomHQ façade: the learned optimizer wired end-to-end (paper Fig. 2).

Port of ``repro.core.boomhq`` for an unsharded, untiered table:

  fit():            train the data encoder, label the training workload
                    by grid execution, train the rewriter heads (the
                    constructor builds the per-column IVF indexes,
                    histograms and, with ``graph_degree > 0``, proximity
                    graphs).
  optimize():       query encoder -> X_in -> predicted ExecutionPlan.
  optimize_batch(): the same for a whole batch in one batched pass and one
                    host sync.
  execute() / execute_batch(): optimize + run, with one underfill
                    escalation to the robust default plan.
  insert():         the eager data-update path: append the rows, extend
                    the indexes, histograms and graphs, rebuild the
                    executors and fine-tune the data encoder.

Shards, tiers, tenants and the semantic cache are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.data_encoder import DataEncoder, DataEncoderConfig
from repro_torch.core.executor import EngineCaps, HybridExecutor, PGVECTOR
from repro_torch.core.query import ExecutionPlan, MHQ, default_plan
from repro_torch.core.query_encoder import QueryEncoder
from repro_torch.core.rewriter import MHQRewriter, RewriterConfig, generate_label
from repro_torch.vectordb import flat, graph, histogram, ivf, predicates
from repro_torch.vectordb.table import Table


def _n_valid(ids) -> int:
    if isinstance(ids, torch.Tensor):
        return int((ids >= 0).sum())
    return int(np.sum(np.asarray(ids) >= 0))


@dataclasses.dataclass(frozen=True)
class BoomHQConfig:
    n_clusters: int = 64
    hist_bins: int = 64
    # out-degree of the per-column proximity graphs (the "graph" strategy,
    # vectordb.graph); 0 disables the tier (plans legalize graph ->
    # index_scan)
    graph_degree: int = 16
    encoder: DataEncoderConfig = dataclasses.field(
        default_factory=DataEncoderConfig)
    rewriter: RewriterConfig = dataclasses.field(default_factory=RewriterConfig)
    # ablations (§5.5)
    use_de: bool = True
    use_stats: bool = True
    use_gse: bool = True
    use_lnp: bool = True


class BoomHQ:
    """Runs on the device of ``table`` (``Table.from_numpy`` and
    ``datasets.make`` put it on the CUDA device by default).

    ``indexes`` / ``hists`` / ``graphs``: already-built IVF indexes,
    histograms and per-column graphs to bind instead of building them
    (``convert`` carries the JAX package's across this way)."""

    def __init__(self, table: Table, cfg: BoomHQConfig = BoomHQConfig(),
                 engine: EngineCaps = PGVECTOR, *, indexes=None, hists=None,
                 graphs=None):
        self.table = table
        self.cfg = cfg
        self.engine = engine
        self.indexes = list(indexes) if indexes is not None else [
            ivf.build(v, min(cfg.n_clusters, max(2, table.n_rows // 8)),
                      seed=i, metric=table.schema.metric)
            for i, v in enumerate(table.vectors)]
        self.hists = hists if hists is not None else histogram.build(
            table.scalars, cfg.hist_bins)
        self.graphs = None
        if graphs is not None:
            self.graphs = tuple(graphs)
        elif cfg.graph_degree:
            self.graphs = tuple(
                graph.build(v, cfg.graph_degree, metric=table.schema.metric)
                for v in table.vectors)
        self.executor = HybridExecutor(table, self.indexes, engine,
                                       graphs=self.graphs)
        self.data_encoder: Optional[DataEncoder] = None
        if cfg.use_de:
            self.data_encoder = DataEncoder(
                [v.shape[1] for v in table.vectors], table.schema.n_scalar,
                cfg.encoder, device=table.device)
        self.qenc: Optional[QueryEncoder] = None
        self.rewriter: Optional[MHQRewriter] = None
        self._fitted = False
        self.cost_model = None  # scoring-dispatch override (bind_cost_model)
        self._batched = None
        self.insert_seconds: dict = {}  # the last insert's seconds by step

    # -- offline -------------------------------------------------------------

    def fit(self, workload: list, *, verbose: bool = False) -> dict:
        metrics = {}
        t0 = time.perf_counter()
        if self.data_encoder is not None:
            metrics.update(self.data_encoder.fit(self.table))
        self.qenc = QueryEncoder(self.table, self.indexes, self.hists,
                                 self.data_encoder)
        feats, labels = [], []
        for qi, q in enumerate(workload):
            gt_ids, _ = flat.ground_truth(
                self.table, list(q.query_vectors), list(q.weights),
                q.predicates, q.k)
            feats.append(self._features_batch([q])[0].cpu().numpy())
            labels.append(generate_label(
                self.executor, q, gt_ids.cpu().numpy(),
                refine_columns=self.cfg.rewriter.refine_columns))
            if verbose and (qi + 1) % 50 == 0:
                print(f"  labeled {qi + 1}/{len(workload)} queries")
        X = np.stack(feats)
        self.rewriter = MHQRewriter(X.shape[1], workload[0].n_vec,
                                    self.cfg.rewriter,
                                    device=self.table.device)
        metrics.update(self.rewriter.fit(X, labels))
        metrics["fit_seconds"] = time.perf_counter() - t0
        self._fitted = True
        return metrics

    def _features_batch(self, qs: list, *,
                        scores_b: Optional[tuple] = None) -> torch.Tensor:
        """X_in for a query batch (B_bucket, F) — the port's counterpart of
        the fused feature jit: features of every query in one batched pass.
        The batch pads to a power-of-two bucket by repeating the first
        query, so it lines up with ``compute_batch_scores`` rows."""
        from repro_torch.serve.batch import next_bucket

        t = self.table
        dev = t.device
        qpad = list(qs) + [qs[0]] * (next_bucket(len(qs)) - len(qs))
        pred_b = predicates.stack([q.predicates for q in qpad])
        qv_b = tuple(torch.stack([q.query_vectors[i] for q in qpad])
                     for i in range(t.schema.n_vec))
        cfg = self.cfg
        return self.qenc.encode_batch(
            qv_b, pred_b,
            torch.as_tensor(np.asarray([q.weights for q in qpad], np.float32),
                            device=dev),
            torch.as_tensor([float(np.log(q.k)) for q in qpad],
                            dtype=torch.float32, device=dev),
            torch.as_tensor([q.recall_target for q in qpad],
                            dtype=torch.float32, device=dev),
            row_scores=scores_b,
            use_de=cfg.use_de and self.data_encoder is not None,
            use_stats=cfg.use_stats, use_gse=cfg.use_gse,
            use_lnp=cfg.use_lnp)

    # -- online ----------------------------------------------------------------

    SINGLE_INDEX_MIN_SKEW = 0.85  # paper: single-index only for skewed weights

    def optimize(self, q: MHQ) -> ExecutionPlan:
        """One batched feature + head pass and one host sync per query."""
        if not self._fitted:
            return default_plan(q.n_vec, self.engine)
        codes = self.rewriter.plan_codes(self._features_batch([q]))
        return self._apply_skew_guard(
            self.rewriter.plan_from_codes(codes[0].cpu().numpy()), q)

    def _apply_skew_guard(self, plan: ExecutionPlan, q: MHQ) -> ExecutionPlan:
        if plan.strategy == "single_index":
            if float(np.max(q.weights)) >= self.SINGLE_INDEX_MIN_SKEW:
                plan = dataclasses.replace(
                    plan, dominant=int(np.argmax(q.weights)))
            else:  # not skewed enough — fall back to per-column scans
                plan = dataclasses.replace(plan, strategy="index_scan")
        return plan

    def _plan_local(self, b: int) -> bool:
        """Should batch planning skip the dense score GEMMs? The pre-probe
        budget is weighed against the table by the same cost model that
        dispatches execution groups."""
        from repro_torch.serve.batch import CANDIDATE_LOCAL, CostModel, \
            next_bucket
        cm = self.cost_model if self.cost_model is not None else CostModel()
        n = self.table.n_rows
        scan = 0
        for idx in self.indexes:
            if self.qenc is not None:
                scan += ivf.probe_scan_budget(
                    idx.n_clusters, n, nprobe=self.qenc.probe_nprobe,
                    probe_k=self.qenc.probe_k)
            else:
                scan += min(n, self.engine.default_max_scan)
        return cm.choose(batch=next_bucket(max(1, b)), scan=max(1, scan),
                         n_rows=n * max(1, len(self.indexes))) \
            == CANDIDATE_LOCAL

    def optimize_batch(self, qs: list, *, scores_b: Optional[tuple] = None,
                       dense: Optional[bool] = None) -> list:
        """Plan a whole batch with one batched feature + head pass and ONE
        host sync. ``scores_b`` — per-column (B_bucket, n) similarities from
        ``compute_batch_scores`` — feeds the pre-probe features; ``dense``
        None auto-picks: past the dense crossover (and with no matrices
        passed in) planning runs the unscored pre-probe instead."""
        if not qs:
            return []
        if not self._fitted:
            return [default_plan(q.n_vec, self.engine) for q in qs]
        if dense is None:
            dense = scores_b is not None or not self._plan_local(len(qs))
        if dense and scores_b is None:
            from repro_torch.serve.batch import compute_batch_scores
            scores_b = compute_batch_scores(self.table, qs)
        x = self._features_batch(qs, scores_b=scores_b if dense else None)
        codes = self.rewriter.plan_codes(x).cpu().numpy()
        return [self._apply_skew_guard(self.rewriter.plan_from_codes(c), q)
                for q, c in zip(qs, codes[:len(qs)])]

    def execute(self, q: MHQ):
        """-> (ids (k,), scores (k,)) tensors; one underfill escalation to
        the robust default plan."""
        ids, scores = self.executor.execute(q, self.optimize(q))
        nv = _n_valid(ids)
        if nv < q.k:
            ids2, scores2 = self.executor.execute(
                q, default_plan(q.n_vec, self.engine))
            if _n_valid(ids2) > nv:
                return ids2, scores2
        return ids, scores

    def bind_cost_model(self, cost_model=None) -> "BoomHQ":
        """Override the scoring dispatcher's cost model (a
        ``serve.batch.CostModel`` — crossover constants and/or a forced
        path) for subsequent batched execution; ``bind_cost_model()``
        restores the default."""
        self.cost_model = cost_model
        self._batched = None
        return self

    def execute_batch(self, queries: list) -> list:
        """Batched analogue of execute(): one batched optimizer pass for the
        whole batch, grouped execution, then one batched underfill
        escalation. Returns [(ids, scores)] numpy pairs per query."""
        if not queries:
            return []
        from repro_torch.serve.batch import (
            MAX_BATCH_KERNEL, SLOT_BUDGET, compute_batch_scores, pow2_at_most,
        )
        t = self.table
        # bound the dense-score working set (batch · n_rows per column)
        limit = pow2_at_most(max(1, min(
            MAX_BATCH_KERNEL, SLOT_BUDGET // max(t.n_rows, 1))))
        if len(queries) > limit:
            out = []
            for s in range(0, len(queries), limit):
                out.extend(self.execute_batch(queries[s: s + limit]))
            return out
        # past the dense crossover the (B, n) similarity matrices are never
        # built: planning runs the unscored pre-probe and execution groups
        # gather only their candidate budgets
        plan_local = self._plan_local(len(queries))
        scores_b = None if plan_local else compute_batch_scores(t, queries)
        bx = self._batched_executor()
        plans = self.optimize_batch(queries, scores_b=scores_b,
                                    dense=not plan_local)
        results = bx.execute_batch(queries, plans, scores_b=scores_b)
        under = [j for j, (ids, _) in enumerate(results)
                 if _n_valid(ids) < queries[j].k]
        if under:
            sub = torch.as_tensor(under, device=t.device)
            retry = bx.execute_batch(
                [queries[j] for j in under],
                [default_plan(queries[j].n_vec, self.engine) for j in under],
                scores_b=tuple(s[sub] for s in scores_b)
                if scores_b is not None else None)
            for j, (ids2, s2) in zip(under, retry):
                if _n_valid(ids2) > _n_valid(results[j][0]):
                    results[j] = (ids2, s2)
        return results

    def _batched_executor(self):
        """The batched executor bound to this table and cost model; rebuilt
        when the table is another object (after ``insert``), so no
        executor serves the pre-insert table."""
        from repro_torch.serve.batch import BatchedHybridExecutor
        if self._batched is None or self._batched.table is not self.table:
            self._batched = BatchedHybridExecutor(
                self.table, self.indexes, self.engine,
                cost_model=self.cost_model, hists=self.hists,
                graphs=self.graphs)
        return self._batched

    def execute_timed(self, q: MHQ, *, repeats: int = 1):
        """(ids, scores, seconds) numpy — one warm ``execute``, then the mean
        seconds of ``repeats`` timed ones, optimizer included (the paper
        counts pre-probing and inference in the measured latency)."""
        from repro_torch.common.device import synchronize

        dev = self.table.device
        ids, scores = self.execute(q)
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            ids, scores = self.execute(q)
            synchronize(dev)
        dt = (time.perf_counter() - t0) / repeats
        return ids.cpu().numpy(), scores.cpu().numpy(), dt

    # -- updates (paper §3.2 incremental, §5.3) ------------------------------

    def insert(self, vectors: list, scalars: np.ndarray, *,
               finetune: bool = True) -> dict:
        """Data updates, the eager untiered path: append the rows, extend
        the IVF indexes from the first new row, update the histograms,
        extend the graphs (on the post-append columns), rebuild the
        executor (the batched one rebuilds on its next use and sizes its
        dispatcher by the grown ``n_rows``), then fine-tune the data encoder on the new rows when ``finetune`` is set
        and rebuild the query encoder on the grown table. -> the encoder
        update's metrics ({} without one). ``insert_seconds`` keeps the
        seconds of each step (device work included)."""
        from repro_torch.common.device import synchronize

        dev = self.table.device
        secs = {}
        t0 = time.perf_counter()

        def lap(step):
            nonlocal t0
            synchronize(dev)
            secs[step] = secs.get(step, 0.0) + time.perf_counter() - t0
            t0 = time.perf_counter()

        first_new = self.table.n_rows
        self.table = self.table.append(vectors, scalars)
        t = self.table
        lap("append")
        self.indexes = [ivf.extend(idx, v[first_new:], first_new)
                        for idx, v in zip(self.indexes, t.vectors)]
        lap("ivf")
        self.hists = histogram.update(self.hists, t.scalars[first_new:])
        lap("histograms")
        if self.graphs is not None:
            # graph.extend reads the FULL post-append column (the graph
            # stores no vectors), so this must follow the table append
            self.graphs = tuple(graph.extend(g, v, first_new)
                                for g, v in zip(self.graphs, t.vectors))
        lap("graphs")
        # the batched executor rebuilds on its next use: its table is no
        # longer self.table (``_batched_executor``)
        self.executor = HybridExecutor(t, self.indexes, self.engine,
                                       graphs=self.graphs)
        lap("rebuild")
        out = {}
        if self.data_encoder is not None and finetune:
            out = self.data_encoder.update(t, np.arange(first_new, t.n_rows))
        lap("encoder_update")
        if self.qenc is not None:
            self.qenc = QueryEncoder(t, self.indexes, self.hists,
                                     self.data_encoder)
        lap("rebuild")
        self.insert_seconds = secs
        return out
