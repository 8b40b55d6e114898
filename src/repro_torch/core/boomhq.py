"""BoomHQ façade: the learned optimizer wired end-to-end (paper Fig. 2).

Port of ``repro.core.boomhq``:

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
  insert():         data updates: into the hot segment of a tiered table
                    (``bind_tiered``), else the eager path (append the
                    rows, extend the indexes, histograms and graphs,
                    rebuild the executors, fine-tune the data encoder).
  bind_tiered():    streaming ingest: a hot segment scored exactly beside
                    the cold epoch, background compaction swapping epochs
                    (``vectordb.tiered``).
  bind_tenants():   namespaces: a query's ``tenant_id`` folds into its
                    predicate as an implicit equality (``resolve_tenant``).
  bind_shards():    serve over shards of the table (``serve.batch
                    .BatchedHybridExecutor.execute_batch_sharded``):
                    logical shards on one device, or the ranks of a
                    ``torch.distributed`` mesh.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.data_encoder import DataEncoder, DataEncoderConfig
from repro_torch.core.executor import EngineCaps, HybridExecutor, PGVECTOR
from repro_torch.core.query import (
    ExecutionPlan, MHQ, SubqueryParams, default_plan,
)
from repro_torch.core.query_encoder import QueryEncoder
from repro_torch.core.rewriter import MHQRewriter, RewriterConfig, generate_label
from repro_torch.vectordb import flat, graph, histogram, ivf, predicates
from repro_torch.vectordb.table import Table
from repro_torch.vectordb.tiered import (
    ColdState, TieredSnapshot, TieredTable, cold_digest,
)


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
    (``convert`` carries the JAX package's across this way).

    ``state`` holds the serving epoch (table, indexes, histograms, graphs)
    as one ``tiered.ColdState``; ``table``/``indexes``/``hists``/``graphs``
    read it. Planning and execution take the epoch as an argument: this
    one, or a tiered snapshot's cold epoch."""

    def __init__(self, table: Table, cfg: BoomHQConfig = BoomHQConfig(),
                 engine: EngineCaps = PGVECTOR, *, indexes=None, hists=None,
                 graphs=None):
        self.cfg = cfg
        self.engine = engine
        indexes = tuple(indexes) if indexes is not None else tuple(
            ivf.build(v, min(cfg.n_clusters, max(2, table.n_rows // 8)),
                      seed=i, metric=table.schema.metric)
            for i, v in enumerate(table.vectors))
        if hists is None:
            hists = histogram.build(table.scalars, cfg.hist_bins)
        if graphs is not None:
            graphs = tuple(graphs)
        elif cfg.graph_degree:
            graphs = tuple(
                graph.build(v, cfg.graph_degree, metric=table.schema.metric)
                for v in table.vectors)
        self.state = ColdState(table, indexes, hists, graphs)
        self.executor = HybridExecutor(table, list(indexes), engine,
                                       graphs=graphs)
        self.data_encoder: Optional[DataEncoder] = None
        if cfg.use_de:
            self.data_encoder = DataEncoder(
                [v.shape[1] for v in table.vectors], table.schema.n_scalar,
                cfg.encoder, device=table.device)
        self.qenc: Optional[QueryEncoder] = None
        # the query encoders of the epochs before the latest (tiered): a
        # batch plans with the encoder of its own snapshot's epoch
        self._older_qencs: deque = deque(maxlen=2)
        self.rewriter: Optional[MHQRewriter] = None
        self._fitted = False
        self.cost_model = None  # scoring-dispatch override (bind_cost_model)
        self.n_shards = 1  # logical shards served (bind_shards)
        self.shard_mesh = None  # the mesh served over (bind_shards)
        self.shard_axes = ("data",)
        self._batched = None
        self.insert_seconds: dict = {}  # the last insert's seconds by step
        self.tiered = None  # streaming-ingest state (bind_tiered)
        self.tenant_col = None  # namespace column index (bind_tenants)
        self._compactor = None  # background scheduler (serve attaches one)
        self._tiered_finetune = True
        # recent served queries, retained so compaction can warm the next
        # epoch's serving state with real traffic before the publish
        self._recent: deque = deque(maxlen=64)
        self._last_batch = 1
        # tiered over a mesh: the epochs whose cold-state digests the
        # ranks have compared
        self._digested: set = set()

    @property
    def table(self) -> Table:
        return self.state.table

    @property
    def indexes(self) -> list:
        return list(self.state.indexes)

    @property
    def hists(self) -> histogram.Histograms:
        return self.state.hists

    @property
    def graphs(self) -> Optional[tuple]:
        return self.state.graphs

    # -- offline -------------------------------------------------------------

    def fit(self, workload: list, *, verbose: bool = False,
            label_timer=None) -> dict:
        """Train the encoders and the rewriter on ``workload``.
        ``label_timer(executor, q, plan)`` -> (ids, scores, cost) prices
        the labelling grid: wall-clock by default, ``rewriter.work_timer``
        for labels that do not depend on the host's load."""
        from repro_torch.core.rewriter import wall_timer

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
            feats.append(self._features_batch([q], self.state)[0]
                         .cpu().numpy())
            labels.append(generate_label(
                self.executor, q, gt_ids.cpu().numpy(),
                refine_columns=self.cfg.rewriter.refine_columns,
                timer=label_timer or wall_timer))
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

    def _features_batch(self, qs: list, cold: ColdState, *,
                        scores_b: Optional[tuple] = None) -> torch.Tensor:
        """X_in for a query batch (B_bucket, F) — the port's counterpart of
        the fused feature jit: features of every query in one batched pass,
        pre-probed and estimated against the epoch ``cold``. The batch
        pads to a power-of-two bucket by repeating the first query, so it
        lines up with ``compute_batch_scores`` rows."""
        from repro_torch.serve.batch import next_bucket

        t = cold.table
        dev = t.device
        qpad = list(qs) + [qs[0]] * (next_bucket(len(qs)) - len(qs))
        pred_b = predicates.stack([q.predicates for q in qpad])
        qv_b = tuple(torch.stack([q.query_vectors[i] for q in qpad])
                     for i in range(t.schema.n_vec))
        cfg = self.cfg
        return self._qenc_for(cold).encode_batch(
            cold, qv_b, pred_b,
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

    def _qenc_for(self, cold: ColdState) -> QueryEncoder:
        """The query encoder built on the epoch ``cold`` (the latest, or
        one of the two before it), else the latest: which encoder plans a
        batch follows from its snapshot, not from when a compaction swaps
        the encoder."""
        for qe in (self.qenc, *reversed(self._older_qencs)):
            if qe is not None and qe.table is cold.table:
                return qe
        return self.qenc

    # -- online ----------------------------------------------------------------

    SINGLE_INDEX_MIN_SKEW = 0.85  # paper: single-index only for skewed weights

    def optimize(self, q: MHQ) -> ExecutionPlan:
        """One batched feature + head pass and one host sync per query."""
        if not self._fitted:
            return default_plan(q.n_vec, self.engine)
        codes = self.rewriter.plan_codes(self._features_batch([q],
                                                              self.state))
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

    def _plan_local(self, b: int, cold: ColdState) -> bool:
        """Should batch planning skip the dense score GEMMs? The pre-probe
        budget is weighed against the epoch ``cold``'s table by the same
        cost model that dispatches execution groups."""
        from repro_torch.serve.batch import CANDIDATE_LOCAL, CostModel, \
            next_bucket
        cm = self.cost_model if self.cost_model is not None else CostModel()
        n = cold.table.n_rows
        scan = 0
        for idx in cold.indexes:
            if self.qenc is not None:
                scan += ivf.probe_scan_budget(
                    idx.n_clusters, n, nprobe=self.qenc.probe_nprobe,
                    probe_k=self.qenc.probe_k)
            else:
                scan += min(n, self.engine.default_max_scan)
        return cm.choose(batch=next_bucket(max(1, b)), scan=max(1, scan),
                         n_rows=n * max(1, len(cold.indexes))) \
            == CANDIDATE_LOCAL

    def optimize_batch(self, qs: list, *, scores_b: Optional[tuple] = None,
                       dense: Optional[bool] = None, cold=None) -> list:
        """Plan a whole batch with one batched feature + head pass and ONE
        host sync. ``scores_b`` — per-column (B_bucket, n) similarities from
        ``compute_batch_scores`` — feeds the pre-probe features; ``dense``
        None auto-picks: past the dense crossover (and with no matrices
        passed in) planning runs the unscored pre-probe instead.

        ``cold`` — a snapshot's ``tiered.ColdState`` (``state`` where None):
        planning reads THAT epoch's table, indexes and histograms, so plans
        stay consistent with the data the batch executes against."""
        if not qs:
            return []
        if not self._fitted:
            return [default_plan(q.n_vec, self.engine) for q in qs]
        cold = self.state if cold is None else cold
        if dense is None:
            dense = scores_b is not None or not self._plan_local(len(qs),
                                                                 cold)
        if dense and scores_b is None:
            from repro_torch.serve.batch import compute_batch_scores
            scores_b = compute_batch_scores(cold.table, qs)
        x = self._features_batch(qs, cold,
                                 scores_b=scores_b if dense else None)
        codes = self.rewriter.plan_codes(x).cpu().numpy()
        return [self._apply_skew_guard(self.rewriter.plan_from_codes(c), q)
                for q, c in zip(qs, codes[:len(qs)])]

    def execute(self, q: MHQ):
        """-> (ids (k,), scores (k,)): tensors on the untiered path, with
        one underfill escalation to the robust default plan; over a tiered
        table the query rides a one-element batch against one snapshot
        (numpy, as ``execute_batch`` returns). The tenant namespace folds
        in first."""
        q = self.resolve_tenant(q)
        if self.tiered is not None:
            return self.execute_batch([q])[0]
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

    def bind_shards(self, n_shards: int = 1, *, mesh=None,
                    shard_axes=("data",)) -> "BoomHQ":
        """Serve over a SHARDED table: later ``execute_batch`` calls plan
        the batch with the learned optimizer and fan each execution group
        out over contiguous shards of the table. Index groups are
        cost-model routed to per-shard IVF probing (each shard probes its
        own index with the group's shard-legalized knobs and reranks inside
        the shard), the exact per-shard scan, or the single-device path
        when shards are small; filter_first groups keep the exact scan.

        The shards are ``n_shards`` logical ones on the table's device, or
        with a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``) one per
        rank over its ``shard_axes`` dimensions: every rank of the mesh
        holds this instance and calls ``execute_batch`` with the same
        queries; the mesh's first rank plans each batch and the others take
        its plans. To serve live traffic, the first rank runs
        ``serve.queue.AsyncServingEngine`` and every other rank
        ``serve.queue.serve_follower``, which runs the batches the first
        rank sends. A mesh of any size, one rank too, takes the sharded
        executor. ``bind_shards()`` restores single-shard serving."""
        if mesh is not None:
            from repro_torch.common.mesh import shard_rows

            shard_rows(self.table.n_rows, mesh, shard_axes)  # or raise
            if self.tiered is not None:
                self._check_hot_capacity(self.tiered.hot_capacity, mesh,
                                         shard_axes)
        self.n_shards = max(1, int(n_shards))
        self.shard_mesh = mesh
        self.shard_axes = shard_axes
        self._batched = None  # rebuild the executor with the shard config
        self._tiers_on_mesh()
        return self

    @property
    def _multi_rank(self) -> bool:
        return self.shard_mesh is not None and self.shard_mesh.size() > 1

    def _first_rank(self) -> bool:
        """Whether this rank plans and ingests: the mesh's first rank, or
        the only one."""
        if not self._multi_rank:
            return True
        from repro_torch.vectordb.distributed import is_first_rank
        return is_first_rank(self.shard_mesh)

    @staticmethod
    def _check_hot_capacity(hot_capacity: int, mesh, shard_axes) -> None:
        """Tiers over a mesh: full hot generations must keep the cold rows
        divisible over its shards."""
        from repro_torch.common.mesh import mesh_shard

        count = mesh_shard(mesh, shard_axes)[0]
        if hot_capacity % count:
            raise ValueError(f"hot_capacity {hot_capacity} is not divisible "
                             f"over {count} mesh shards")

    def _tiers_on_mesh(self) -> None:
        """Fit the tiered table to the shard config: over a mesh the cold
        rows stay divisible over its shards, and the first rank of a mesh
        of more than one rank keeps the ingest log the others replay."""
        if self.tiered is None:
            return
        if self.shard_mesh is None:
            self.tiered.row_multiple = 1
            return
        from repro_torch.common.mesh import mesh_shard

        self.tiered.row_multiple = mesh_shard(self.shard_mesh,
                                              self.shard_axes)[0]
        if self._multi_rank and self._first_rank():
            self.tiered.lead()

    @property
    def _sharded(self) -> bool:
        return self.n_shards > 1 or self.shard_mesh is not None

    # -- tiered streaming ingest ---------------------------------------------

    def bind_tiered(self, hot_capacity: int = 1024, *,
                    rebuild_every: int = 0,
                    finetune: bool = True) -> "BoomHQ":
        """Serve over a TIERED hot/cold table: subsequent ``insert`` calls
        append to a bounded writable hot segment (scored exactly,
        candidate-locally, as one extra merge source of every query) and
        compaction folds full segments into the cold IVF state under an
        epoch-swapped snapshot (``vectordb.tiered``). ``rebuild_every=N``
        makes every Nth compaction a full re-cluster; ``finetune`` keeps
        the data encoder updating on compacted rows. ``unbind_tiered()``
        restores build-once serving.

        Composes with ``bind_shards``: over a mesh (either order of the two
        calls, on every rank alike) ``hot_capacity`` must divide over its
        shards (``ValueError``), and a compaction that would leave cold
        rows that do not divide raises and leaves them hot. Over a mesh of
        more than one rank the first rank owns ingest (``insert``
        elsewhere raises) and the epoch cuts: ``AsyncServingEngine`` sends
        every batch with its snapshot stamp and the ingest since, and
        ``serve.queue.serve_follower`` replays them (each follower
        compacts on its own). Without an engine every rank calls
        ``tiered.insert``/``tiered.compact()`` and ``execute_batch`` alike,
        and each batch first checks every rank's snapshot against the
        others' (a mismatch raises on every rank)."""
        if self.shard_mesh is not None:
            self._check_hot_capacity(hot_capacity, self.shard_mesh,
                                     self.shard_axes)
        self._tiered_finetune = finetune
        self.tiered = TieredTable(
            self.table, self.state.indexes, self.hists,
            hot_capacity=hot_capacity, rebuild_every=rebuild_every,
            finetune_cb=self._on_compaction, graphs=self.graphs)
        self._digested = set()
        self._tiers_on_mesh()
        return self

    def unbind_tiered(self) -> "BoomHQ":
        """Back to build-once serving. The façade's fields tracked every
        compaction, so the latest cold epoch stays the serving state; rows
        still hot fold in through the eager insert."""
        t = self.tiered
        self.tiered = None
        self._compactor = None
        if t is not None:
            for view in t.snapshot().hot_views:
                if view.count:
                    self.insert(
                        [v[: view.count] for v in view.np_vectors],
                        view.np_scalars[: view.count],
                        finetune=self._tiered_finetune)
        return self

    def _on_compaction(self, cold: ColdState, first_new: int,
                       n_new: int) -> None:
        """Compaction-thread callback (runs BEFORE the epoch publish):
        fine-tune the data encoder on the newly cold rows, rebuild the query
        encoder, keep the façade's state on the latest epoch, and warm the
        next epoch's serving state. Serving reads none of these fields for
        a tiered batch except the query encoder, which is replaced whole:
        the encoder is updated on a copy and published with it, so a batch
        on the serving thread sees the old pair or the new one, never a
        half-trained encoder.

        Over a mesh of more than one rank only the first rank plans, so
        only it fine-tunes and rebuilds the encoders, and no rank warms
        the new epoch here: a warm-up batch would enter the mesh's
        collectives off the serving thread, out of step with the other
        ranks. The first batch of each epoch builds its executor on every
        rank's serving path instead."""
        if self._first_rank():
            de = self.data_encoder
            if de is not None and self._tiered_finetune:
                de = copy.deepcopy(de)
                de.update(cold.table, np.arange(first_new, first_new + n_new))
            self.data_encoder = de
            if self.qenc is not None:
                self._older_qencs.append(self.qenc)
                self.qenc = QueryEncoder(cold.table, list(cold.indexes),
                                         cold.hists, de)
        self.state = cold
        self.executor = HybridExecutor(cold.table, list(cold.indexes),
                                       self.engine, graphs=cold.graphs)
        if not self._multi_rank:
            self._prewarm_cold(cold)

    def _prewarm_cold(self, cold: ColdState) -> None:
        """Serve the retained recent queries against the new cold state on
        the compacting thread BEFORE the epoch publish, through the real
        serving entry (``warm_bucket_ladder`` of ``execute_batch``), as
        the reference does. There is no compile to warm on the card; the
        passes build the new epoch's ``BatchedHybridExecutor`` into the
        single-slot cache and the new table's int8 replicas.

        Two limits, both the reference's: the recent queries are those of
        the last direct ``execute_batch`` calls, since
        ``AsyncServingEngine`` passes a ``snapshot`` with every batch and
        so records none; and a batch served on the old snapshot between
        this warm-up and the publish rebuilds the old epoch's executor on
        the serving thread, evicting the one built here. Its kernel
        launches count into ``gather_score.PREWARM_LAUNCHES``."""
        qs = list(self._recent)[-max(1, self._last_batch):]
        if not qs:
            return
        from repro_torch.kernels import gather_score as gs
        from repro_torch.serve.batch import warm_bucket_ladder

        # a pre-publish snapshot of the new cold state (no hot views:
        # compaction just drained them); passing a snapshot also keeps
        # these batches out of _recent
        snap = TieredSnapshot(epoch=-1, cold=cold, hot_views=())
        with gs.counted_as(gs.PREWARM_LAUNCHES):
            warm_bucket_ladder(
                lambda batch: self.execute_batch(batch, snapshot=snap),
                qs, len(qs))

    # -- tenants -------------------------------------------------------------

    def bind_tenants(self, column: int | str = "tenant") -> "BoomHQ":
        """Serve MULTI-TENANT: queries carrying ``MHQ.tenant_id`` are scoped
        to rows whose ``column`` equals that id, through an implicit
        ``tenant == id`` conjunct folded into every DNF clause
        (``predicates.fold_conjunct``); clause buckets and kernels stay as
        they are. ``unbind_tenants()`` restores shared serving."""
        if isinstance(column, str):
            names = {sc.name: i for i, sc in
                     enumerate(self.table.schema.scalar_cols)}
            if column not in names:
                raise KeyError(f"unknown scalar column {column!r}")
            self.tenant_col = names[column]
        else:
            if not 0 <= int(column) < self.table.schema.n_scalar:
                raise IndexError(f"scalar column {column} out of range")
            self.tenant_col = int(column)
        return self

    def unbind_tenants(self) -> "BoomHQ":
        self.tenant_col = None
        return self

    def resolve_tenant(self, q: MHQ) -> MHQ:
        """Fold the query's tenant namespace into its predicate. A no-op for
        untenanted queries or unbound instances; idempotent, so the serving
        front-end (which folds before its cache lookup) and the execute
        paths may both resolve."""
        if q.tenant_id is None or self.tenant_col is None:
            return q
        t = float(int(q.tenant_id))
        return dataclasses.replace(q, predicates=predicates.fold_conjunct(
            q.predicates, self.tenant_col, t, t))

    # -- batched serving -------------------------------------------------------

    def execute_batch(self, queries: list, *, snapshot=None) -> list:
        """Batched analogue of execute(): one batched optimizer pass for the
        whole batch, grouped execution, then one batched underfill
        escalation. Returns [(ids, scores)] numpy pairs per query.

        Over a TIERED table the whole batch executes against ONE immutable
        snapshot — ``snapshot`` when the batch former stamped one at cut
        time, else taken here: the cold side runs the plan-driven paths on
        the snapshot's epoch and the hot views merge in as one more exact
        candidate source (``_merge_hot``). Only calls without a
        ``snapshot`` are recorded as recent traffic (only a tiered
        compaction reads them, and not over a mesh of more than one rank).
        Over a tiered table on a mesh of more than one rank, every rank
        first contributes its snapshot's stamp (and, at the first batch of
        each epoch, its cold-state digest) to one gather, and unless all
        are equal every rank raises (``distributed.check_stamps``).

        Over a sharded table (``bind_shards``) the learned plans fan out
        across the shards (``_execute_batch_sharded``), with per-shard
        escalation inside the probing route and a global underfill
        cross-check on top."""
        if not queries:
            return []
        queries = [self.resolve_tenant(q) for q in queries]
        if snapshot is None:
            self._recent.extend(queries)
            self._last_batch = len(queries)
        snap = snapshot
        if snap is None and self.tiered is not None:
            snap = self.tiered.snapshot()
        if snap is not None and self._multi_rank:
            self._check_stamp(snap)
        return self._execute_batch_on(queries, snap)

    def _check_stamp(self, snap) -> None:
        """Every rank's snapshot against the others': one gather of each
        rank's stamp, with its cold-state digest at the first batch of an
        epoch (an epoch counts as compared only once all agreed, so after
        a mismatch every batch of that epoch fails alike)."""
        from repro_torch.vectordb.distributed import check_stamps

        first = snap.epoch not in self._digested
        check_stamps(snap.stamp + (cold_digest(snap.cold) if first else 0,),
                     self.shard_mesh, device=snap.cold.table.device)
        self._digested.add(snap.epoch)

    def _execute_batch_on(self, queries: list, snap) -> list:
        """``execute_batch`` on resolved queries against ``snap`` (None for
        the façade's untiered ``state``), cut into sub-batches that keep the
        dense-score working set (batch · n_rows per column) bounded."""
        from repro_torch.serve.batch import (
            MAX_BATCH_KERNEL, SLOT_BUDGET, compute_batch_scores, pow2_at_most,
        )
        cold = self.state if snap is None else snap.cold
        t = cold.table
        limit = pow2_at_most(max(1, min(
            MAX_BATCH_KERNEL, SLOT_BUDGET // max(t.n_rows, 1))))
        if len(queries) > limit:
            out = []
            for s in range(0, len(queries), limit):
                out.extend(self._execute_batch_on(queries[s: s + limit],
                                                  snap))
            return out
        # past the dense crossover the (B, n) similarity matrices are never
        # built: planning runs the unscored pre-probe and execution groups
        # gather only their candidate budgets
        plan_local = self._plan_local(len(queries), cold)
        scores_b = None if plan_local else compute_batch_scores(t, queries)
        bx = self._batched_executor(cold)
        if self._sharded:
            results = self._execute_batch_sharded(queries, bx, scores_b,
                                                  cold=cold)
        else:
            plans = self.optimize_batch(queries, scores_b=scores_b,
                                        dense=not plan_local, cold=cold)
            results = bx.execute_batch(queries, plans, scores_b=scores_b)
            self._retry_underfilled(
                results, queries, bx, scores_b,
                lambda q: default_plan(q.n_vec, self.engine))
        if snap is not None and snap.hot_views:
            results = self._merge_hot(results, queries, snap)
        return results

    @staticmethod
    def _retry_underfilled(results: list, queries: list, bx, scores_b,
                           plan_of) -> None:
        """Re-run the queries that returned fewer than k valid ids under
        ``plan_of(q)`` as one grouped pass; the better-filled result wins
        (in place)."""
        under = [j for j, (ids, _) in enumerate(results)
                 if _n_valid(ids) < queries[j].k]
        if not under:
            return
        sub = torch.as_tensor(under, device=bx.table.device)
        retry = bx.execute_batch(
            [queries[j] for j in under], [plan_of(queries[j]) for j in under],
            scores_b=tuple(s[sub] for s in scores_b)
            if scores_b is not None else None)
        for j, (ids2, s2) in zip(under, retry):
            if _n_valid(ids2) > _n_valid(results[j][0]):
                results[j] = (ids2, s2)

    def _execute_batch_sharded(self, queries: list, bx, scores_b,
                               cold: ColdState) -> list:
        """Plan-driven cross-shard execution: the batch is planned as on
        one shard, then ``bx.execute_batch_sharded`` routes every group
        (per-shard probing with per-shard escalation / exact sharded scan
        / single device). Any query still under k valid ids re-runs
        through the exact ``filter_first`` over the whole table, and the
        better-filled result wins.

        On a mesh of more than one rank the first rank's plans go to every
        rank (one broadcast), so all ranks form the same groups in the
        same order and meet in the same collectives. If planning raises on
        the first rank, the broadcast carries the exception instead
        (``distributed.portable_error``) and every rank raises it for this
        batch (marked shared), so none is left waiting in a collective."""
        n = cold.table.n_rows
        mesh = self.shard_mesh
        if mesh is None or mesh.size() == 1:
            plans = self.optimize_batch(queries, scores_b=scores_b, cold=cold)
        else:
            from repro_torch.vectordb.distributed import (
                broadcast_from_first, is_first_rank, mark_shared,
                portable_error,
            )

            sent, failure = None, None
            if is_first_rank(mesh):
                try:
                    sent = (True, self.optimize_batch(
                        queries, scores_b=scores_b, cold=cold))
                except Exception as exc:  # noqa: BLE001 — every rank raises
                    failure = exc
                    sent = (False, portable_error(exc))
            ok, plans = broadcast_from_first(sent, mesh)
            if not ok:
                raise mark_shared(failure if failure is not None else plans)
        results = bx.execute_batch_sharded(queries, plans, scores_b=scores_b)
        self._retry_underfilled(
            results, queries, bx, scores_b,
            lambda q: ExecutionPlan("filter_first", tuple(
                SubqueryParams() for _ in range(q.n_vec)),
                max_candidates=n))
        return results

    def _merge_hot(self, results, queries: list, snap) -> list:
        """Fold the snapshot's hot views into the cold results: one fused
        exact gather-score over each bounded hot view plus one pass of the
        dedup merge (``tiered.merge_hot_batch``). Hot and cold row ids are
        disjoint, so escalation and recall contracts hold unchanged; an
        empty hot segment never reaches here (bit-for-bit cold parity)."""
        from repro_torch.core.executor import K_BUCKET_FLOOR, next_bucket
        from repro_torch.kernels.shapes import NEG
        from repro_torch.vectordb import tiered

        dev = snap.cold.table.device
        b = len(queries)
        k_pad = next_bucket(max(K_BUCKET_FLOOR, max(q.k for q in queries)))
        b_pad = next_bucket(b)
        qpad = list(queries) + [queries[0]] * (b_pad - b)
        n_vec = snap.cold.table.schema.n_vec
        pred_b = predicates.stack([q.predicates for q in qpad])
        qv_b = tuple(torch.stack([q.query_vectors[i] for q in qpad])
                     for i in range(n_vec))
        w_b = torch.as_tensor(np.asarray([q.weights for q in qpad],
                                         np.float32), device=dev)
        cold_ids = np.full((b_pad, k_pad), -1, np.int32)
        cold_scores = np.full((b_pad, k_pad), np.float32(NEG), np.float32)
        for j, (ids, scores) in enumerate(results):
            ids = np.asarray(ids, np.int32).ravel()
            kk = min(ids.shape[0], k_pad)
            cold_ids[j, :kk] = ids[:kk]
            cold_scores[j, :kk] = np.asarray(scores, np.float32).ravel()[:kk]
        views = tuple(tiered.view_args(v) for v in snap.hot_views)
        m_ids, m_scores = tiered.merge_hot_batch(
            torch.as_tensor(cold_ids, device=dev),
            torch.as_tensor(cold_scores, device=dev), views, qv_b, w_b,
            pred_b, k=k_pad, metric=snap.cold.table.schema.metric)
        m_ids, m_scores = m_ids.cpu().numpy(), m_scores.cpu().numpy()
        return [(m_ids[j, : q.k], m_scores[j, : q.k])
                for j, q in enumerate(queries)]

    def _batched_executor(self, cold: Optional[ColdState] = None):
        """The batched executor bound to an epoch — ``cold``, else the
        façade's ``state`` — the cost model and the shard config. A
        single-slot cache keyed on table identity: batches execute in
        formation order, so an epoch swap rebuilds once (the compacting
        thread's warm-up usually did it already). The slot is read once,
        so a concurrent replacement can never hand this caller an executor
        of another table."""
        from repro_torch.serve.batch import BatchedHybridExecutor

        cold = self.state if cold is None else cold
        bx = self._batched
        if bx is None or bx.table is not cold.table:
            bx = BatchedHybridExecutor(
                cold.table, list(cold.indexes), self.engine,
                n_shards=self.n_shards, mesh=self.shard_mesh,
                shard_axes=self.shard_axes, cost_model=self.cost_model,
                hists=cold.hists, graphs=cold.graphs)
            self._batched = bx
        return bx

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
        """Data updates. Tiered (``bind_tiered``): the rows append to the
        hot segment — visible to the next formed batch, scored exactly,
        never a serving pause — and compaction (in the background when a
        scheduler is attached, else on the next ``compact()``) folds them
        cold, fine-tuning the encoder per ``finetune``; -> the tiered
        table's insert stats.

        Untiered, the eager path: append the rows, extend the IVF indexes
        from the first new row, update the histograms, extend the graphs
        (on the post-append columns), rebuild the executor (the batched
        one rebuilds on its next use and sizes its dispatcher by the grown
        ``n_rows``), then fine-tune the data encoder on the new rows when
        ``finetune`` is set and rebuild the query encoder on the grown
        table. -> the encoder update's metrics ({} without one).
        ``insert_seconds`` keeps the seconds of each step (device work
        included)."""
        from repro_torch.common.device import synchronize

        if self.tiered is not None:
            if not self._first_rank():
                raise ValueError(
                    "over a mesh of more than one rank the first rank owns "
                    "tiered ingest: insert there (serve_follower replays "
                    "its rows here), or call tiered.insert on every rank "
                    "alike")
            self._tiered_finetune = finetune
            stats = self.tiered.insert(vectors, scalars)
            if stats["needs_compaction"] and self._compactor is not None:
                self._compactor.maybe_schedule()
            return stats

        dev = self.table.device
        secs = {}
        t0 = time.perf_counter()

        def lap(step):
            nonlocal t0
            synchronize(dev)
            secs[step] = secs.get(step, 0.0) + time.perf_counter() - t0
            t0 = time.perf_counter()

        first_new = self.table.n_rows
        t = self.table.append(vectors, scalars)
        lap("append")
        indexes = tuple(ivf.extend(idx, v[first_new:], first_new)
                        for idx, v in zip(self.state.indexes, t.vectors))
        lap("ivf")
        hists = histogram.update(self.hists, t.scalars[first_new:])
        lap("histograms")
        graphs = self.graphs
        if graphs is not None:
            # graph.extend reads the FULL post-append column (the graph
            # stores no vectors), so this must follow the table append
            graphs = tuple(graph.extend(g, v, first_new)
                           for g, v in zip(graphs, t.vectors))
        lap("graphs")
        self.state = ColdState(t, indexes, hists, graphs)
        # the batched executor rebuilds on its next use: its table is no
        # longer self.table (``_batched_executor``)
        self.executor = HybridExecutor(t, list(indexes), self.engine,
                                       graphs=graphs)
        lap("rebuild")
        out = {}
        if self.data_encoder is not None and finetune:
            out = self.data_encoder.update(t, np.arange(first_new, t.n_rows))
        lap("encoder_update")
        if self.qenc is not None:
            self.qenc = QueryEncoder(t, list(indexes), hists,
                                     self.data_encoder)
        lap("rebuild")
        self.insert_seconds = secs
        return out
