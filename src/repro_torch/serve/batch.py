"""Batched MHQ execution: grouped serving of many hybrid queries.

Port of the unsharded part of ``repro.serve.batch``:

  * queries group by (strategy, legalized per-column subquery params, k,
    clause bucket, precision) — every query in a group runs the same
    batched tensor program over the query axis; graph groups key on the
    legalized (beam_width, n_hops) pair and always run candidate-local;
  * a per-group ``ScoringDispatcher`` picks DENSE scoring (one GEMM per
    vector column scores every row for the whole chunk; search,
    filter-first and rerank then gather f32 scores) or CANDIDATE-LOCAL
    scoring (only each query's candidate budget is gathered and scored,
    through the fused gather+score kernel);
  * batch, top-k and candidate widths pad to power-of-two buckets;
  * ``iterative_scan`` re-expansion runs per group: one host sync reads the
    group's qualified counts each round and only the still-underfilled
    subset re-probes at a doubled nprobe.

  * over shards ``execute_batch_sharded`` fans each group out: index
    groups route three ways (``choose_sharded``) — plan-driven per-shard
    IVF probing (``vectordb.distributed``) with per-shard boundary
    escalation, the exact per-shard scan, or the plain single-device
    chunk — filter_first groups take the exact scan and graph groups the
    single-device walk. The shards are logical ones on one device
    (``n_shards``), or a ``torch.distributed`` mesh (``mesh``): one rank
    per shard, every rank running the same batch, each sharded route
    reading only the rank's rows and merging with one gather.

``ServingEngine`` chops a request stream into batches and drives
``BoomHQ.execute_batch``; ``serve.queue.AsyncServingEngine`` forms batches
from live arrivals and reports into the same ``ServeReport``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.common.device import synchronize
from repro_torch.common.mesh import mesh_shard, shard_rows
from repro_torch.core.executor import (
    CANDIDATE_PAD_FLOOR, EngineCaps, HybridExecutor, PGVECTOR,
    legalize_for_shard, next_bucket, plan_columns, pow2_at_most, recall_at_k,
    rerank_scored, rrf_extras, rrf_union_total, subquery_width,
)
from repro_torch.core.query import ExecutionPlan, MHQ
from repro_torch.kernels.gather_score import gather_score_topk, \
    merge_topk_unique
from repro_torch.kernels.shapes import (
    GRAPH_ENTRY_POINTS, GRAPH_SEED_FACTOR, NEG,
)
from repro_torch.vectordb import flat, graph, histogram, ivf, predicates
from repro_torch.vectordb.distributed import (
    build_sharded_ivf, mesh_topk, sharded_batch_topk, sharded_ivf_topk,
    sharded_topk_ref,
)
from repro_torch.vectordb.flat import nonzero_fixed, topk_stable
from repro_torch.vectordb.table import Table, similarity_batch

# Dense-score budget: chunks are sized so batch · n_rows stays under this
# many slots per active vector column.
SLOT_BUDGET = 1 << 23
MAX_BATCH_KERNEL = 64  # widest batched execution chunk

DENSE = "dense"
CANDIDATE_LOCAL = "candidate_local"
# sharded-group routes: plan-driven per-shard IVF probing, or no fan-out
# (the plain single-device chunk, when shards are too small to amortize
# the merge)
SHARDED_LOCAL = "sharded_local"
SINGLE_DEVICE = "single_device"

# histogram-estimated static gather caps of the exact sharded scan:
# cap = next_bucket(margin · estimated max + slack); queries whose true
# qualifying count overflows the cap re-run at their exact width
CAP_MARGIN = 1.5
CAP_SLACK = 32


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Scoring-path cost model: dense vs candidate-local, plus the sharded
    three-way route.

    Candidate-local wins when ``batch · scan + overhead ≤ crossover ·
    n_rows``. The constants are the JAX package's, fitted on a CPU
    container; they are placeholders on the H100 until re-fitted there.
    The crossover is per precision (``crossover_int8`` for the int8
    tier). ``choose_sharded`` routes a sharded group to per-shard probing
    (``SHARDED_LOCAL``) when the same inequality holds at the global
    scale, the exact per-shard scan (``DENSE``) otherwise, and to no
    fan-out (``SINGLE_DEVICE``) when shards hold fewer than
    ``min_shard_rows`` rows. ``force`` pins every group to one path:
    local-flavoured forces pin the context's local path."""

    crossover: float = 0.136
    overhead: float = 2048.0  # per-batch fixed cost, in gathered-row units
    crossover_int8: float = 0.545
    overhead_int8: float = 3350.0
    # graph tier: a visited graph row in gathered-row units, and the
    # per-batch fixed cost of the walk's n_hops sequential hop steps
    graph_row_cost: float = 0.216
    overhead_graph: float = 328.3
    min_shard_rows: int = 4096
    force: Optional[str] = None

    def constants(self, precision: str = "fp32") -> tuple:
        if precision == "int8":
            return self.crossover_int8, self.overhead_int8
        return self.crossover, self.overhead

    def choose_strategy(self, *, batch: int, graph_scan: int,
                        probe_scan: int, n_rows: int) -> str:
        """The cheapest of {"exact", "index_scan", "graph"} in gathered-row
        units: exact ≈ crossover · n_rows (one dense GEMM per column),
        probe ≈ batch · probe_scan + overhead, graph ≈ batch · graph_scan ·
        graph_row_cost + overhead_graph."""
        costs = {
            "exact": self.crossover * n_rows,
            "index_scan": batch * probe_scan + self.overhead,
            "graph": batch * graph_scan * self.graph_row_cost
            + self.overhead_graph,
        }
        return min(costs, key=costs.get)

    def choose(self, *, batch: int, scan: int, n_rows: int,
               precision: str = "fp32") -> str:
        if self.force is not None:
            return CANDIDATE_LOCAL \
                if self.force in (CANDIDATE_LOCAL, SHARDED_LOCAL) else DENSE
        xo, oh = self.constants(precision)
        if batch * scan + oh <= xo * n_rows:
            return CANDIDATE_LOCAL
        return DENSE

    def choose_sharded(self, *, batch: int, scan: int, n_rows: int,
                       n_shards: int) -> str:
        if self.force is not None:
            if self.force in (CANDIDATE_LOCAL, SHARDED_LOCAL):
                return SHARDED_LOCAL
            return self.force  # DENSE or SINGLE_DEVICE
        if n_rows // max(1, n_shards) < self.min_shard_rows:
            return SINGLE_DEVICE
        return SHARDED_LOCAL if self.choose(
            batch=batch, scan=scan, n_rows=n_rows) == CANDIDATE_LOCAL \
            else DENSE


class ScoringDispatcher:
    """Per-group scoring-path dispatch + a bounded decision log, surfaced
    as ``ServeReport.path_counts``."""

    MAX_DECISIONS = 4096

    def __init__(self, n_rows: int, cost_model: Optional[CostModel] = None):
        self.n_rows = int(n_rows)
        self.cost_model = cost_model if cost_model is not None else CostModel()
        self.counts: dict = {}
        self.decisions: deque = deque(maxlen=self.MAX_DECISIONS)

    def pins_dense(self, prefer_dense: bool) -> bool:
        """A chunk whose dense score matrices were already computed (the
        planner wanted them) gathers from them unless a path is forced."""
        return prefer_dense and self.cost_model.force is None

    def choose(self, *, batch: int, scan: int, group=None,
               force: Optional[str] = None, prefer_dense: bool = False,
               precision: str = "fp32") -> str:
        """``force`` pins this decision to one path (graph groups have no
        dense variant); it is still logged."""
        if force is not None:
            path = force
        elif self.pins_dense(prefer_dense):
            path = DENSE
        else:
            path = self.cost_model.choose(batch=batch, scan=scan,
                                          n_rows=self.n_rows,
                                          precision=precision)
        self.decisions.append({"group": group, "batch": batch, "scan": scan,
                               "path": path, "precision": precision})
        self.counts[path] = self.counts.get(path, 0) + 1
        return path

    def choose_sharded(self, *, batch: int, scan: int, n_shards: int,
                       group=None, prefer_dense: bool = False) -> str:
        """Route one sharded plan-driven group: per-shard IVF probing, the
        exact per-shard scan, or no fan-out (``SINGLE_DEVICE`` delegates
        to the plain chunk, which logs its own decision). The paid-for-GEMM
        rule applies here too."""
        if self.pins_dense(prefer_dense):
            path = DENSE
        else:
            path = self.cost_model.choose_sharded(
                batch=batch, scan=scan, n_rows=self.n_rows,
                n_shards=n_shards)
        self.decisions.append({"group": group, "batch": batch, "scan": scan,
                               "path": path})
        self.counts[path] = self.counts.get(path, 0) + 1
        return path

    def take(self) -> tuple:
        """(counts, recent decisions) since the last take; resets both."""
        counts, decisions = self.counts, list(self.decisions)
        self.counts = {}
        self.decisions.clear()
        return counts, decisions


def pad_selection(sel: np.ndarray) -> np.ndarray:
    """Pad a non-empty query-index selection to its power-of-two bucket by
    repeating the first element (padding lanes are sliced away)."""
    bb = next_bucket(len(sel))
    return np.concatenate([sel, np.full(bb - len(sel), sel[0])])


def warm_bucket_ladder(execute_batch, queries: list, batch_size: int) -> None:
    """One untimed pass per power-of-two batch bucket up to
    ``next_bucket(batch_size)``: arrival-driven serving cuts batches at many
    sizes, and each size's first pass (allocator growth, library
    workspaces, lazily built int8 replicas) stays out of measured serving."""
    b = 1
    while b <= next_bucket(batch_size) and queries:
        execute_batch(queries[: min(b, len(queries))])
        b <<= 1


def compute_batch_scores(table: Table, queries: list) -> tuple:
    """Per-column (B_bucket, n) dense similarity matrices for a query batch
    (batch padded to a power-of-two bucket by repeating the first query),
    computed once per batch and shared by the batched optimizer and
    executor. A plain ``torch.matmul`` per column."""
    bb = next_bucket(len(queries))
    qpad = list(queries) + [queries[0]] * (bb - len(queries))
    return tuple(
        similarity_batch(torch.stack([q.query_vectors[i] for q in qpad]),
                         table.vectors[i], table.schema.metric)
        for i in range(table.schema.n_vec))


def _search_batch(index, scores_b, scalars, pred_b, q_b, *, nprobe,
                  max_scan, k):
    return ivf.search_scored_batch(index, scores_b, scalars, pred_b, q_b,
                                   nprobe=nprobe, max_scan=max_scan, k=k)


def _filter_first_batch(w_scores_b, scalars, pred_b, *, k, max_candidates):
    return flat.filter_first_scored(w_scores_b, scalars, pred_b, k=k,
                                    max_candidates=max_candidates)


def _rerank_batch(w_scores_b, rows_b, *, k):
    return rerank_scored(w_scores_b, rows_b, k=k)


def _gather_rerank_batch(rows_b, vectors, q_b, w_b, scalars, *, k, metric):
    """Candidate-local weighted re-rank: fused gather+score+dedup+top-k over
    the candidate union — no (B, n) weighted score matrix."""
    return gather_score_topk(rows_b, vectors, q_b, w_b, scalars, None,
                             k=k, metric=metric)


def _eval_mask_batch(pred_b, scalars):
    """(B,) stacked predicates × (n, M) scalars -> (B, n) bool masks."""
    return predicates.eval_mask(pred_b, scalars)


def _selectivity_batch(hists, pred_b):
    """(B,) histogram selectivity estimates of a stacked predicate batch:
    statistics only, no table read."""
    return histogram.estimate_selectivity(hists, pred_b)


def _qualifying_rows_batch(mask_b, *, size):
    """(B, n) bool masks -> (B, size) qualifying row ids, -1 padded."""
    return nonzero_fixed(mask_b, size, -1).to(torch.int32)


def _allowed_scores(vectors, scalars, pred_b, q_b, w_b, allow, *, metric):
    """(B, n) weighted scores of the rows against a query batch (one
    ``torch.matmul`` per column), NEG where the predicate or the (B, n)
    ``allow`` mask excludes the row."""
    ws = torch.zeros((w_b.shape[0], scalars.shape[0]), device=scalars.device)
    for i, v in enumerate(vectors):
        ws = ws + w_b[:, i, None] * similarity_batch(q_b[i], v, metric)
    mask = _eval_mask_batch(pred_b, scalars) & allow
    return torch.where(mask, ws, torch.full_like(ws, NEG))


def _sharded_exact_retry(vectors, scalars, pred_b, q_b, w_b, need_b, *,
                         shard_len, k, metric):
    """Exact weighted filtered top-k over each query's flagged shards: the
    retry subset scored against the table, the predicate mask ANDed with
    the per-query shard-allow mask (rows of other shards contribute
    nothing), then one top-k. -> (ids (B, k) int32, scores (B, k))."""
    n = scalars.shape[0]
    shard_of = torch.clamp(
        torch.arange(n, device=scalars.device) // shard_len,
        max=need_b.shape[1] - 1)
    top_s, top_i = topk_stable(_allowed_scores(
        vectors, scalars, pred_b, q_b, w_b, need_b[:, shard_of],
        metric=metric), k)
    ids = torch.where(top_s > NEG / 2, top_i, torch.full_like(top_i, -1))
    return ids.to(torch.int32), top_s


def _to_host(*tensors) -> list:
    """Read (B, ·) int32 / float32 tensors back in ONE transfer (floats
    travel as their bits). -> numpy arrays in the same order and dtypes."""
    parts = [t.to(torch.int32) if t.dtype != torch.float32
             else t.view(torch.int32) for t in tensors]
    host = torch.cat(parts, dim=1).cpu().numpy()
    out, c = [], 0
    for t in tensors:
        a = host[:, c: c + t.shape[1]]
        a = np.ascontiguousarray(a)
        out.append(a.view(np.float32) if t.dtype == torch.float32 else a)
        c += t.shape[1]
    return out


# ---------------------------------------------------------------------------
# batched executor
# ---------------------------------------------------------------------------

class BatchedHybridExecutor:
    """Executes a list of (MHQ, ExecutionPlan) pairs group by group.
    Produces per-query results matching ``HybridExecutor`` up to float
    reduction order and near-exact ties.

    With ``n_shards > 1`` the executor also serves the CROSS-SHARD paths
    over contiguous logical shards of the table
    (:meth:`execute_batch_sharded`). With a ``mesh`` (a ``DeviceMesh``
    whose ``shard_axes`` dimensions give the shard count) it runs on every
    rank of the mesh: each rank holds the table, the sharded routes read
    only its rows ``[r·n/S, (r+1)·n/S)`` and merge the shards with one
    gather, and the other routes run on every rank alike, so every rank
    returns the same results. Every rank must then call it with the same
    queries and plans."""

    def __init__(self, table: Table, indexes: list,
                 engine: EngineCaps = PGVECTOR, *, n_shards: int = 1,
                 mesh=None, shard_axes=("data",),
                 cost_model: Optional[CostModel] = None, hists=None,
                 graphs=None):
        self.mesh = mesh
        self.shard_axes = shard_axes if isinstance(shard_axes, tuple) \
            else (shard_axes,)
        if mesh is not None:
            n_shards, self.shard = mesh_shard(mesh, self.shard_axes)
            self.rows = shard_rows(table.n_rows, mesh, self.shard_axes)
        self.table = table
        self.indexes = indexes
        self.engine = engine
        self.hists = hists
        self.graphs = tuple(graphs) if graphs is not None else None
        self.dispatcher = ScoringDispatcher(table.n_rows, cost_model)
        self.n_shards = max(1, int(n_shards))
        # this executor's table only: an epoch swap builds a new executor,
        # so per-shard indexes never outlive the epoch they were built on
        self._sivf: dict = {}  # col -> ShardedIVF (lazy; a rank's own shard)
        self._sivf_fns: dict = {}  # (group key, act) -> probing search
        self._shard_fns: dict = {}  # k -> the mesh's exact sharded scan
        # positions (in the last execute_batch_sharded call) of queries
        # whose probed result took the exact shard-subset retry; callers
        # may clear it
        self.escalated: set = set()
        self._seq = HybridExecutor(table, indexes, engine, graphs=graphs)

    def legalize(self, plan: ExecutionPlan) -> ExecutionPlan:
        return self._seq.legalize(plan)

    # -- grouping ----------------------------------------------------------

    def _group_key(self, q: MHQ, plan: ExecutionPlan):
        """Everything that fixes the shapes of the group's program:
        filter_first groups on (clause bucket, k, max_candidates); index
        groups on the clause bucket, k, each active column's effective
        (k_i, nprobe, max_scan, iterative) and the plan precision; graph
        groups on each active column's (k_i, beam_width, n_hops), with the
        legalized fp32 precision in the same slot."""
        cb = predicates.clause_bucket(q.predicates)
        if plan.strategy == "filter_first":
            return ("ff", cb, q.k, plan.max_candidates)
        n = self.table.n_rows
        if plan.strategy == "graph":
            subs = tuple((i, min(plan.subqueries[i].k_mult * q.k, n),
                          plan.beam_width, plan.n_hops)
                         for i in plan_columns(q, plan))
            return ("gr", cb, q.k, subs, "fp32")
        subs = []
        for i in plan_columns(q, plan):
            sp = plan.subqueries[i]
            np0 = min(sp.nprobe, self.indexes[i].n_clusters,
                      self.engine.nprobe_cap)
            subs.append((i, min(sp.k_mult * q.k, n), np0,
                         min(sp.max_scan, n), sp.iterative))
        return ("ix", cb, q.k, tuple(subs), plan.precision)

    def _group_scan(self, key) -> int:
        """Per-query, per-active-column candidate budget of a group — the
        ``scan`` the cost model weighs against ``n_rows``."""
        if key[0] == "ff":
            return int(key[3])
        subs = key[3]
        if key[0] == "gr":
            # the rows a walk can visit: entry points + qualifying seeds +
            # hops · beam · degree
            tot = sum(GRAPH_ENTRY_POINTS + GRAPH_SEED_FACTOR * bw
                      + nh * bw * self.graphs[col].degree
                      for (col, _, bw, nh) in subs)
            return max(1, tot // max(1, len(subs)))
        return max(1, sum(s[3] for s in subs) // max(1, len(subs)))

    # -- execution ---------------------------------------------------------

    def execute_batch(self, queries: list, plans: list, *,
                      scores_b: Optional[tuple] = None) -> list:
        """-> one (ids (k,), scores (k,)) numpy pair per query, in order.

        ``scores_b``: optional per-column (B_bucket, n) dense similarity
        matrices from ``compute_batch_scores`` (row j = queries[j])."""
        if len(queries) != len(plans):
            raise ValueError(f"{len(queries)} queries, {len(plans)} plans")
        plans = [self.legalize(p) for p in plans]
        out: list = [None] * len(queries)
        groups: dict = {}
        for j, (q, p) in enumerate(zip(queries, plans)):
            groups.setdefault(self._group_key(q, p), []).append(j)
        chunk = pow2_at_most(max(1, min(
            MAX_BATCH_KERNEL, SLOT_BUDGET // max(self.table.n_rows, 1))))
        for key, idxs in groups.items():
            for s in range(0, len(idxs), chunk):
                part = idxs[s: s + chunk]
                self._run_chunk(key, [queries[j] for j in part], part, out,
                                bucket_cap=chunk, scores_b=scores_b)
        return out

    # -- cross-shard execution ---------------------------------------------

    def execute_batch_sharded(self, queries: list,
                              plans: Optional[list] = None, *,
                              scores_b: Optional[tuple] = None) -> list:
        """Cross-shard fan-out of a formed batch. -> one (ids (k,), scores
        (k,)) numpy pair per query, in order.

        Without ``plans`` (the exact mode) queries group by (clause bucket,
        k) and every group runs the EXACT sharded scan. With ``plans``
        groups form as in ``execute_batch``: filter_first groups take the
        exact sharded scan, graph groups the single-device walk, and index
        groups are routed by ``ScoringDispatcher.choose_sharded`` to
        per-shard IVF probing (``SHARDED_LOCAL``), the exact sharded scan
        (``DENSE``) or the plain chunk (``SINGLE_DEVICE``)."""
        out: list = [None] * len(queries)
        chunk = pow2_at_most(max(1, min(
            MAX_BATCH_KERNEL, SLOT_BUDGET // max(self.table.n_rows, 1))))
        if plans is None:
            groups: dict = {}
            for j, q in enumerate(queries):
                groups.setdefault(
                    (predicates.clause_bucket(q.predicates), q.k),
                    []).append(j)
            for (_, k), idxs in groups.items():
                for s in range(0, len(idxs), chunk):
                    part = idxs[s: s + chunk]
                    self._run_chunk_sharded(
                        [queries[j] for j in part], part, out, k=k,
                        bucket_cap=chunk, scores_b=scores_b)
            return out
        if len(plans) != len(queries):
            raise ValueError(f"{len(queries)} queries, {len(plans)} plans")
        plans = [self.legalize(p) for p in plans]
        groups = {}
        for j, (q, p) in enumerate(zip(queries, plans)):
            groups.setdefault(self._group_key(q, p), []).append(j)
        for key, idxs in groups.items():
            for s in range(0, len(idxs), chunk):
                part = idxs[s: s + chunk]
                qs = [queries[j] for j in part]
                if key[0] == "ff":
                    self._run_chunk_sharded(qs, part, out, k=key[2],
                                            bucket_cap=chunk,
                                            scores_b=scores_b)
                    continue
                if key[0] == "gr":
                    # the graph is one whole-table adjacency, not a
                    # per-shard structure: the single-device walk
                    self._run_chunk(key, qs, part, out, bucket_cap=chunk,
                                    scores_b=scores_b)
                    continue
                bb = min(next_bucket(len(part)), chunk)
                path = self.dispatcher.choose_sharded(
                    batch=bb, scan=self._group_scan(key),
                    n_shards=self.n_shards,
                    group=("sharded-ivf",) + key[:3],
                    prefer_dense=scores_b is not None)
                if path == SINGLE_DEVICE:
                    self._run_chunk(key, qs, part, out, bucket_cap=chunk,
                                    scores_b=scores_b)
                elif path == SHARDED_LOCAL:
                    self._run_chunk_sharded_ivf(key, qs, part, out,
                                                bucket_cap=chunk)
                else:
                    self._run_chunk_sharded(qs, part, out, k=key[2],
                                            bucket_cap=chunk,
                                            scores_b=scores_b)
        return out

    # -- plan-driven per-shard IVF probing ----------------------------------

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of ``x`` this rank's shard holds (all of them off a
        mesh): a view, never a copy."""
        return x if self.mesh is None else x[self.rows[0]: self.rows[1]]

    def _sivf_col(self, col: int):
        """This executor's per-shard IVF of one column (built on first
        use). Each shard keeps the bound index's FULL cluster count — the
        per-shard slot budget is the global ``max_scan`` split S ways, and
        finer clusters target those fewer slots better. One shard reuses
        the bound index verbatim. On a mesh a rank builds only its own
        shard, from its rows and with the logical path's seed
        ``col + 7919·r``."""
        if col not in self._sivf:
            base = self.indexes[col]
            if self.mesh is None:
                vecs, n_sh, seed = self.table.vectors[col], self.n_shards, col
            else:
                vecs, n_sh = self._local(self.table.vectors[col]), 1
                seed = col + 7919 * self.shard
            self._sivf[col] = build_sharded_ivf(
                vecs, n_sh, n_clusters=base.n_clusters, seed=seed,
                metric=self.table.schema.metric,
                base_index=base if self.n_shards == 1 else None)
        return self._sivf[col]

    def _sivf_fn(self, key, act: tuple):
        """The per-shard probing search of one (group key, active-column
        set), its plan params shard-legalized."""
        fkey = (key, act)
        if fkey not in self._sivf_fns:
            k, subs = key[2], key[3]
            shard_subs, total = [], 0
            for (col, k_i, np0, ms, _it) in subs:
                sivf = self._sivf_col(col)
                k_s, np_s, ms_s = legalize_for_shard(
                    k_i, np0, ms, n_shards=self.n_shards,
                    shard_len=sivf.shard_len, n_clusters=sivf.n_clusters)
                shard_subs.append((act.index(col), k_s,
                                   subquery_width(k_s, ms_s), np_s, ms_s))
                total += k_s
            pad_total = (rrf_union_total(total) if len(shard_subs) > 1
                         else next_bucket(total, CANDIDATE_PAD_FLOOR))
            self._sivf_fns[fkey] = sharded_ivf_topk(
                self.n_shards, self.mesh, self.shard_axes,
                subs=tuple(shard_subs), k=k,
                metric=self.table.schema.metric, pad_total=pad_total)
        return self._sivf_fns[fkey]

    def _run_chunk_sharded_ivf(self, key, qs: list, part: list, out: list,
                               *, bucket_cap: int):
        """One plan-driven sharded group chunk: per-shard IVF probing with
        the group's shard-legalized knobs, the candidate-local rerank
        inside each shard and one O(shards · k) merge — no dense score
        matrix. An int8-precision group scores fp32 here.

        Then per-shard BOUNDARY escalation: on a full merge, a shard whose
        weakest kept score reaches the merged k-th (its probing budget, not
        the data, bound what it surfaced) is flagged; on a merged underfill
        every shard that kept fewer than k is flagged. Flagged shards
        re-run exactly for their queries only (``_escalate_shards``); with
        one shard the boundary carries no signal and is not read. On a
        mesh ``fill`` and ``boundary`` are every shard's, gathered, so
        every rank flags the same shards."""
        t = self.table
        k, subs = key[2], key[3]
        bb = min(next_bucket(len(qs)), bucket_cap)
        pred_b, qv_b, w_b = self._stack_inputs(qs, bb)
        vecs, qsb, wsub, act = self._active_columns(qs, qv_b, w_b)
        sivfs = [self._sivf_col(col) for (col, *_r) in subs]
        ids, scores, fill, bnd = self._sivf_fn(key, act)(
            tuple(s.centroids for s in sivfs),
            tuple(s.sorted_rows for s in sivfs),
            tuple(s.offsets for s in sivfs),
            tuple(self._local(v) for v in vecs), self._local(t.scalars),
            pred_b, qsb, wsub)
        # fill, boundary and the merged result in one transfer
        ids_np, sc_np, fill_np, bnd_np = _to_host(ids, scores, fill, bnd)
        under = (ids_np >= 0).sum(axis=1) < k  # (bb,) merged underfill
        kth = sc_np[:, -1]  # merged k-th score (NEG when underfilled)
        need = under[:, None] & (fill_np < k)
        if fill_np.shape[1] > 1:
            need |= ~under[:, None] & (bnd_np >= kth[:, None])
        need[len(qs):] = False  # padding queries never escalate
        self.escalated.update(part[j] for j in np.flatnonzero(
            need.any(axis=1)))
        if need.any():
            ids, scores = self._escalate_shards(
                ids, scores, need, k=k, pred_b=pred_b, vecs=vecs, qsb=qsb,
                wsub=wsub)
            ids_np, sc_np = _to_host(ids, scores)
        for pos, j in enumerate(part):
            out[j] = (ids_np[pos], sc_np[pos])

    def _escalate_shards(self, ids, scores, need: np.ndarray, *, k: int,
                         pred_b, vecs: tuple, qsb: tuple, wsub):
        """Exact retry on the flagged shard-subset: the escalated queries
        re-run as one dense masked top-k restricted to their flagged
        shards' rows (``_sharded_exact_retry``), and a dedup-by-id merge
        folds the retry into the probed results. Probe-found rows keep
        their probed scores (first occurrence wins), so escalation only
        ADDS rows.

        On a mesh every rank enters the retry's gather, flagged or not: a
        rank takes the masked top-k over its own rows of the queries that
        flag its shard (NEG / -1 for the others), and the merge in shard
        order gives the logical retry's top-k over the allowed rows, ties
        to the smaller global id."""
        t = self.table
        dev = t.device
        sel = np.flatnonzero(need.any(axis=1))
        sel_p = pad_selection(sel)
        sel_pt = torch.as_tensor(sel_p, device=dev)
        need_p = np.array(need[sel_p])
        need_p[len(sel):] = False  # padding rows draw nothing
        retry = (predicates.take(pred_b, sel_p),
                 tuple(q[sel_pt] for q in qsb), wsub[sel_pt])
        if self.mesh is None:
            shard_len = -(-t.n_rows // need.shape[1])
            e_ids, e_sc = _sharded_exact_retry(
                vecs, t.scalars, *retry, torch.as_tensor(need_p, device=dev),
                shard_len=min(shard_len, t.n_rows), k=k,
                metric=t.schema.metric)
        else:
            allow = torch.as_tensor(need_p[:, self.shard, None], device=dev)
            e_ids, e_sc = mesh_topk(
                _allowed_scores(tuple(self._local(v) for v in vecs),
                                self._local(t.scalars), *retry, allow,
                                metric=t.schema.metric),
                self.rows[0], self.mesh, self.shard_axes, k=k)
        cur_ids, cur_sc = merge_topk_unique(
            torch.cat([ids[sel_pt], e_ids], dim=1),
            torch.cat([scores[sel_pt], e_sc], dim=1), k)
        sel_t = torch.as_tensor(sel, device=dev)
        ids, scores = ids.clone(), scores.clone()
        ids[sel_t] = cur_ids[: len(sel)]
        scores[sel_t] = cur_sc[: len(sel)]
        return ids, scores

    def _run_chunk_sharded(self, qs: list, part: list, out: list, *, k: int,
                           bucket_cap: int,
                           scores_b: Optional[tuple] = None):
        """One EXACT sharded group chunk, dispatcher-routed.

        The candidate budget is the chunk's qualifying-row count: when it
        clears the crossover, the chunk gathers and scores only the
        qualifying rows through the fused kernel instead of scanning the
        dense (bb, n) weighted scores. With histograms the gather width is
        a static cap from the selectivity estimates (one scalar read), and
        a query whose true count overflows it re-runs at its exact width
        (``_regather_overflow``); without them one read of the counts sizes
        the gather. Otherwise the per-shard scan over the dense scores
        (``sharded_topk_ref``).

        A mesh pins the chunk to the dense scan (the fan-out is the point
        there; the decision is still recorded): each rank weighs only its
        (bb, n/S) block of the scores and merges through one gather."""
        t = self.table
        bb = min(next_bucket(len(qs)), bucket_cap)
        pred_b, qv_b, w_b = self._stack_inputs(qs, bb)
        if self.mesh is not None:
            self.dispatcher.choose(batch=bb, scan=t.n_rows,
                                   group=("sharded-mesh", k), force=DENSE)
            _, weighted_scores = self._chunk_scores(
                qs, part, bb, qv_b, w_b, scores_b, rows=self.rows)
            out_ids, out_scores = self._shard_fn(k)(
                weighted_scores(), self._local(t.scalars), pred_b)
        else:
            mask = _eval_mask_batch(pred_b, t.scalars)
            prefer_dense = scores_b is not None
            n_qual = None
            estimated = False
            cap = next_bucket(t.n_rows)
            if self.dispatcher.pins_dense(prefer_dense):
                mc = t.n_rows  # candidate-local impossible: skip the read
            elif self.hists is not None:
                est = float(_selectivity_batch(self.hists, pred_b).max()) \
                    * t.n_rows
                mc = min(next_bucket(max(int(np.ceil(est * CAP_MARGIN))
                                         + CAP_SLACK, k, 1)), cap)
                estimated = mc < cap
            else:
                n_qual = mask.sum(dim=1).cpu().numpy()
                mc = min(next_bucket(max(int(n_qual.max()), k, 1)), cap)
            path = self.dispatcher.choose(batch=bb, scan=mc,
                                          group=("sharded", k),
                                          prefer_dense=prefer_dense)
            if path == CANDIDATE_LOCAL:
                vecs, qsb, wsub, _ = self._active_columns(qs, qv_b, w_b)
                out_ids, out_scores, _ = _gather_rerank_batch(
                    _qualifying_rows_batch(mask, size=mc), vecs, qsb, wsub,
                    t.scalars, k=k, metric=t.schema.metric)
                if estimated:
                    if n_qual is None:
                        n_qual = mask.sum(dim=1).cpu().numpy()
                    over = np.flatnonzero(n_qual[: len(qs)] > mc)
                    if over.size:
                        out_ids, out_scores = self._regather_overflow(
                            mask, n_qual, over, out_ids, out_scores, vecs, qsb,
                            wsub, k=k)
            else:
                _, weighted_scores = self._chunk_scores(qs, part, bb, qv_b, w_b,
                                                        scores_b)
                out_ids, out_scores = sharded_topk_ref(
                    weighted_scores(), mask, k=k, n_shards=self.n_shards)
        ids_np, scores_np = _to_host(out_ids, out_scores)
        for pos, j in enumerate(part):
            out[j] = (ids_np[pos], scores_np[pos])

    def _shard_fn(self, k: int):
        """The mesh's exact sharded scan, one per k."""
        if k not in self._shard_fns:
            self._shard_fns[k] = sharded_batch_topk(
                self.mesh, self.shard_axes, k=k)
        return self._shard_fns[k]

    def _regather_overflow(self, mask, n_qual: np.ndarray, over: np.ndarray,
                           out_ids, out_scores, vecs, qsb, wsub, *, k: int):
        """Overflow escalation of the histogram-capped exact gather: the
        queries whose true qualifying count exceeded the cap re-run at
        their exact width, so an under-shooting estimate never drops
        rows."""
        t = self.table
        sel_pt = torch.as_tensor(pad_selection(over), device=t.device)
        mc2 = min(next_bucket(max(int(n_qual[over].max()), k, 1)),
                  next_bucket(t.n_rows))
        ids2, sc2, _ = _gather_rerank_batch(
            _qualifying_rows_batch(mask[sel_pt], size=mc2), vecs,
            tuple(q[sel_pt] for q in qsb), wsub[sel_pt], t.scalars, k=k,
            metric=t.schema.metric)
        sel_t = torch.as_tensor(over, device=t.device)
        out_ids, out_scores = out_ids.clone(), out_scores.clone()
        out_ids[sel_t] = ids2[: len(over)]
        out_scores[sel_t] = sc2[: len(over)]
        return out_ids, out_scores

    def _stack_inputs(self, qs: list, bb: int):
        """Batch inputs padded (by repeating the first query) to bucket bb."""
        qpad = qs + [qs[0]] * (bb - len(qs))
        pred_b = predicates.stack([q.predicates for q in qpad])
        qv_b = tuple(torch.stack([q.query_vectors[i] for q in qpad])
                     for i in range(self.table.schema.n_vec))
        w_b = torch.as_tensor(np.asarray([q.weights for q in qpad],
                                         np.float32), device=self.table.device)
        return pred_b, qv_b, w_b

    def _chunk_scores(self, qs: list, part: list, bb: int, qv_b: tuple, w_b,
                      scores_b: Optional[tuple], rows: Optional[tuple] = None):
        """(col_scores, weighted_scores) closures for one chunk, gathering
        rows of the whole-batch dense matrices when ``scores_b`` is given.
        ``rows`` (row0, row1): score only those table rows (a mesh rank's
        own; its columns of ``scores_b``)."""
        t = self.table
        r0, r1 = (0, t.n_rows) if rows is None else rows
        w_np = np.asarray([q.weights for q in qs], np.float32)
        cache: dict = {}
        rows_idx = torch.as_tensor(part + [part[0]] * (bb - len(part)),
                                   device=t.device) \
            if scores_b is not None else None

        def col_scores(i):
            if i not in cache:
                cache[i] = scores_b[i][:, r0: r1][rows_idx] \
                    if scores_b is not None \
                    else similarity_batch(qv_b[i], t.vectors[i][r0: r1],
                                          t.schema.metric)
            return cache[i]

        def weighted_scores():
            """Σ_i w_i · sim_i over every column some query weights."""
            ws = None
            for i in range(t.schema.n_vec):
                if not np.any(np.abs(w_np[:, i]) > 0):
                    continue  # exact: a zero weight contributes exactly 0
                s = w_b[:, i, None] * col_scores(i)
                ws = s if ws is None else ws + s
            return ws if ws is not None \
                else torch.zeros((bb, r1 - r0), device=t.device)

        return col_scores, weighted_scores

    def _run_chunk(self, key, qs: list, part: list, out: list, *,
                   bucket_cap: int, scores_b: Optional[tuple] = None):
        t = self.table
        bb = min(next_bucket(len(qs)), bucket_cap)
        precision = key[4] if key[0] in ("ix", "gr") else "fp32"
        # graph groups have no dense variant: the walk touches
        # O(hops·beam·degree) rows, a (B, n) score matrix buys nothing
        path = self.dispatcher.choose(
            batch=bb, scan=self._group_scan(key), group=key[:3],
            force=CANDIDATE_LOCAL if key[0] == "gr" else None,
            prefer_dense=scores_b is not None, precision=precision)
        pred_b, qv_b, w_b = self._stack_inputs(qs, bb)

        if path == CANDIDATE_LOCAL:
            out_ids, out_scores = self._run_chunk_local(key, qs, pred_b,
                                                        qv_b, w_b)
        else:
            col_scores, weighted_scores = self._chunk_scores(
                qs, part, bb, qv_b, w_b, scores_b)
            if key[0] == "ff":
                _, _, k, mc = key
                out_ids, out_scores, _, _ = _filter_first_batch(
                    weighted_scores(), t.scalars, pred_b, k=k,
                    max_candidates=mc)
            else:
                k, subs = key[2], key[3]
                cand = [self._batched_subquery(col, col_scores(col), pred_b,
                                               qv_b[col], k_i, np0, ms, it)
                        for (col, k_i, np0, ms, it) in subs]
                rows_b = self._union_candidates(cand, subs)
                out_ids, out_scores = _rerank_batch(weighted_scores(), rows_b,
                                                    k=k)
        ids_np, scores_np = out_ids.cpu().numpy(), out_scores.cpu().numpy()
        for pos, j in enumerate(part):
            out[j] = (ids_np[pos], scores_np[pos])

    def _run_chunk_local(self, key, qs: list, pred_b, qv_b, w_b):
        """Candidate-local execution of one group chunk: only the legalized
        candidate budget is gathered and scored — subqueries through
        ``ivf.search_local_batch`` (or its int8 two-stage variant) and the
        rerank / filter-first through the fused gather+score kernel."""
        t = self.table
        if key[0] == "ff":
            _, _, k, mc = key
            out_ids, out_scores, _, _ = flat.filter_first_local_batch(
                tuple(t.vectors), t.scalars, pred_b, qv_b, w_b, k=k,
                max_candidates=mc, n_vec=t.schema.n_vec,
                metric=t.schema.metric)
            return out_ids, out_scores
        k, subs, precision = key[2], key[3], key[4]
        if key[0] == "gr":
            cand = [self._graph_subquery(col, pred_b, qv_b[col], k_i, bw, nh)
                    for (col, k_i, bw, nh) in subs]
        else:
            cand = [self._batched_subquery(col, None, pred_b, qv_b[col], k_i,
                                           np0, ms, it, local=True,
                                           precision=precision)
                    for (col, k_i, np0, ms, it) in subs]
        rows_b = self._union_candidates(cand, subs)
        vecs, qsb, wsub, _ = self._active_columns(qs, qv_b, w_b)
        out_ids, out_scores, _ = _gather_rerank_batch(
            rows_b.to(torch.int32), vecs, qsb, wsub, t.scalars, k=k,
            metric=t.schema.metric)
        return out_ids, out_scores

    def _active_columns(self, qs: list, qv_b: tuple, w_b):
        """Restrict (vectors, queries, weights) to columns some query in the
        chunk weights — a zero weight contributes exactly 0."""
        w_np = np.asarray([q.weights for q in qs], np.float32)
        act = tuple(i for i in range(self.table.schema.n_vec)
                    if np.any(np.abs(w_np[:, i]) > 0))
        vecs = tuple(self.table.vectors[i] for i in act)
        qsb = tuple(qv_b[i] for i in act)
        wsub = w_b[:, list(act)].contiguous()
        return vecs, qsb, wsub, act

    @staticmethod
    def _pad_candidates(cand: list) -> torch.Tensor:
        """Concat per-column candidate ids and pad the union to a
        power-of-two bucket (-1 = empty slot)."""
        rows_b = torch.cat(cand, dim=1)
        total = next_bucket(rows_b.shape[1], CANDIDATE_PAD_FLOOR)
        if total > rows_b.shape[1]:
            rows_b = torch.cat([rows_b, torch.full(
                (rows_b.shape[0], total - rows_b.shape[1]), -1,
                dtype=rows_b.dtype, device=rows_b.device)], dim=1)
        return rows_b

    def _union_candidates(self, cand_wide: list, subs) -> torch.Tensor:
        """Candidate union of one ix-group chunk: each column's exact top-k_i
        block, then for multi-column groups RRF-fused extras from the
        probed tails filling the padded bucket."""
        kis = tuple(s[1] for s in subs)
        cand = [cw[:, :ki] for cw, ki in zip(cand_wide, kis)]
        if len(cand_wide) < 2:
            return self._pad_candidates(cand)
        base = torch.cat(cand, dim=1)
        sum_ki = base.shape[1]
        extras = rrf_extras(tuple(cand_wide), kis=kis,
                            n_extra=rrf_union_total(sum_ki) - sum_ki)
        return torch.cat([base, extras.to(base.dtype)], dim=1)

    def _graph_subquery(self, col: int, pred_b, q_b, k_i: int,
                        beam_width: int, n_hops: int):
        """One column's graph walk for the whole chunk: ranked candidate ids
        at the padded probe width (bb, ks), ks ≥ k_i, the contract of
        ``_batched_subquery``. No re-expansion: the walk's budget is fixed
        by (beam_width, n_hops)."""
        t = self.table
        ks = subquery_width(k_i, t.n_rows)
        ids, _, _, _ = graph.search_local_batch(
            self.graphs[col], t.vectors[col], t.scalars, pred_b, q_b,
            beam_width=beam_width, n_hops=n_hops, k=ks)
        return ids

    def _batched_subquery(self, col: int, rs_b, pred_b, q_b, k_i: int,
                          nprobe: int, max_scan: int, iterative: bool, *,
                          local: bool = False, precision: str = "fp32"):
        """One column's filtered subquery for the whole chunk, with grouped
        iterative re-expansion. Returns ranked candidate ids at the padded
        probe width (bb, ks), ks ≥ k_i.

        Dense mode reuses ``rs_b`` (bb, n) scores across rounds;
        candidate-local mode re-gathers through the kernel. Each round
        narrows to the still-underfilled subset (padded to its own bucket);
        one host sync per round reads the qualified counts."""
        t, index = self.table, self.indexes[col]
        cap = min(index.n_clusters, self.engine.nprobe_cap)
        ks = subquery_width(k_i, max_scan)

        def probe(np_, pred, qb, rs):
            if local and precision == "int8":
                vq, sc = t.quantized(col)
                ids_, _, _, nq = ivf.search_local_batch_int8(
                    index, t.vectors[col], vq, sc, t.scalars, pred, qb,
                    nprobe=np_, max_scan=max_scan, k=ks)
            elif local:
                ids_, _, _, nq = ivf.search_local_batch(
                    index, t.vectors[col], t.scalars, pred, qb,
                    nprobe=np_, max_scan=max_scan, k=ks)
            else:
                ids_, _, _, nq = _search_batch(
                    index, rs, t.scalars, pred, qb,
                    nprobe=np_, max_scan=max_scan, k=ks)
            return ids_, nq

        ids, n_qual = probe(nprobe, pred_b, q_b, rs_b)
        if not iterative:
            return ids
        done = n_qual.cpu().numpy() >= k_i  # ONE host sync per group round
        while not done.all() and nprobe < cap:
            nprobe = min(2 * nprobe, cap)
            sel = np.flatnonzero(~done)
            sel_p = pad_selection(sel)
            sel_pt = torch.as_tensor(sel_p, device=t.device)
            ids2, nq2 = probe(nprobe, predicates.take(pred_b, sel_p),
                              q_b[sel_pt],
                              rs_b[sel_pt] if rs_b is not None else None)
            ids = ids.clone()
            ids[torch.as_tensor(sel, device=t.device)] = ids2[: len(sel)]
            # boomlint: ignore[HS001] one sync per re-expansion round is
            # the iterative contract (the round count is the doubling
            # ladder, not the batch size — same shape as
            # HybridExecutor._subquery)
            done[sel] = nq2.cpu().numpy()[: len(sel)] >= k_i
        return ids


# ---------------------------------------------------------------------------
# serving front-end
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeReport:
    n_queries: int
    n_batches: int
    seconds: float
    qps: float
    mean_recall: Optional[float] = None
    recalls: Optional[list] = None
    # async deadline-aware serving (serve/queue.py): dispositions, latency
    n_timed_out: int = 0
    p50_ms: Optional[float] = None
    p99_ms: Optional[float] = None
    # per-group scoring-path dispatch counts ({"dense": .., "candidate_local": ..})
    path_counts: Optional[dict] = None
    # tiered streaming ingest (vectordb/tiered.py): rows inserted, hot→cold
    # compactions completed, and the cold epoch at report time
    n_inserted: int = 0
    n_compactions: int = 0
    epoch: int = 0
    # semantic result cache (serve/semcache.py): requests resolved at
    # submit time without execution
    n_cache_hits: int = 0
    # multi-tenant serving: {tenant_id: {n_queries, n_ok, n_timed_out,
    # n_cache_hits, mean_recall, qps}}; the None key is untenanted traffic
    tenants: Optional[dict] = None

    def describe(self) -> str:
        rec = f", mean recall {self.mean_recall:.3f}" \
            if self.mean_recall is not None else ""
        lat = f", p50 {self.p50_ms:.1f}ms / p99 {self.p99_ms:.1f}ms" \
            if self.p50_ms is not None and self.p99_ms is not None else ""
        to = f", {self.n_timed_out} timed out" if self.n_timed_out else ""
        paths = ""
        if self.path_counts:
            paths = ", paths " + "/".join(
                f"{name}×{cnt}" for name, cnt in sorted(
                    self.path_counts.items()))
        ingest = f", {self.n_inserted} inserted over {self.n_compactions} " \
            f"compactions (epoch {self.epoch})" if self.n_inserted else ""
        cache = f", {self.n_cache_hits} cache hits" if self.n_cache_hits \
            else ""
        tnt = f", {len(self.tenants)} tenants" \
            if self.tenants and len(self.tenants) > 1 else ""
        return (f"{self.n_queries} queries in {self.seconds:.2f}s over "
                f"{self.n_batches} batches ({self.qps:.1f} QPS{rec}{lat}{to}"
                f"{paths}{ingest}{cache}{tnt})")


class ServingEngine:
    """Deployment-shaped batched serving over a fitted ``BoomHQ``: each
    batch costs one batched optimizer pass and one grouped execution pass.
    Runs on the device of the BoomHQ's table."""

    def __init__(self, boomhq, *, batch_size: int = 32):
        self.bq = boomhq
        self.batch_size = batch_size

    def warmup(self, queries: list) -> None:
        """One untimed batch (allocator and library warm-up)."""
        if queries:
            self.bq.execute_batch(list(queries[: self.batch_size]))

    def serve(self, queries: list, *, gt_ids=None) -> tuple:
        """Run the stream in batches. ``gt_ids`` (optional, one ground-truth
        id array per query) enables recall accounting."""
        dispatcher = self.bq._batched_executor().dispatcher
        dispatcher.take()  # drop warmup decisions from the report
        results: list = []
        n_batches = 0
        synchronize(self.bq.table.device)
        t0 = time.perf_counter()
        for s in range(0, len(queries), self.batch_size):
            results.extend(self.bq.execute_batch(
                queries[s: s + self.batch_size]))
            n_batches += 1
        seconds = time.perf_counter() - t0  # results are host arrays
        recalls = None
        if gt_ids is not None:
            recalls = [recall_at_k(ids, gt)
                       for (ids, _), gt in zip(results, gt_ids)]
        counts = dispatcher.take()[0]
        report = ServeReport(
            n_queries=len(queries), n_batches=n_batches, seconds=seconds,
            qps=len(queries) / max(seconds, 1e-9),
            mean_recall=float(np.mean(recalls)) if recalls is not None
            else None,
            recalls=recalls, path_counts=counts or None)
        return results, report
