"""MHQ execution engine: the strategies + two-phase multi-vector flow.

Port of ``repro.core.executor``:
  * filter_first  — evaluate Q_S over all rows, gather ≤ max_candidates
                    qualifying rows, score only those;
  * index_scan    — one single-vector filtered IVF subquery per column
                    (k_i, nprobe, max_scan, iterative), union the
                    candidates, re-rank by the full weighted score;
  * single_index  — skewed weights: search only the dominant column;
  * graph         — one predicate-aware beam walk per column over its
                    proximity graph (``vectordb.graph``), then the same
                    union and re-rank as index_scan.

Without bound graphs ``legalize`` rewrites graph plans to ``index_scan``.
``iterative`` is pgvector's iterative_scan: nprobe doubling while the
filtered result underfills k (one host sync per round).
``legalize_for_shard`` splits a subquery's budget across logical shards
(``serve.batch``'s sharded probing path).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.common.device import synchronize
from repro_torch.core.query import (
    BEAM_GRID, ExecutionPlan, HOP_GRID, MHQ, PRECISION_GRID, SubqueryParams,
)
from repro_torch.kernels.shapes import NEG
from repro_torch.vectordb import flat, graph, ivf, predicates
from repro_torch.vectordb.flat import topk_stable
from repro_torch.vectordb.table import Table, similarity

K_BUCKET_FLOOR = 16  # smallest padded top-k bucket
CANDIDATE_PAD_FLOOR = 64  # smallest padded candidate-slot bucket


def next_bucket(n: int, floor: int = 1) -> int:
    """Smallest power-of-two bucket ≥ n (≥ floor)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def pow2_at_most(n: int) -> int:
    b = 1
    while b * 2 <= n:
        b <<= 1
    return b


@dataclasses.dataclass(frozen=True)
class EngineCaps:
    """What the underlying engine exposes (paper §5 setup / §5.4)."""
    name: str
    max_scan_tuples: bool = True
    iterative_scan: bool = True
    per_column_params: bool = True  # can k_i / nprobe differ per column?
    nprobe_cap: int = 64
    default_max_scan: int = 32768


PGVECTOR = EngineCaps("pgvector")
MILVUS = EngineCaps("milvus", max_scan_tuples=False, iterative_scan=False)
OPENSEARCH = EngineCaps("opensearch", max_scan_tuples=False,
                        iterative_scan=False)
ENGINES = {e.name: e for e in (PGVECTOR, MILVUS, OPENSEARCH)}


def _dedup_topk(rows: torch.Tensor, score: torch.Tensor, *, k: int):
    """Top-k over candidate scores with duplicate row ids suppressed by
    keeping only the first occurrence. rows: (..., total), -1 = empty."""
    valid = rows >= 0
    order = torch.argsort(rows, dim=-1, stable=True)
    sorted_rows = rows.gather(-1, order)
    first = torch.cat([torch.ones_like(sorted_rows[..., :1], dtype=torch.bool),
                       sorted_rows[..., 1:] != sorted_rows[..., :-1]], dim=-1)
    keep = torch.zeros_like(first).scatter(-1, order, first) & valid
    masked = torch.where(keep, score, torch.full_like(score, NEG))
    top_s, top_i = topk_stable(masked, k)
    ids = torch.where(top_s > NEG / 2, rows.gather(-1, top_i),
                      torch.full_like(top_i, -1))
    return ids.to(torch.int32), top_s


def _rerank(vectors, rows, qs, w, *, k, n_vec, metric):
    """Re-rank the union of candidate rows (total,) by the full weighted
    score (-1 = empty slot)."""
    n = vectors[0].shape[0]
    rows = rows.to(torch.int64)
    rows_c = torch.clamp(rows, 0, n - 1)
    score = torch.zeros(rows.shape, device=rows.device)
    for i in range(n_vec):
        score = score + w[i] * similarity(qs[i], vectors[i][rows_c], metric)
    return _dedup_topk(rows, score, k=k)


def rerank_scored(row_scores, rows, *, k):
    """``_rerank`` with the full weighted row scores precomputed.
    row_scores (..., n), rows (..., total)."""
    n = row_scores.shape[-1]
    rows = rows.to(torch.int64)
    score = row_scores.gather(-1, torch.clamp(rows, 0, n - 1))
    return _dedup_topk(rows, score, k=k)


# Reciprocal-rank fusion across per-column candidate lists: the union keeps
# each column's exact top-k_i block and fills its pad bucket with the rows
# the combined column rankings like best: Σ_cols 1/(RRF_K + rank_col(row)).
RRF_K = 60  # standard reciprocal-rank-fusion constant
RRF_MIN_EXTRA = 16  # fused-extra slots guaranteed per multi-column union


def rrf_union_total(sum_ki: int) -> int:
    """Static union width for a multi-column candidate union."""
    return next_bucket(sum_ki + RRF_MIN_EXTRA, CANDIDATE_PAD_FLOOR)


def subquery_width(k_i: int, max_scan: int) -> int:
    """Probe width of one column's subquery: the padded top-k bucket."""
    return min(next_bucket(k_i, K_BUCKET_FLOOR), max_scan)


def rrf_extras(lists, *, kis, n_extra, rrf_k=RRF_K):
    """Top-``n_extra`` candidates by reciprocal-rank fusion of the columns'
    ranked lists, excluding rows already in some column's top-k_i block.

    ``lists``: per-column (B, ks_i) ranked candidate ids, -1 = empty (each
    column's full probed ranking). Returns (B, n_extra) int32 ids, -1
    padded, ranked by (-fused score, row id): equal fusions break by the
    smaller id. Each row's contributions are summed in ascending order, so
    two rows with the same multiset of ranks fuse to the identical float
    and the id rule, not rounding, decides between them."""
    sc_parts, inc_parts = [], []
    for lst, ki in zip(lists, kis):
        valid = lst >= 0
        ranks = torch.arange(lst.shape[1], dtype=torch.float32,
                             device=lst.device)
        contrib = 1.0 / (rrf_k + 1.0 + ranks)
        sc_parts.append(torch.where(valid, contrib[None, :],
                                    torch.zeros_like(contrib)[None, :]))
        inc_parts.append(valid & (ranks < ki)[None, :])
    rows = torch.cat([lst.to(torch.int64) for lst in lists], dim=1)
    sc = torch.cat(sc_parts, dim=1)
    inc = torch.cat(inc_parts, dim=1)
    # order by (row id, contribution): two stable sorts
    o1 = torch.argsort(sc, dim=1, stable=True)
    o2 = torch.argsort(rows.gather(1, o1), dim=1, stable=True)
    order = o1.gather(1, o2)
    rs, cs, ins = rows.gather(1, order), sc.gather(1, order), \
        inc.gather(1, order)
    b, t = rs.shape
    seg_start = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                      device=rs.device),
                           rs[:, 1:] != rs[:, :-1]], dim=1)
    # a row occurs at most once per column: sum its ≤ len(lists) slots in
    # order from the segment start
    fused = cs.clone()
    included = ins.clone()
    for j in range(1, len(lists)):
        if j >= t:
            break
        same = rs[:, j:] == rs[:, :-j]
        fused[:, :-j] = fused[:, :-j] + torch.where(
            same, cs[:, j:], torch.zeros_like(cs[:, j:]))
        included[:, :-j] = included[:, :-j] | (same & ins[:, j:])
    fused = torch.where(seg_start & (rs >= 0) & ~included, fused,
                        torch.full_like(fused, -1.0))
    ne = min(n_extra, t)
    # segment starts are in ascending row-id order, so a stable sort on
    # -fused breaks equal fusions by the smaller id
    top_s, top_j = topk_stable(fused, ne)
    out = torch.where(top_s > 0.0, rs.gather(1, top_j),
                      torch.full_like(top_j, -1))
    if ne < n_extra:
        out = torch.cat([out, torch.full((b, n_extra - ne), -1,
                                         dtype=out.dtype, device=out.device)],
                        dim=1)
    return out.to(torch.int32)


def legalize_for_shard(k_i: int, nprobe: int, max_scan: int, *,
                       n_shards: int, shard_len: int,
                       n_clusters: int) -> tuple:
    """Split one subquery's GLOBAL probing budget across ``n_shards``: the
    scan budget divides ceil-wise (floored at the per-shard candidate
    count, capped at the shard), nprobe clamps to the per-shard cluster
    count. -> the per-shard ``(k_i, nprobe, max_scan)``."""
    ms = min(shard_len, max(1, min(k_i, shard_len), -(-max_scan // n_shards)))
    return min(k_i, ms), max(1, min(nprobe, n_clusters)), ms


def plan_columns(q: MHQ, plan: ExecutionPlan) -> tuple:
    """Vector columns a plan actually searches (shared by the sequential and
    batched executors so candidate generation can never drift)."""
    if plan.strategy == "single_index":
        return (plan.dominant,)
    return tuple(i for i in range(q.n_vec) if q.weights[i] > 0.0)


def legal_knob(grid: tuple, value: int) -> int:
    """Smallest grid entry ≥ value (grid max when none)."""
    for g in grid:
        if g >= value:
            return g
    return grid[-1]


class HybridExecutor:
    """Binds a table + per-column IVF indexes + an engine personality.

    ``graphs``: optional per-column ``vectordb.graph.GraphIndex`` tuple —
    when bound, plans may pick the "graph" strategy; when absent,
    legalization rewrites graph plans to index_scan."""

    def __init__(self, table: Table, indexes: list,
                 engine: EngineCaps = PGVECTOR, *, graphs=None):
        self.table = table
        self.indexes = indexes
        self.engine = engine
        self.graphs = tuple(graphs) if graphs is not None else None

    # -- plan legalization ---------------------------------------------------

    def legalize(self, plan: ExecutionPlan) -> ExecutionPlan:
        """Clamp a plan to what the engine personality supports, and every
        candidate budget to the table."""
        e = self.engine
        subs = []
        base = plan.subqueries[0]
        for s in plan.subqueries:
            if not e.per_column_params:
                s = dataclasses.replace(s, k_mult=base.k_mult,
                                        nprobe=base.nprobe)
            if not e.max_scan_tuples:
                s = dataclasses.replace(s, max_scan=e.default_max_scan)
            if not e.iterative_scan:
                s = dataclasses.replace(s, iterative=False)
            s = dataclasses.replace(s, nprobe=min(s.nprobe, e.nprobe_cap))
            subs.append(s)
        prec = plan.precision if plan.precision in PRECISION_GRID else "fp32"
        if plan.strategy == "filter_first":
            prec = "fp32"
        strategy = plan.strategy
        beam, hops = plan.beam_width, plan.n_hops
        if strategy == "graph":
            if self.graphs is None:
                strategy = "index_scan"
            else:
                # graph candidates come from the fp32 walk and one fused
                # extraction: there is no int8 candidate tier
                prec = "fp32"
                beam = legal_knob(BEAM_GRID, beam)
                hops = legal_knob(HOP_GRID, hops)
        return dataclasses.replace(
            plan, strategy=strategy, subqueries=tuple(subs), precision=prec,
            beam_width=beam, n_hops=hops,
            max_candidates=min(plan.max_candidates, self.table.n_rows))

    # -- execution -------------------------------------------------------------

    def execute(self, q: MHQ, plan: ExecutionPlan):
        """-> (ids (k,) int32, scores (k,)) tensors on the table's device."""
        plan = self.legalize(plan)
        t = self.table
        w = torch.as_tensor(q.weights, dtype=torch.float32, device=t.device)
        if plan.strategy == "filter_first":
            ids, scores, _, _ = flat.filter_first(
                tuple(t.vectors), t.scalars, q.predicates,
                tuple(q.query_vectors), w, t.schema.metric,
                k=q.k, max_candidates=plan.max_candidates, n_vec=q.n_vec)
            return ids, scores

        cols = plan_columns(q, plan)
        cand, wide = [], []
        for i in cols:
            sp = plan.subqueries[i]
            k_i = min(sp.k_mult * q.k, t.n_rows)
            ks = subquery_width(k_i, min(sp.max_scan, t.n_rows)) \
                if len(cols) > 1 else k_i
            if plan.strategy == "graph":
                # the walk's list is already filtered and ranked, so it
                # joins the same union and re-rank as an IVF subquery
                ids_i, _, _, _ = graph.search(
                    self.graphs[i], t.vectors[i], t.scalars, q.predicates,
                    q.query_vectors[i], beam_width=plan.beam_width,
                    n_hops=plan.n_hops, k=ks)
            else:
                ids_i = self._subquery(i, q, k_i, sp,
                                       precision=plan.precision, width=ks)
            wide.append(ids_i)
            cand.append(ids_i[:k_i])
        rows = torch.cat(cand)
        if len(cols) > 1:
            # multi-column union: RRF-fused extras from the probed tails
            kis = tuple(int(c.shape[0]) for c in cand)
            total = rrf_union_total(int(rows.shape[0]))
            extras = rrf_extras(tuple(wd[None, :] for wd in wide), kis=kis,
                                n_extra=total - int(rows.shape[0]))
            rows = torch.cat([rows, extras[0]])
        return _rerank(tuple(t.vectors), rows, tuple(q.query_vectors), w,
                       k=q.k, n_vec=q.n_vec, metric=t.schema.metric)

    def _subquery(self, i: int, q: MHQ, k_i: int, sp: SubqueryParams,
                  precision: str = "fp32", width: int | None = None):
        """One single-vector filtered subquery, with iterative re-expansion.
        ``width`` (≥ k_i) widens the returned ranked list for RRF fusion;
        ``precision == "int8"`` scores the same slots from the int8 replica
        and exact-reranks the survivors (batch-1 candidate-local path)."""
        t = self.table
        kw = width or k_i
        nprobe = sp.nprobe
        while True:
            nprobe = min(nprobe, self.indexes[i].n_clusters,
                         self.engine.nprobe_cap)
            max_scan = min(sp.max_scan, t.n_rows)
            if precision == "int8":
                vq, sc = t.quantized(i)
                ids_b, _, _, nq_b = ivf.search_local_batch_int8(
                    self.indexes[i], t.vectors[i], vq, sc, t.scalars,
                    predicates.stack([q.predicates]),
                    q.query_vectors[i][None, :],
                    nprobe=nprobe, max_scan=max_scan, k=kw)
                ids, n_qual = ids_b[0], nq_b[0]
            else:
                ids, _, _, n_qual = ivf.search(
                    self.indexes[i], t.vectors[i], t.scalars, q.predicates,
                    q.query_vectors[i], nprobe=nprobe, max_scan=max_scan,
                    k=kw)
            if not sp.iterative:
                return ids
            # boomlint: ignore[HS001] one sync per re-expansion round is the
            # sequential iterative_scan contract (the batched path amortizes
            # it per group — serve/batch._batched_subquery)
            if int(n_qual) >= k_i or nprobe >= min(self.indexes[i].n_clusters,
                                                   self.engine.nprobe_cap):
                return ids
            nprobe *= 2

    # -- measured execution ----------------------------------------------------

    def execute_timed(self, q: MHQ, plan: ExecutionPlan, *, repeats: int = 1):
        """Returns (ids, scores, seconds) as numpy + host seconds; the first
        call warms, the timed calls end in a device synchronize."""
        dev = self.table.device
        ids, scores = self.execute(q, plan)
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            ids, scores = self.execute(q, plan)
            synchronize(dev)
        dt = (time.perf_counter() - t0) / repeats
        return ids.cpu().numpy(), scores.cpu().numpy(), dt


def recall_at_k(ids, gt_ids) -> float:
    ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else ids
    gt_ids = gt_ids.cpu().numpy() if isinstance(gt_ids, torch.Tensor) \
        else gt_ids
    got = set(int(i) for i in np.asarray(ids) if i >= 0)
    gt = [int(i) for i in np.asarray(gt_ids) if i >= 0]
    if not gt:
        return 1.0
    return len(got.intersection(gt)) / len(gt)
