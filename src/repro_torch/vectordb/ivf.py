"""IVF-Flat index: k-means clustering + probe-based search.

Port of ``repro.vectordb.ivf``. ``nprobe`` plays ``ef_search``,
``max_scan`` caps the gathered candidate count and ``iterative_scan`` is
nprobe re-expansion on underfill. The probed clusters' rows map onto a
fixed ``max_scan`` slot array by a prefix sum + ``searchsorted``, so every
search has a static shape. Functions named ``*_batch`` take a leading
query axis (the JAX package's ``vmap``), and so do ``preprobe`` and
``preprobe_scored``, whose only caller is the batched feature pass.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.shapes import NEG
from repro_torch.vectordb.flat import topk_stable
from repro_torch.vectordb.predicates import PredicateLike, eval_mask
from repro_torch.vectordb.table import similarity, similarity_batch


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor  # (C, d)
    sorted_rows: torch.Tensor  # (n,) int32 — row ids grouped by cluster
    offsets: torch.Tensor  # (C+1,) int32 — cluster c owns sorted_rows[offsets[c]:offsets[c+1]]
    metric: str

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def _assign(vectors: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    d = (cent * cent).sum(1)[None, :] - 2.0 * (vectors @ cent.T)
    return torch.argmin(d, dim=1)


def _kmeans(vectors: torch.Tensor, generator: torch.Generator,
            n_clusters: int, iters: int = 12):
    n = vectors.shape[0]
    idx = torch.randperm(n, generator=generator)[:n_clusters]
    cent = vectors[idx.to(vectors.device)]
    for _ in range(iters):
        assign = _assign(vectors, cent)
        counts = torch.bincount(assign, minlength=n_clusters).to(
            torch.float32)
        sums = torch.zeros_like(cent).index_add_(0, assign, vectors)
        newc = sums / torch.clamp(counts[:, None], min=1.0)
        # dead centroids keep their old position
        cent = torch.where(counts[:, None] > 0, newc, cent)
    return cent, _assign(vectors, cent)


def build(vectors: torch.Tensor, n_clusters: int, seed: int = 0,
          iters: int = 12, metric: str = "dot") -> IVFIndex:
    """k-means from ``n_clusters`` distinct rows drawn by a seeded
    ``torch.Generator``; rows regrouped by cluster (stable)."""
    gen = torch.Generator().manual_seed(seed)
    cent, assign = _kmeans(vectors, gen, n_clusters, iters)
    order = torch.argsort(assign, stable=True).to(torch.int32)
    counts = torch.bincount(assign, minlength=n_clusters)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=vectors.device),
                         torch.cumsum(counts, 0)]).to(torch.int32)
    return IVFIndex(centroids=cent, sorted_rows=order, offsets=offsets,
                    metric=metric)


# Below this fraction of the existing rows an insert takes the incremental
# splice (one O(n + m) np.insert, no sort) instead of the full regroup.
EXTEND_INCREMENTAL_FRACTION = 0.25


def _assign_to_centroids(index: IVFIndex, new_vectors: torch.Tensor
                         ) -> np.ndarray:
    """Nearest centroid of each new row by L2 (``‖c‖² − 2 v·c``, for either
    metric, as k-means assigned the built rows). -> (m,) int64."""
    return _assign(new_vectors, index.centroids).cpu().numpy()


def _with_layout(index: IVFIndex, sorted_rows: np.ndarray,
                 offsets: np.ndarray) -> IVFIndex:
    dev = index.sorted_rows.device
    return IVFIndex(
        centroids=index.centroids,
        sorted_rows=torch.as_tensor(sorted_rows.astype(np.int32), device=dev),
        offsets=torch.as_tensor(offsets.astype(np.int32), device=dev),
        metric=index.metric)


def _extend_regroup(index: IVFIndex, assign: np.ndarray,
                    rows: np.ndarray) -> IVFIndex:
    """One stable sort of [old assignments ‖ new assignments]: each
    cluster keeps its rows in order and gets its new rows, in insertion
    order, behind them."""
    old_rows = index.sorted_rows.cpu().numpy()
    old_off = index.offsets.cpu().numpy()
    c = index.n_clusters
    old_assign = np.repeat(np.arange(c), np.diff(old_off))
    all_assign = np.concatenate([old_assign, assign])
    all_rows = np.concatenate([old_rows, rows]).astype(np.int32)
    order = np.argsort(all_assign, kind="stable")
    counts = np.bincount(all_assign, minlength=c)
    return _with_layout(index, all_rows[order],
                        np.concatenate([[0], np.cumsum(counts)]))


def _extend_incremental(index: IVFIndex, assign: np.ndarray,
                        rows: np.ndarray) -> IVFIndex:
    """Splice each new row in at the END of its cluster's segment
    (``np.insert`` is stable at equal positions, so rows sharing a cluster
    keep insertion order): the regroup's layout at O(n + m)."""
    old_rows = index.sorted_rows.cpu().numpy()
    old_off = index.offsets.cpu().numpy()
    pos = old_off[assign + 1]  # just before the next cluster's rows
    counts = np.bincount(assign, minlength=index.n_clusters)
    return _with_layout(index, np.insert(old_rows, pos, rows),
                        old_off + np.concatenate([[0], np.cumsum(counts)]))


def extend(index: IVFIndex, new_vectors: torch.Tensor,
           first_new_row: int) -> IVFIndex:
    """Insert rows ``first_new_row ..`` into the existing clusters
    (centroids unchanged). Inserts of at most
    ``EXTEND_INCREMENTAL_FRACTION`` of the indexed rows take the
    incremental splice, larger ones the regroup; both give the same
    layout. The layout is spliced on the host and goes back to the
    index's device."""
    assign = _assign_to_centroids(index, new_vectors)
    rows = np.arange(first_new_row, first_new_row + new_vectors.shape[0],
                     dtype=np.int32)
    n_old = int(index.sorted_rows.shape[0])
    if rows.shape[0] <= max(1, int(n_old * EXTEND_INCREMENTAL_FRACTION)):
        return _extend_incremental(index, assign, rows)
    return _extend_regroup(index, assign, rows)


# ---------------------------------------------------------------------------
# probing search
# ---------------------------------------------------------------------------

def _candidate_slots(index: IVFIndex, probe_clusters: torch.Tensor,
                     max_scan: int):
    """Map ``max_scan`` static slots onto the rows of each query's probed
    clusters. probe_clusters (B, P) -> (rows (B, max_scan) int64,
    valid (B, max_scan))."""
    offsets = index.offsets.to(torch.int64)
    starts = offsets[probe_clusters]
    sizes = offsets[probe_clusters + 1] - starts
    b = probe_clusters.shape[0]
    cum = torch.cat([torch.zeros((b, 1), dtype=torch.int64,
                                 device=starts.device),
                     torch.cumsum(sizes, dim=1)], dim=1)  # (B, P+1)
    total = cum[:, -1:]
    slots = torch.arange(max_scan, device=starts.device).expand(b, max_scan)
    which = torch.clamp(
        torch.searchsorted(cum, slots.contiguous(), right=True) - 1,
        0, sizes.shape[1] - 1)
    within = slots - cum.gather(1, which)
    valid = slots < torch.clamp(total, max=max_scan)
    gather_pos = torch.clamp(starts.gather(1, which) + within, 0,
                             index.sorted_rows.shape[0] - 1)
    return index.sorted_rows.to(torch.int64)[gather_pos], valid


def probe_scan_budget(n_clusters: int, n_rows: int, *, nprobe: int,
                      probe_k: int) -> int:
    """Candidate budget of one neighborhood pre-probe: ``nprobe`` clusters
    at ~4× the mean cluster size, floored at ``4·probe_k`` and capped at
    the table."""
    return min(n_rows,
               max(probe_k * 4, (nprobe * 4 * n_rows) // max(1, n_clusters)))


def probe_slots_batch(index: IVFIndex, q_b: torch.Tensor, *, nprobe: int,
                      max_scan: int):
    """Probe each query's ``nprobe`` closest clusters and map their rows onto
    ``max_scan`` static slots. -> (rows (B, max_scan), valid (B, max_scan))."""
    csim = similarity_batch(q_b, index.centroids, index.metric)
    _, probe_clusters = topk_stable(csim, nprobe)
    return _candidate_slots(index, probe_clusters, max_scan)


def probe_slots(index: IVFIndex, q: torch.Tensor, *, nprobe: int,
                max_scan: int):
    rows, valid = probe_slots_batch(index, q[None], nprobe=nprobe,
                                    max_scan=max_scan)
    return rows[0], valid[0]


def search(index: IVFIndex, vectors: torch.Tensor, scalars: torch.Tensor,
           pred: PredicateLike, q: torch.Tensor, *, nprobe: int,
           max_scan: int, k: int):
    """Index-first filtered search on one vector column.
    -> (ids (k,), scores (k,), n_scored, n_qualified); unfilled slots
    carry id -1 / score NEG."""
    rows, valid = probe_slots(index, q, nprobe=nprobe, max_scan=max_scan)
    scores = similarity(q, vectors[rows], index.metric)
    qual = eval_mask(pred, scalars[rows]) & valid
    masked = torch.where(qual, scores, torch.full_like(scores, NEG))
    top_scores, top_idx = topk_stable(masked, k)
    ids = torch.where(top_scores > NEG / 2, rows[top_idx],
                      torch.full_like(top_idx, -1))
    return ids.to(torch.int32), top_scores, valid.sum(), qual.sum()


def search_scored_batch(index: IVFIndex, row_scores_b: torch.Tensor,
                        scalars: torch.Tensor, pred_b, q_b: torch.Tensor, *,
                        nprobe: int, max_scan: int, k: int):
    """``search`` with each query's row similarities precomputed
    (``row_scores_b`` (B, n), one GEMM for the batch): slot selection plus
    a score gather. -> (ids (B, k), scores (B, k), n_scored (B,),
    n_qualified (B,))."""
    rows, valid = probe_slots_batch(index, q_b, nprobe=nprobe,
                                    max_scan=max_scan)
    scores = row_scores_b.gather(1, rows)
    qual = eval_mask(pred_b, scalars[rows]) & valid
    masked = torch.where(qual, scores, torch.full_like(scores, NEG))
    top_scores, top_idx = topk_stable(masked, k)
    ids = torch.where(top_scores > NEG / 2, rows.gather(1, top_idx),
                      torch.full_like(top_idx, -1))
    return ids.to(torch.int32), top_scores, valid.sum(1), qual.sum(1)


def search_scored(index: IVFIndex, row_scores: torch.Tensor,
                  scalars: torch.Tensor, pred: PredicateLike,
                  q: torch.Tensor, *, nprobe: int, max_scan: int, k: int):
    """Single-query ``search_scored_batch``."""
    from repro_torch.vectordb.predicates import stack

    ids, s, n_sc, n_q = search_scored_batch(
        index, row_scores[None], scalars, stack([pred]), q[None],
        nprobe=nprobe, max_scan=max_scan, k=k)
    return ids[0], s[0], n_sc[0], n_q[0]


def _probe_stats(scores, rows, scalars, pred_b, probe_k):
    top_scores, top_idx = topk_stable(scores, probe_k)
    neigh_rows = rows.gather(1, top_idx)
    ok = eval_mask(pred_b, scalars[neigh_rows])
    found = top_scores > NEG / 2
    n_found = torch.clamp(found.sum(1), min=1)
    rate = (ok & found).sum(1) / n_found
    mean_s = torch.where(found, top_scores, torch.zeros_like(top_scores)
                         ).sum(1) / n_found
    return rate, mean_s


def preprobe(index: IVFIndex, vectors: torch.Tensor, scalars: torch.Tensor,
             pred_b, q_b: torch.Tensor, *, nprobe: int = 1,
             probe_k: int = 32):
    """Paper §3.3 neighborhood pre-probing for a query batch: a cheap
    *unfiltered* ANN probe, then the local satisfaction rate of each
    query's predicate among those neighbors.
    -> (rate (B,), mean_top_score (B,))."""
    n = vectors.shape[0]
    max_scan = probe_scan_budget(index.n_clusters, n, nprobe=nprobe,
                                 probe_k=probe_k)
    rows, valid = probe_slots_batch(index, q_b, nprobe=nprobe,
                                    max_scan=max_scan)
    sims = similarity(q_b, vectors[rows], index.metric)
    scores = torch.where(valid, sims, torch.full_like(sims, NEG))
    return _probe_stats(scores, rows, scalars, pred_b, probe_k)


def preprobe_scored(index: IVFIndex, row_scores_b: torch.Tensor,
                    scalars: torch.Tensor, pred_b, q_b: torch.Tensor, *,
                    nprobe: int = 1, probe_k: int = 32):
    """``preprobe`` with the row similarities precomputed: gathers f32
    scores instead of (B, max_scan, d) vector tiles."""
    n = row_scores_b.shape[1]
    max_scan = probe_scan_budget(index.n_clusters, n, nprobe=nprobe,
                                 probe_k=probe_k)
    rows, valid = probe_slots_batch(index, q_b, nprobe=nprobe,
                                    max_scan=max_scan)
    g = row_scores_b.gather(1, rows)
    scores = torch.where(valid, g, torch.full_like(g, NEG))
    return _probe_stats(scores, rows, scalars, pred_b, probe_k)


# ---------------------------------------------------------------------------
# candidate-local batched search (no dense score matrix)
# ---------------------------------------------------------------------------

def search_local_batch(index: IVFIndex, vectors: torch.Tensor,
                       scalars: torch.Tensor, pred_b, q_b: torch.Tensor, *,
                       nprobe: int, max_scan: int, k: int):
    """Candidate-local batched search: slots are selected per query and ONE
    fused gather+score+mask+top-k (``kernels.gather_score``) touches only
    those ``B·max_scan`` rows. -> (ids (B, k), scores (B, k), n_scored (B,),
    n_qualified (B,)); ties break by smaller row id."""
    from repro_torch.kernels.gather_score import gather_score_topk

    rows_b, valid_b = probe_slots_batch(index, q_b, nprobe=nprobe,
                                        max_scan=max_scan)
    cand = torch.where(valid_b, rows_b, torch.full_like(rows_b, -1)).to(
        torch.int32)
    w = torch.ones((q_b.shape[0], 1), device=q_b.device)
    ids, scores, n_qual = gather_score_topk(
        cand, (vectors,), (q_b,), w, scalars, pred_b, k=k,
        metric=index.metric)
    return ids, scores, valid_b.sum(1), n_qual


def search_local_batch_int8(index: IVFIndex, vectors: torch.Tensor,
                            vectors_i8: torch.Tensor, scales: torch.Tensor,
                            scalars: torch.Tensor, pred_b, q_b: torch.Tensor,
                            *, nprobe: int, max_scan: int, k: int,
                            rerank_mult: int | None = None):
    """Quantized-tier ``search_local_batch``: identical slot selection, the
    probed candidates scored from the int8 replica (predicates on the exact
    fp32 scalars) and the top-α·k survivors re-scored exactly in fp32."""
    from repro_torch.kernels.gather_score import gather_score_topk_int8

    rows_b, valid_b = probe_slots_batch(index, q_b, nprobe=nprobe,
                                        max_scan=max_scan)
    cand = torch.where(valid_b, rows_b, torch.full_like(rows_b, -1)).to(
        torch.int32)
    w = torch.ones((q_b.shape[0], 1), device=q_b.device)
    kwargs = {} if rerank_mult is None else {"rerank_mult": rerank_mult}
    ids, scores, n_qual = gather_score_topk_int8(
        cand, (vectors,), (vectors_i8,), (scales,), (q_b,), w, scalars,
        pred_b, k=k, metric=index.metric, **kwargs)
    return ids, scores, valid_b.sum(1), n_qual
