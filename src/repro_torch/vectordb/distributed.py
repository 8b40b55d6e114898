"""Logical-shard MHQ search on one device.

Port of the single-device part of ``repro.vectordb.distributed``. Rows
split into ``n_shards`` contiguous ``ceil(n / n_shards)``-row shards; each
shard keeps a local top-k and the global result is one merge of the
O(shards · k) candidates, in shard order:

  * ``sharded_topk_ref`` is the EXACT per-shard filtered top-k over
    precomputed weighted scores;
  * ``ShardedIVF`` + ``sharded_ivf_topk`` is the PLAN-DRIVEN path: every
    shard probes its own IVF index with the plan's shard-legalized knobs
    and reranks the candidate union through the fused gather+score kernel.

The shards are folded into the query axis of each kernel launch: shard
``s``'s probed slots are globalized (``s · shard_len`` added to the local
``sorted_rows`` entries, -1 kept for empty slots) and the S shards'
(B, slots) candidate sets stack into one (S·B, slots) matrix over the
whole table, so a chunk launches the gather kernel once per probed column
and once for the rerank, whatever S is. The table is never copied into
shard-shaped tensors. Ties break by the smaller global row id, as the
reference's ``lax.top_k`` over shard-ordered candidates does.

The ``shard_map`` builders of the reference (``sharded_masked_scan``,
``sharded_masked_scan_batched``, ``sharded_batch_topk`` and the mesh
branch of ``sharded_ivf_topk``) have no counterpart yet: a ``mesh`` raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.shapes import NEG
from repro_torch.vectordb import ivf as _ivf
from repro_torch.vectordb import predicates
from repro_torch.vectordb.flat import topk_stable

MESH_QUEUED = ("the shard_map (mesh) path is not ported: it is queued as a "
               "torch.distributed counterpart (ROADMAP Queue 1 item 5)")


def _merge_shard_candidates(s_all: torch.Tensor, g_all: torch.Tensor, *,
                            k: int):
    """Top-k over the concatenated per-shard candidates (Q, S·kk), ties to
    the earlier slot; padded to width k with id -1 / score NEG."""
    kf = min(k, s_all.shape[1])
    ms, mi = topk_stable(s_all, kf)
    ids = torch.where(ms > NEG / 2, g_all.gather(1, mi).to(torch.int32),
                      torch.full_like(mi, -1, dtype=torch.int32))
    if kf < k:
        q = ids.shape[0]
        ids = torch.cat([ids, torch.full((q, k - kf), -1, dtype=torch.int32,
                                         device=ids.device)], dim=1)
        ms = torch.cat([ms, torch.full((q, k - kf), NEG, dtype=ms.dtype,
                                       device=ms.device)], dim=1)
    return ids, ms


def sharded_topk_ref(w_scores: torch.Tensor, mask: torch.Tensor, *, k: int,
                     n_shards: int):
    """Logical-shard filtered top-k over precomputed weighted scores.

    ``w_scores``/``mask``: (Q, n). Each shard keeps a local
    top-min(k, shard_len) (a short last shard is right-padded with
    non-qualifying rows), then one merge over the (Q, S·kk) candidates.
    -> (ids (Q, k) int32, scores (Q, k))."""
    q, n = w_scores.shape
    per = -(-n // n_shards)
    masked = torch.where(mask, w_scores, torch.full_like(w_scores, NEG))
    if per * n_shards > n:
        masked = torch.cat([masked, torch.full(
            (q, per * n_shards - n), NEG, dtype=masked.dtype,
            device=masked.device)], dim=1)
    kk = min(k, per)
    s_loc, idx = topk_stable(masked.reshape(q, n_shards, per), kk)
    gids = torch.arange(n_shards, device=idx.device)[None, :, None] * per \
        + idx
    return _merge_shard_candidates(s_loc.reshape(q, n_shards * kk),
                                   gids.reshape(q, n_shards * kk), k=k)


@dataclasses.dataclass
class ShardedIVF:
    """Per-shard IVF indexes of ONE vector column, stacked on a leading
    shard axis. ``sorted_rows`` holds LOCAL row ids; the last shard of a
    non-divisible table is zero-padded, and since ``offsets`` count only
    the shard's real rows, padded slots are never probed."""

    centroids: torch.Tensor    # (S, C, d)
    sorted_rows: torch.Tensor  # (S, shard_len) int32 local ids, zero-padded
    offsets: torch.Tensor      # (S, C+1) int32
    metric: str

    @property
    def n_shards(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def shard_len(self) -> int:
        return int(self.sorted_rows.shape[1])


def build_sharded_ivf(vectors: torch.Tensor, n_shards: int, *,
                      n_clusters: int, seed: int = 0, metric: str = "dot",
                      base_index=None) -> ShardedIVF:
    """One IVF index per contiguous table slice, on ``vectors``' device.

    ``n_clusters`` is the PER-SHARD count, clamped to the shortest shard so
    the stacked arrays keep one shape; shard ``i`` seeds its k-means with
    ``seed + 7919·i``. With one shard and a ``base_index`` the bound index
    is reused verbatim, so the degenerate configuration is the
    single-device candidate-local path bit for bit."""
    n = int(vectors.shape[0])
    s = max(1, int(n_shards))
    if s == 1 and base_index is not None:
        return ShardedIVF(base_index.centroids[None],
                          base_index.sorted_rows[None],
                          base_index.offsets[None], base_index.metric)
    shard_len = -(-n // s)
    n_last = n - (s - 1) * shard_len
    c = max(1, min(int(n_clusters), n_last))
    cents, rows, offs = [], [], []
    for i in range(s):
        idx = _ivf.build(vectors[i * shard_len: min((i + 1) * shard_len, n)],
                         c, seed=seed + 7919 * i, metric=metric)
        r = idx.sorted_rows
        if r.shape[0] < shard_len:
            r = torch.cat([r, torch.zeros(shard_len - r.shape[0],
                                          dtype=r.dtype, device=r.device)])
        cents.append(idx.centroids)
        rows.append(r)
        offs.append(idx.offsets)
    return ShardedIVF(torch.stack(cents), torch.stack(rows),
                      torch.stack(offs), metric)


def probe_shards(cent, rows, offs, q_b: torch.Tensor, shard_len: int, *,
                 metric: str, nprobe: int, max_scan: int) -> torch.Tensor:
    """Each shard's probe of its own index for the whole batch, globalized
    and folded into the query axis: shard ``s``'s queries are rows
    ``s·B .. (s+1)·B``. -> (S·B, max_scan) int32 global ids, -1 empty."""
    out = []
    for s in range(cent.shape[0]):
        r, v = _ivf.probe_slots_batch(
            _ivf.IVFIndex(cent[s], rows[s], offs[s], metric), q_b,
            nprobe=nprobe, max_scan=max_scan)
        out.append(torch.where(v, r + s * shard_len, torch.full_like(r, -1)))
    return torch.cat(out, dim=0).to(torch.int32)


def sharded_ivf_topk(n_shards: int, mesh=None, *, subs: tuple, k: int,
                     metric: str, pad_total: int):
    """Build the plan-driven per-shard probing search.

    ``subs``: one entry per probed column, ``(pos, k_i, ks, nprobe,
    max_scan)`` shard-legalized (``executor.legalize_for_shard``); ``pos``
    indexes the column tuples passed at call time, ``ks`` is the bucketed
    probe width. Each shard probes its own index, keeps each column's top
    ``k_i``, fills a multi-column union's pad bucket with RRF-fused extras
    from the probed tails (``pad_total`` slots), reranks the union by the
    full weighted score and keeps a local top-k; then one merge in shard
    order.

    Returned fn signature:
      fn(cent_t, rows_t, offs_t  — per-probed-column ``ShardedIVF`` arrays,
         vectors tuple[(n, d_i)], scalars (n, M), pred_b (stacked over B),
         qv_t tuple[(B, d_i)], w_b (B, len(vectors)))
        -> (ids (B, k), scores (B, k), fill (B, S), boundary (B, S))

    ``fill[:, s]`` counts shard ``s``'s kept candidates and
    ``boundary[:, s]`` is its weakest kept score (NEG when it kept none),
    which the executor's per-shard escalation compares with the merged
    k-th. With one shard there is no fold and no merge."""
    from repro_torch.core.executor import rrf_extras
    from repro_torch.kernels.gather_score import gather_score_topk

    if mesh is not None:
        raise NotImplementedError(MESH_QUEUED)
    s = max(1, int(n_shards))

    def run(cent_t, rows_t, offs_t, vectors, scalars, pred_b, qv_t, w_b):
        n = scalars.shape[0]
        b = w_b.shape[0]
        shard_len = -(-n // s)
        if s > 1:
            pred_f = predicates.take(pred_b, np.tile(np.arange(b), s))
            qv_f = tuple(q.repeat(s, 1) for q in qv_t)
            w_f = w_b.repeat(s, 1)
        else:
            pred_f, qv_f, w_f = pred_b, qv_t, w_b
        ones = torch.ones((s * b, 1), device=w_b.device)
        wide, cands = [], []
        for j, (pos, k_i, ks, np_s, ms_s) in enumerate(subs):
            cand = probe_shards(cent_t[j], rows_t[j], offs_t[j], qv_t[pos],
                                 shard_len, metric=metric, nprobe=np_s,
                                 max_scan=ms_s)
            ids_j, _, _ = gather_score_topk(
                cand, (vectors[pos],), (qv_f[pos],), ones, scalars, pred_f,
                k=ks, metric=metric)
            wide.append(ids_j)
            cands.append(ids_j[:, :k_i])
        rows_b = torch.cat(cands, dim=1)
        width = rows_b.shape[1]
        if len(subs) > 1 and pad_total > width:
            # the single-device union's composition; a shard's row0 offset
            # is constant, so fusing global ids keeps the local order
            extras = rrf_extras(tuple(wide), kis=tuple(x[1] for x in subs),
                                n_extra=pad_total - width)
            rows_b = torch.cat([rows_b, extras.to(rows_b.dtype)], dim=1)
        elif pad_total > width:
            rows_b = torch.cat([rows_b, torch.full(
                (rows_b.shape[0], pad_total - width), -1, dtype=rows_b.dtype,
                device=rows_b.device)], dim=1)
        ids_l, scores_l, _ = gather_score_topk(
            rows_b.to(torch.int32), tuple(vectors), qv_f, w_f, scalars, None,
            k=k, metric=metric)
        fill = (ids_l >= 0).sum(dim=1).to(torch.int32)
        last = torch.clamp(fill - 1, min=0).to(torch.int64)[:, None]
        bnd = torch.where(fill > 0, scores_l.gather(1, last)[:, 0],
                          torch.full_like(scores_l[:, 0], NEG))
        if s == 1:
            return ids_l, scores_l, fill[:, None], bnd[:, None]
        # (S·B, k) -> (B, S·k) in shard order
        s_all = scores_l.reshape(s, b, k).transpose(0, 1).reshape(b, s * k)
        g_all = ids_l.reshape(s, b, k).transpose(0, 1).reshape(b, s * k)
        mi, ms = _merge_shard_candidates(s_all, g_all, k=k)
        return mi, ms, fill.reshape(s, b).T, bnd.reshape(s, b).T

    return run
