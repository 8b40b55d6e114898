"""Sharded MHQ search: logical shards on one device, and a mesh of ranks.

Port of ``repro.vectordb.distributed``. Rows split into ``n_shards``
contiguous ``ceil(n / n_shards)``-row shards; each shard keeps a local
top-k and the global result is one merge of the O(shards · k) candidates,
in shard order:

  * ``sharded_topk_ref`` is the EXACT per-shard filtered top-k over
    precomputed weighted scores;
  * ``ShardedIVF`` + ``sharded_ivf_topk`` is the PLAN-DRIVEN path: every
    shard probes its own IVF index with the plan's shard-legalized knobs
    and reranks the candidate union through the fused gather+score kernel.

On one device the shards are folded into the query axis of each kernel
launch: shard ``s``'s probed slots are globalized (``s · shard_len`` added
to the local ``sorted_rows`` entries, -1 kept for empty slots) and the S
shards' (B, slots) candidate sets stack into one (S·B, slots) matrix over
the whole table, so a chunk launches the gather kernel once per probed
column and once for the rerank, whatever S is. The table is never copied
into shard-shaped tensors. Ties break by the smaller global row id, as the
reference's ``lax.top_k`` over shard-ordered candidates does.

The reference's ``shard_map`` functions (``sharded_masked_scan``,
``sharded_masked_scan_batched``, ``sharded_batch_topk`` and the mesh branch
of ``sharded_ivf_topk``) run here under ``torch.distributed``, one process
per rank (SPMD, where the reference has one controller). A mesh is a
``DeviceMesh`` and the names of its data dimensions; the shard count is
their product and a rank's shard its row-major coordinate over them
(``mesh_shard``). Each rank calls the built function with its own
``n / S`` rows (``shard_rows``), and the merge is one ``all_gather`` of the
per-shard candidates over the data dimensions, in shard order
(``gather_shards``); these three live in ``repro_torch.common.mesh`` and
are named here too. Ranks that differ only on other dimensions hold the
same shard and return the same result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import sys
import threading

import numpy as np
import torch

from repro_torch.common.mesh import (gather_shards, mesh_line, mesh_shard,
                                    shard_rows)
from repro_torch.kernels.shapes import NEG
from repro_torch.vectordb import ivf as _ivf
from repro_torch.vectordb import predicates
from repro_torch.vectordb.flat import topk_stable
from repro_torch.vectordb.table import similarity, similarity_batch


# ---------------------------------------------------------------------------
# the mesh: shards, rows and collectives
# ---------------------------------------------------------------------------

def broadcast_from_first(obj, mesh):
    """``obj`` as the mesh's first rank (coordinate 0 on every dimension)
    holds it, on every rank: one broadcast along each dimension."""
    import torch.distributed as dist

    for d in range(mesh.ndim):
        box = [obj]
        dist.broadcast_object_list(box, src=mesh_line(mesh, d)[0],
                                   group=mesh.get_group(d))
        obj = box[0]
    return obj


def is_first_rank(mesh) -> bool:
    """Whether this rank is the mesh's first: coordinate 0 on every
    dimension (the rank that plans a sharded batch and fronts serving)."""
    return not any(mesh.get_coordinate())


def portable_error(exc: BaseException) -> BaseException:
    """``exc`` if it survives a pickle round trip, else a ``RuntimeError``
    carrying its type name and message: what one rank can send the others
    so that each raises it."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:  # noqa: BLE001 — any pickling fault means "not as is"
        return RuntimeError(f"{type(exc).__name__}: {exc}")


# ---------------------------------------------------------------------------
# failures: shared by every rank, or one rank's alone
# ---------------------------------------------------------------------------

_SHARED = "mesh_shared"


def mark_shared(exc: BaseException) -> BaseException:
    """Mark ``exc`` as raised by every rank of the mesh for the same batch
    (it travelled in a broadcast, or a collective decided it), so a rank
    that catches it knows its peers left that batch at the same point.
    -> ``exc``."""
    setattr(exc, _SHARED, True)
    return exc


def is_shared(exc: BaseException) -> bool:
    return bool(getattr(exc, _SHARED, False))


class MeshSessionError(RuntimeError):
    """A rank of the mesh failed alone during a serving session: its peers
    were left out of step (waiting in a collective it never entered), so
    the session is over. ``rank`` is the global rank that failed."""

    def __init__(self, rank: int, message: str):
        super().__init__(f"rank {rank} of the mesh failed alone: {message}; "
                         f"the serving session over the mesh has ended")
        self.rank = rank


# a follower's process ends with this code when its serving session failed
# (its own failure, or another rank's), so that every peer waiting on it in
# a collective raises at once instead of waiting out a timeout
FAILED_EXIT = 70
WATCH_INTERVAL_S = 0.05


def check_stamps(row: tuple, mesh, *, device) -> None:
    """Every rank's ``row`` (ints: a tiered snapshot's stamp and its
    cold-state digest, or 0) gathered once over every dimension of
    ``mesh``; unless all are equal, every rank raises the same
    ``RuntimeError``, marked shared (the verdict is computed from the same
    gathered rows everywhere)."""
    x = torch.tensor([list(row)], dtype=torch.int64, device=device)
    every = gather_shards(x, mesh, tuple(mesh.mesh_dim_names)).cpu()
    if not bool((every == every[0]).all()):
        raise mark_shared(RuntimeError(
            f"the ranks' tiered snapshots differ (epoch, cold rows, rows, "
            f"cold digest by rank): {every.tolist()}"))


# ---------------------------------------------------------------------------
# the batch channel
# ---------------------------------------------------------------------------

# the batch channel's own timeout: a follower waits in it between batches,
# however long traffic pauses, so it is not the process group's
CHANNEL_TIMEOUT = datetime.timedelta(days=7)
BATCH, STOP = "batch", "stop"
_FAILURES = "failures"


def _query_to_host(q) -> dict:
    p = q.predicates
    return dict(
        vectors=[v.detach().cpu().numpy() for v in q.query_vectors],
        weights=tuple(q.weights), kind=type(p).__name__,
        fields={f.name: getattr(p, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(p)},
        k=q.k, recall_target=q.recall_target, tenant_id=q.tenant_id)


def _query_from_host(m: dict, device):
    from repro_torch.core.query import MHQ

    cls = {"Predicates": predicates.Predicates,
           "PredicateSet": predicates.PredicateSet}[m["kind"]]
    return MHQ(tuple(torch.from_numpy(v).to(device) for v in m["vectors"]),
               m["weights"], cls(**{k: torch.from_numpy(v).to(device)
                                    for k, v in m["fields"].items()}),
               k=m["k"], recall_target=m["recall_target"],
               tenant_id=m["tenant_id"])


class BatchChannel:
    """The serving front end's channel to the other ranks of a mesh of more
    than one rank: the first rank sends each batch it executes, then a
    stop; every other rank receives them in that order.

    A message is one ``broadcast_object_list`` from the first rank over a
    ``gloo`` group of the mesh's ranks made for this channel (every rank
    of the mesh constructs it at the same point: the front end's start and
    ``serve_follower``). A batch travels as host arrays — each query's
    vectors, weights, predicate fields, ``k``, ``recall_target`` and
    ``tenant_id`` — and each receiver rebuilds its ``MHQ``s on its own
    device, byte for byte the sender's values. Over a tiered table a
    message also carries the batch's snapshot stamp and the ingest since
    the last message (``tiered.TieredTable.delta``); the stop carries the
    final stamp. Between batches a receiver waits in the broadcast, so the
    group has its own timeout (``CHANNEL_TIMEOUT``): a pause in traffic
    longer than the process group's timeout does not fail a waiting rank.

    A rank that fails alone reports it in the process group's store under
    this channel's name (``fail``) and its process ends; a follower's
    ``watchdog`` ends its process as soon as any report appears. A rank
    whose peer process ends sees the connection close and raises, so no
    rank waits out a timeout; the first rank names the failed rank
    (``session_error``)."""

    def __init__(self, mesh):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _get_default_store

        self.src = int(mesh.mesh[(0,) * mesh.ndim])  # the first rank
        self.ranks = sorted(mesh.mesh.flatten().tolist())
        self.group = dist.new_group(self.ranks, timeout=CHANNEL_TIMEOUT,
                                    backend="gloo")
        self.store = dist.PrefixStore(
            f"boomhq/batch-channel/{self.group.group_name}/",
            _get_default_store())

    def _broadcast(self, msg):
        import torch.distributed as dist

        box = [msg]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]

    def send_batch(self, queries: list, tiered: dict | None = None) -> None:
        """First rank: the batch about to execute, as host arrays, with
        its tiered stamp and ingest delta when it has one."""
        self._broadcast((BATCH, [_query_to_host(q) for q in queries],
                         tiered))

    def send_stop(self, tiered: dict | None = None) -> None:
        """First rank: the last message of the session (over a tiered
        table, with the final stamp and the ingest since the last batch)."""
        self._broadcast((STOP, None, tiered))

    def receive(self, device) -> tuple:
        """Any other rank: the next message. -> ``(BATCH, queries on
        device, tiered part or None)`` or ``(STOP, None, tiered part or
        None)``."""
        kind, body, tiered = self._broadcast(None)
        if kind == STOP:
            return STOP, None, tiered
        return BATCH, [_query_from_host(m, device) for m in body], tiered

    # -- failures ------------------------------------------------------------

    def _reports(self) -> list:
        """(rank, message) of every rank that reported a lone failure."""
        return [(r, self.store.get(f"failed/{r}").decode())
                for r in self.ranks if self.store.check([f"failed/{r}"])]

    def _report(self, exc: BaseException) -> None:
        import torch.distributed as dist

        self.store.set(f"failed/{dist.get_rank()}",
                       f"{type(exc).__name__}: {exc}")
        self.store.add(_FAILURES, 1)

    def failed(self) -> bool:
        return self.store.check([_FAILURES])

    def session_error(self, exc: BaseException) -> MeshSessionError:
        """First rank: the error that ends the session after ``exc``, which
        no other rank shares. It names the rank that reported a lone
        failure; with no report ``exc`` is this rank's own, which is
        reported here so that the followers end."""
        import torch.distributed as dist

        reports = self._reports()
        if not reports:
            self._report(exc)
            reports = [(dist.get_rank(), f"{type(exc).__name__}: {exc}")]
        return MeshSessionError(*reports[0])

    def fail(self, exc: BaseException):
        """A follower whose batch raised what no other rank shares: report
        it (unless another rank's report came first: this one is its
        consequence), then end this process, which releases every peer
        waiting on it in a collective. Never returns."""
        if not self.failed():
            self._report(exc)
        _end_process()

    @contextlib.contextmanager
    def watchdog(self):
        """Within the block, a thread ends this follower's process as soon
        as any rank has reported a lone failure: the first rank stops
        sending, and this rank may be waiting on it in a collective."""
        done = threading.Event()

        def watch():
            while not done.wait(WATCH_INTERVAL_S):
                if self.failed():
                    _end_process()

        t = threading.Thread(target=watch, name="batch-channel-watchdog",
                             daemon=True)
        t.start()
        try:
            yield
        finally:
            done.set()
            t.join()


def _end_process():
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(FAILED_EXIT)


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


def _gather_packed(tensors: tuple, mesh, data_axes) -> list:
    """Every shard's (B, w_j) tensors in ONE ``all_gather`` per data
    dimension (int32 bits; floats travel as their bits).
    -> each as (B, S·w_j), in shard order."""
    parts = [t.to(torch.int32) if t.dtype != torch.float32
             else t.view(torch.int32) for t in tensors]
    packed = torch.cat(parts, dim=1)
    b, width = packed.shape
    every = gather_shards(packed, mesh, data_axes, dim=1).reshape(b, -1,
                                                                 width)
    out, c = [], 0
    for t in tensors:
        w = t.shape[1]
        x = every[:, :, c: c + w].reshape(b, -1)
        out.append(x.view(torch.float32) if t.dtype == torch.float32 else x)
        c += w
    return out


def mesh_topk(masked: torch.Tensor, row0: int, mesh, data_axes, *, k: int):
    """This shard's top-min(k, n/S) of (Q, n/S) masked scores, its ids
    globalized by ``row0``, then one gather and the merge in shard order.
    -> (ids (Q, k) int32, scores (Q, k)), the same on every rank."""
    s_loc, idx = topk_stable(masked, min(k, masked.shape[1]))
    s_all, g_all = _gather_packed((s_loc, (idx + row0).to(torch.int32)),
                                  mesh, data_axes)
    return _merge_shard_candidates(s_all, g_all, k=k)


def _row0(scalars: torch.Tensor, mesh, data_axes) -> int:
    """This rank's first global row: its shard times its row count."""
    return mesh_shard(mesh, data_axes)[1] * scalars.shape[0]


def sharded_masked_scan(mesh, data_axes=("data",), *, k: int, n_vec: int,
                        metric: str = "dot"):
    """Build the sharded filtered top-k of one query.

    Returned fn, called by every rank with its own rows:
      fn(vectors tuple[(n/S, d_i)], scalars (n/S, M), pred,
         qs tuple[(d_i,)], w (N,)) -> (ids (k,) int32, scores (k,))
    Row ids are global; every rank returns the same result."""

    def run(vectors, scalars, pred, qs, w):
        total = torch.zeros(scalars.shape[0], device=scalars.device)
        for i in range(n_vec):
            total = total + w[i] * similarity(qs[i], vectors[i], metric)
        masked = torch.where(predicates.eval_mask(pred, scalars), total,
                             torch.full_like(total, NEG))
        ids, scores = mesh_topk(masked[None],
                                 _row0(scalars, mesh, data_axes), mesh,
                                 data_axes, k=k)
        return ids[0], scores[0]

    return run


def quantize_queries(q: torch.Tensor) -> tuple:
    """(Q, d) queries -> (int8 (Q, d), per-query scale (Q,)): the
    reference's absmax / 127, rounded half to even and clipped to ±127."""
    qsc = torch.clamp(q.abs().amax(dim=-1), min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(q / qsc[:, None]), -127, 127)
    return q8.to(torch.int8), qsc


def int8_dot(v8: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """(n, d) int8 rows · (Q, d) int8 queries -> (Q, n) int32, exact: the
    product runs in float64, where every partial sum is an integer below
    2^53 (a library product, as the reference's ``einsum`` is)."""
    return (q8.to(torch.float64) @ v8.to(torch.float64).T).to(torch.int32)


def sharded_masked_scan_batched(mesh, data_axes=("data",), *, k: int,
                                n_vec: int, metric: str = "dot",
                                int8: bool = False):
    """Build the sharded filtered top-k of a query batch: one pass over a
    rank's rows serves Q queries; with ``int8`` the rows are int8 with
    per-row scales and the queries are quantized too (``quantize_queries``,
    ``int8_dot``: an exact integer product, scaled back in fp32).

    Returned fn, called by every rank with its own rows:
      fn(vectors, scales (int8: tuple[(n/S,)], else ignored),
         scalars (n/S, M), preds (stacked over Q), qs tuple[(Q, d_i)],
         w (Q, N)) -> (ids (Q, k) int32, scores (Q, k))"""

    def run(vectors, scales, scalars, preds, qs, w):
        total = torch.zeros((qs[0].shape[0], scalars.shape[0]),
                            device=scalars.device)
        for i in range(n_vec):
            if int8:
                q8, qsc = quantize_queries(qs[i])
                s = int8_dot(vectors[i], q8).to(torch.float32) \
                    * scales[i][None, :] * qsc[:, None]
            else:
                s = similarity_batch(qs[i], vectors[i], metric)
            total = total + w[:, i][:, None] * s
        masked = torch.where(predicates.eval_mask(preds, scalars), total,
                             torch.full_like(total, NEG))
        return mesh_topk(masked, _row0(scalars, mesh, data_axes),
                          mesh, data_axes, k=k)

    return run


def sharded_batch_topk(mesh, data_axes=("data",), *, k: int):
    """Build the cross-shard batched filtered top-k over precomputed
    weighted scores: a rank reads only its (Q, n/S) block of the batch's
    weighted score matrix, and the merge is one gather of O(shards · k)
    candidates.

    Returned fn, called by every rank with its own rows:
      fn(w_scores (Q, n/S), scalars (n/S, M), preds (stacked over Q))
        -> (ids (Q, k) int32, scores (Q, k))"""

    def run(w_scores, scalars, preds):
        masked = torch.where(predicates.eval_mask(preds, scalars), w_scores,
                             torch.full_like(w_scores, NEG))
        return mesh_topk(masked, _row0(scalars, mesh, data_axes),
                          mesh, data_axes, k=k)

    return run


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

    def shard(self, s: int) -> "ShardedIVF":
        """Shard ``s``'s index alone, as a one-shard ``ShardedIVF`` (the
        index a mesh rank holding that shard probes)."""
        return ShardedIVF(self.centroids[s: s + 1],
                          self.sorted_rows[s: s + 1],
                          self.offsets[s: s + 1], self.metric)


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


def sharded_ivf_topk(n_shards: int, mesh=None, data_axes=("data",), *,
                     subs: tuple, k: int, metric: str, pad_total: int):
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
    k-th. With one shard there is no fold and no merge.

    With a ``mesh`` (``n_shards`` of its data dimensions) every rank calls
    fn with its own rows and its own shard's one-shard ``ShardedIVF``
    arrays: the body is the one-shard search on local ids, globalized
    after the rerank, and one gather merges the shards in shard order.
    Every rank returns the same four tensors."""
    from repro_torch.core.executor import rrf_extras
    from repro_torch.kernels.gather_score import gather_score_topk

    s = max(1, int(n_shards))
    if mesh is not None:
        local = sharded_ivf_topk(1, subs=subs, k=k, metric=metric,
                                 pad_total=pad_total)

        def run_rank(cent_t, rows_t, offs_t, vectors, scalars, pred_b, qv_t,
                     w_b):
            count, shard = mesh_shard(mesh, data_axes)
            if count != s:
                raise ValueError(f"{s} shards asked of a mesh of {count}")
            ids, scores, fill, bnd = local(cent_t, rows_t, offs_t, vectors,
                                           scalars, pred_b, qv_t, w_b)
            ids = torch.where(ids >= 0, ids + shard * scalars.shape[0], ids)
            s_all, g_all, fill, bnd = _gather_packed(
                (scores, ids, fill, bnd), mesh, data_axes)
            mi, ms = _merge_shard_candidates(s_all, g_all, k=k)
            return mi, ms, fill, bnd

        return run_rank

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
