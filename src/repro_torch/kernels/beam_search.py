"""Predicate-aware graph beam search: fixed-trip-count routing + one fused
candidate extraction.

Port of ``repro.kernels.beam_search``. The JAX package routes in XLA (no
Pallas kernel) and vmaps a single-query walk; here the walk is written
batched over the B queries in torch ops, with no host sync inside the
hop loop:

  * **fixed trip count** — exactly ``n_hops`` hops of ``beam_width``
    expansions of ``degree`` neighbors;
  * **visited set** — a (B, n + 1) bool map (column n is a sink for
    scatters that must write nowhere); ``_mark_fresh`` flags the first
    occurrence of each not-yet-visited row, the flags the JAX package's
    packed uint32 bitmask gives;
  * **split beam** — ``beam_width - beam_width // 2`` navigator slots by
    raw similarity, ``beam_width // 2`` result-magnet slots among the
    qualifying unexpanded candidates; the predicate shapes where the walk
    lingers, never what it may traverse;
  * **qualifying entry seeds** — besides the graph's entry points, each
    query starts from ``GRAPH_SEED_FACTOR·beam_width`` qualifying rows,
    one per row-id segment, picked by a hashed row id;
  * **one fused extraction** — every visited row lands in a static
    ``(E + n_hops·beam_width·degree)``-slot pool and the result set is ONE
    ``gather_score_topk`` call over it with the full DNF predicate (the
    CUDA gather kernel on the card).

Every ``lax.top_k`` / ``argsort`` of the reference is a stable sort here,
so ties go to the lower index as there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_score import gather_score_topk
from repro_torch.kernels.shapes import GATHER_BLOCK_S, GRAPH_SEED_FACTOR, NEG
from repro_torch.vectordb.flat import topk_stable
from repro_torch.vectordb.predicates import PredicateLike, eval_mask
from repro_torch.vectordb.table import similarity

_KNUTH = 2654435761  # multiplicative hash key of the seed picks (mod 2^32)


def _mark_fresh(visited: torch.Tensor, ids: torch.Tensor):
    """Batch-insert ``ids`` (B, S) (-1 = padding, duplicates allowed) into
    the (B, n + 1) visited map. -> (visited', fresh): ``fresh`` flags the
    FIRST occurrence of each not-yet-visited row, and exactly those rows
    are added. ``visited`` is updated in place."""
    n = visited.shape[1] - 1
    order = torch.argsort(ids, dim=1, stable=True)
    sorted_ids = ids.gather(1, order)
    first_sorted = torch.cat([
        torch.ones_like(sorted_ids[:, :1], dtype=torch.bool),
        sorted_ids[:, 1:] != sorted_ids[:, :-1]], dim=1)
    first = torch.zeros_like(first_sorted).scatter(1, order, first_sorted)
    idc = torch.clamp(ids, 0, n - 1).long()
    fresh = first & (ids >= 0) & ~visited.gather(1, idc)
    # fresh slots name distinct rows; every other slot writes the sink
    visited.scatter_(1, torch.where(fresh, idc, torch.full_like(idc, n)),
                     torch.ones_like(fresh))
    return visited, fresh


def _mark_expanded(pool_exp, i_raw, ok_raw, i_qual, ok_qual):
    """The expanded flags after a hop's picks, as the reference sets them:
    one scatter of ``[ok_raw, ok_qual]`` at ``[i_raw, i_qual]`` that keeps
    the LAST write for a lane picked twice, OR the old flags. A lane is
    picked twice when fewer than ``w_qual`` lanes qualify: the qualifying
    top-k then pads with the lowest-index NEG lanes, which can be real raw
    picks, and the pad's False overwrites the raw pick's True — the lane
    stays unexpanded and is picked again next hop. Two scatters in that
    order give the same flags deterministically (each holds distinct
    lanes; one scatter with repeated lanes has no defined order on CUDA)."""
    marked = pool_exp.clone()
    marked.scatter_(1, i_raw, ok_raw)
    marked.scatter_(1, i_qual, ok_qual)
    return marked | pool_exp


def beam_candidates_batch(neighbors, vectors, scalars, entry, pred_b, q_b, *,
                          beam_width: int, n_hops: int, metric: str = "dot"):
    """Routing walk for a query batch. ``entry`` is a shared (E,) row set or
    per-query (B, E) rows; -1 entries are ignored. -> (cand (B, S) int32,
    -1 padded, S = E + n_hops·beam_width·degree; n_visited (B,))."""
    n, r = neighbors.shape
    b = q_b.shape[0]
    dev = q_b.device
    if entry.dim() == 1:
        entry = entry[None, :].expand(b, -1)
    entry = entry.to(torch.int64)
    e = entry.shape[1]
    expand = beam_width * r
    p = e + expand  # frontier pool slots
    w_qual = beam_width // 2
    w_raw = beam_width - w_qual
    neg = torch.tensor(NEG, device=dev)

    def score_rows(ids, fresh):
        idc = torch.clamp(ids, 0, n - 1)
        sc = torch.where(fresh, similarity(q_b, vectors[idc], metric), neg)
        qual = eval_mask(pred_b, scalars[idc]) & fresh
        return sc, qual

    visited = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    visited, fresh0 = _mark_fresh(visited, entry)
    seed_ids = torch.where(fresh0, entry, torch.full_like(entry, -1))
    seed_sc, seed_qual = score_rows(seed_ids, fresh0)

    def pad(x, value):
        return torch.cat([x, torch.full((b, expand), value, dtype=x.dtype,
                                        device=dev)], dim=1)

    pool_ids, pool_sc = pad(seed_ids, -1), pad(seed_sc, NEG)
    pool_qual = pad(seed_qual, False)
    pool_exp = torch.zeros((b, p), dtype=torch.bool, device=dev)
    out = [seed_ids]
    for _ in range(n_hops):
        selectable = (pool_ids >= 0) & ~pool_exp
        raw = torch.where(selectable, pool_sc, neg)
        _, i_raw = topk_stable(raw, w_raw)
        taken = torch.zeros_like(selectable).scatter(
            1, i_raw, torch.ones_like(i_raw, dtype=torch.bool))
        qual_sc = torch.where(selectable & pool_qual & ~taken, pool_sc, neg)
        _, i_qual = topk_stable(qual_sc, w_qual)
        ok_raw = raw.gather(1, i_raw) > NEG / 2
        ok_qual = qual_sc.gather(1, i_qual) > NEG / 2
        pool_exp = _mark_expanded(pool_exp, i_raw, ok_raw, i_qual, ok_qual)

        fr_idx = torch.cat([i_raw, i_qual], dim=1)
        fr_ok = torch.cat([ok_raw, ok_qual], dim=1)
        fr_ids = torch.where(fr_ok, pool_ids.gather(1, fr_idx),
                             torch.full_like(fr_idx, -1))
        nb = neighbors[torch.clamp(fr_ids, 0, n - 1)].to(torch.int64)
        nb = torch.where(fr_ok[:, :, None], nb,
                         torch.full_like(nb, -1)).reshape(b, expand)
        visited, fresh = _mark_fresh(visited, nb)
        new_ids = torch.where(fresh, nb, torch.full_like(nb, -1))
        new_sc, new_qual = score_rows(new_ids, fresh)
        out.append(new_ids)

        # frontier merge: best p slots by routing score survive; expanded
        # entries keep their flag
        all_ids = torch.cat([pool_ids, new_ids], dim=1)
        all_sc = torch.cat([pool_sc, new_sc], dim=1)
        all_qual = torch.cat([pool_qual, new_qual], dim=1)
        all_exp = torch.cat([pool_exp, torch.zeros_like(new_qual)], dim=1)
        pool_sc, sel = topk_stable(all_sc, p)
        pool_ids, pool_qual, pool_exp = (all_ids.gather(1, sel),
                                         all_qual.gather(1, sel),
                                         all_exp.gather(1, sel))
    cand = torch.cat(out, dim=1).to(torch.int32)
    return cand, (cand >= 0).sum(dim=1)


def qualifying_seeds(pred_b: PredicateLike, scalars: torch.Tensor,
                     n_seeds: int) -> torch.Tensor:
    """(B, n_seeds) qualifying seed rows, -1 where a segment has none: the
    rows split into ``n_seeds`` contiguous id segments and each segment
    gives its qualifying row with the largest hashed id
    ``(id·2654435761 mod 2^32) >> 12`` (the first such row on a tie)."""
    n = scalars.shape[0]
    dev = scalars.device
    seg = -(-n // n_seeds)
    pad = seg * n_seeds - n
    mask_b = eval_mask(pred_b, scalars)  # (B, n)
    b = mask_b.shape[0]
    key = ((torch.arange(n, dtype=torch.int64, device=dev) * _KNUTH)
           & 0xFFFFFFFF) >> 12
    key_seg = torch.cat([key, torch.full((pad,), -1, dtype=torch.int64,
                                         device=dev)]).reshape(n_seeds, seg)
    m = torch.cat([mask_b, torch.zeros((b, pad), dtype=torch.bool,
                                       device=dev)], dim=1)
    kk = torch.where(m.reshape(b, n_seeds, seg), key_seg,
                     torch.full_like(key_seg, -1))
    j = torch.argmax(kk, dim=2)
    ok = kk.gather(2, j[:, :, None])[:, :, 0] >= 0
    rows = j + torch.arange(n_seeds, device=dev)[None, :] * seg
    return torch.where(ok, rows, torch.full_like(rows, -1))


def seeded_candidates(neighbors, entry, vectors, scalars, pred_b, q_b, *,
                      beam_width: int, n_hops: int, metric: str = "dot"):
    """The walk from the graph's (E,) entry points plus each query's
    ``GRAPH_SEED_FACTOR·beam_width`` qualifying seeds. -> (cand (B, S)
    int32, S = E + GRAPH_SEED_FACTOR·beam_width + n_hops·beam_width·degree;
    n_visited (B,)) — the candidate pool the extraction scores."""
    seeds = qualifying_seeds(pred_b, scalars, GRAPH_SEED_FACTOR * beam_width)
    entry_b = torch.cat([
        entry.to(torch.int64)[None, :].expand(q_b.shape[0], -1), seeds], dim=1)
    return beam_candidates_batch(neighbors, vectors, scalars, entry_b, pred_b,
                                 q_b, beam_width=beam_width, n_hops=n_hops,
                                 metric=metric)


def beam_search_topk(neighbors, entry, vectors, scalars, pred_b, q_b, *,
                     k: int, beam_width: int, n_hops: int,
                     metric: str = "dot", block_s: int = GATHER_BLOCK_S):
    """Filtered top-k over the graph for a query batch.

    Each query's walk starts from the graph's entry points plus
    ``GRAPH_SEED_FACTOR·beam_width`` qualifying seeds; the result set is
    ONE fused gather+score+mask+top-k over every visited row. -> (ids (B,
    k), scores (B, k), n_scored (B,), n_qualified (B,)), the contract of
    ``ivf.search_local_batch``; ``n_scored`` is the visited-row count."""
    cand, n_visited = seeded_candidates(
        neighbors, entry, vectors, scalars, pred_b, q_b,
        beam_width=beam_width, n_hops=n_hops, metric=metric)
    w = torch.ones((q_b.shape[0], 1), dtype=torch.float32, device=q_b.device)
    ids, scores, n_qual = gather_score_topk(
        cand, (vectors,), (q_b,), w, scalars, pred_b, k=k, metric=metric,
        block_s=block_s)
    return ids, scores, n_visited, n_qual
