"""Plain PyTorch versions of the kernels (the correctness contract).

``gather_score_ref`` is the CPU path of ``gather_score.gather_score_topk``;
``masked_topk_ref`` and ``int8_topk_ref`` are the CPU paths of
``ops.masked_topk`` and ``ops.int8_masked_topk``. Each is the yardstick its
CUDA kernel is held to on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.shapes import NEG


def masked_topk_ref(q, vectors, scalars, lo, hi, active, n_rows, *, k: int,
                    metric: str = "dot"):
    """Exact full-table filtered top-k under a conjunctive (M,) range
    predicate; rows at or past ``n_rows`` never qualify. l2 scores
    ``2q·v - ‖v‖²`` (the query's constant norm is dropped). Ties go by
    (-score, id). -> (scores (k,), ids (k,) int32); empty slots hold
    score NEG and id -1."""
    from repro_torch.vectordb.flat import topk_stable

    n = vectors.shape[0]
    masked = scan_scores_ref(q, vectors, scalars, lo, hi, active, n_rows,
                             metric=metric)
    if n < k:  # fewer rows than slots: the rest are empty
        masked = torch.cat([masked, torch.full((k - n,), NEG,
                                               device=q.device)])
    top, ids = topk_stable(masked, k)  # stable: equal scores by row id
    live = top > NEG / 2
    return (torch.where(live, top, torch.full_like(top, NEG)),
            torch.where(live, ids, torch.full_like(ids, -1)).to(torch.int32))


def scan_scores_ref(q, vectors, scalars, lo, hi, active, n_rows, *,
                    metric: str = "dot"):
    """Every row's score under ``masked_topk_ref``'s formula and predicate,
    NEG where the row does not qualify. -> (n,)."""
    n = vectors.shape[0]
    scores = vectors @ q
    if metric == "l2":
        scores = 2.0 * scores - torch.sum(vectors * vectors, dim=1)
    ok = ((scalars >= lo) & (scalars <= hi)) \
        | (active.to(torch.float32) < 0.5)
    ok = torch.all(ok, dim=1) & (torch.arange(n, device=q.device) < n_rows)
    return torch.where(ok, scores, torch.full_like(scores, NEG))


def int8_topk_ref(q, vec_i8, scales, scalars, lo, hi, active, n_rows, *,
                  k: int):
    """The quantized scan's plain version: dequantize, then the exact
    dot-metric ``masked_topk_ref``."""
    deq = vec_i8.to(torch.float32) * scales[:, None]
    return masked_topk_ref(q, deq, scalars, lo, hi, active, n_rows, k=k,
                           metric="dot")


def gather_score_ref(cand, vectors, qs, weights, scalars, lo, hi, active,
                     clause_valid, *, k: int, metric: str = "dot",
                     apply_pred: bool = True, scales=None):
    """Candidate-local gather+score+DNF-mask+top-k, plain tensors.

    cand (B, S) int32 rows (-1 = padding, duplicates allowed); vectors/qs
    per-column tuples of (n, d_i) / (B, d_i); weights (B, n_vec); DNF
    fields (B, C, M) f32 + (B, C) f32. With ``scales`` (per-column (n,) f32)
    the vectors are int8 replicas and each gathered row's score is scaled
    by its dequant factor. -> (ids (B, k) int32, scores (B, k),
    n_qualified (B,)); duplicate ids are suppressed and ties break by the
    smaller row id."""
    from repro_torch.kernels.gather_score import merge_topk_unique

    b, s_tot = cand.shape
    if s_tot < k:  # selection needs at least k slots
        cand = torch.cat([cand, torch.full((b, k - s_tot), -1,
                                           dtype=cand.dtype,
                                           device=cand.device)], dim=1)
    cand = cand.to(torch.int32)
    masked, qual = gather_scores_ref(cand, vectors, qs, weights, scalars, lo,
                                     hi, active, clause_valid, metric=metric,
                                     apply_pred=apply_pred, scales=scales)
    ids, scores = merge_topk_unique(cand, masked, k)
    return ids, scores, qual.sum(dim=1)


def gather_scores_ref(cand, vectors, qs, weights, scalars, lo, hi, active,
                      clause_valid, *, metric: str = "dot",
                      apply_pred: bool = True, scales=None):
    """Every slot's score under ``gather_score_ref``'s formula and mask,
    before selection. -> (scores (B, S), NEG where the slot is padding or
    fails the predicate; qualifying flags (B, S))."""
    n = scalars.shape[0]
    idc = torch.clamp(cand, 0, n - 1).long()
    valid = cand >= 0
    total = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    for i, (v, q) in enumerate(zip(vectors, qs)):
        g = v[idc]  # (B, S, d) — int8 when quantized
        if scales is not None:
            gf = g.to(torch.float32)
            sc = scales[i][idc]  # (B, S)
            s = torch.einsum("bsd,bd->bs", gf, q) * sc
            if metric == "l2":
                s = (2.0 * s - sc * sc * torch.sum(gf * gf, dim=-1)
                     - torch.sum(q * q, dim=-1)[:, None])
        else:
            s = torch.einsum("bsd,bd->bs", g, q)
            if metric == "l2":
                s = (2.0 * s - torch.sum(g * g, dim=-1)
                     - torch.sum(q * q, dim=-1)[:, None])
        total = total + weights[:, i:i + 1] * s
    if apply_pred:
        st = scalars[idc][:, :, None, :]  # (B, S, 1, M)
        ok_cm = ((st >= lo[:, None]) & (st <= hi[:, None])) \
            | (active[:, None] < 0.5)  # (B, S, C, M)
        clause = torch.all(ok_cm, dim=-1) & (clause_valid[:, None, :] > 0.5)
        ok = torch.any(clause, dim=-1)
    else:
        ok = torch.ones(cand.shape, dtype=torch.bool, device=cand.device)
    qual = ok & valid
    return torch.where(qual, total, torch.full_like(total, NEG)), qual
