"""Scalar predicates: DNF representation, evaluation and soft encodings.

Port of ``repro.vectordb.predicates``. ``Predicates`` is the single
conjunction (the C=1 shim): ``(..., M)`` active/lo/hi fields.
``PredicateSet`` is the general DNF: ``(..., C, M)`` active/lo/hi plus a
``(..., C)`` ``clause_valid`` mask, with C on the clause grid
``CLAUSE_GRID``. Leading dimensions are a batch of queries (what the JAX
package gets from ``vmap``); every function here accepts them.

Evaluation is OR over valid clauses of AND over that clause's active
columns; an inactive column always passes and an invalid (padding) clause
never matches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.device import resolve_device

CLAUSE_GRID = (1, 2, 4)
MAX_CLAUSES = CLAUSE_GRID[-1]


@dataclasses.dataclass
class Predicates:
    """Single conjunction over the M scalar columns (the C=1 shim)."""

    active: torch.Tensor  # (..., M) bool
    lo: torch.Tensor  # (..., M) f32
    hi: torch.Tensor  # (..., M) f32

    @staticmethod
    def none(m: int, *, device=None) -> "Predicates":
        dev = resolve_device(device)
        return Predicates(
            active=torch.zeros((m,), dtype=torch.bool, device=dev),
            lo=torch.full((m,), -np.inf, device=dev),
            hi=torch.full((m,), np.inf, device=dev))

    @staticmethod
    def from_conditions(m: int, conds: dict, *, device=None) -> "Predicates":
        active = np.zeros((m,), bool)
        lo = np.full((m,), -np.inf, np.float32)
        hi = np.full((m,), np.inf, np.float32)
        for idx, (l, h) in conds.items():
            active[idx] = True
            lo[idx] = l
            hi[idx] = h
        dev = resolve_device(device)
        return Predicates(torch.as_tensor(active, device=dev),
                          torch.as_tensor(lo, device=dev),
                          torch.as_tensor(hi, device=dev))


@dataclasses.dataclass
class PredicateSet:
    """DNF predicate set: OR over C conjunctive clauses, fields ``(C, M)``."""

    active: torch.Tensor  # (..., C, M) bool
    lo: torch.Tensor  # (..., C, M) f32
    hi: torch.Tensor  # (..., C, M) f32
    clause_valid: torch.Tensor  # (..., C) bool

    @property
    def n_clauses(self) -> int:
        return int(self.active.shape[-2])

    @staticmethod
    def none(m: int, clauses: int = 1, *, device=None) -> "PredicateSet":
        """Matches every row (one valid clause with no conditions)."""
        c = legalize_clause_count(clauses)
        dev = resolve_device(device)
        return PredicateSet(
            active=torch.zeros((c, m), dtype=torch.bool, device=dev),
            lo=torch.full((c, m), -np.inf, device=dev),
            hi=torch.full((c, m), np.inf, device=dev),
            clause_valid=torch.arange(c, device=dev) < 1)

    @staticmethod
    def from_clauses(m: int, clauses: list, *, n_clauses: int | None = None,
                     device=None) -> "PredicateSet":
        """Build from per-clause ``{col: (lo, hi)}`` dicts, padded onto the
        clause grid. An empty ``clauses`` list matches nothing."""
        c_real = len(clauses)
        c = legalize_clause_count(max(c_real, 1) if n_clauses is None
                                  else n_clauses)
        if c_real > c:
            raise ValueError(f"{c_real} clauses exceed requested bucket {c}")
        active = np.zeros((c, m), bool)
        lo = np.full((c, m), -np.inf, np.float32)
        hi = np.full((c, m), np.inf, np.float32)
        for ci, conds in enumerate(clauses):
            for idx, (l, h) in conds.items():
                active[ci, idx] = True
                lo[ci, idx] = l
                hi[ci, idx] = h
        dev = resolve_device(device)
        return PredicateSet(torch.as_tensor(active, device=dev),
                            torch.as_tensor(lo, device=dev),
                            torch.as_tensor(hi, device=dev),
                            torch.as_tensor(np.arange(c) < c_real,
                                            device=dev))


PredicateLike = Predicates | PredicateSet


def legalize_clause_count(c: int) -> int:
    """Smallest clause-grid bucket >= c."""
    for b in CLAUSE_GRID:
        if b >= c:
            return b
    raise ValueError(
        f"{c} clauses exceed the clause grid cap {MAX_CLAUSES}; simplify the "
        f"predicate or raise CLAUSE_GRID")


def as_set(pred: PredicateLike) -> PredicateSet:
    """Promote to the DNF form (``Predicates`` lifts to one valid clause)."""
    if isinstance(pred, PredicateSet):
        return pred
    active = pred.active.unsqueeze(-2)
    return PredicateSet(
        active=active, lo=pred.lo.unsqueeze(-2), hi=pred.hi.unsqueeze(-2),
        clause_valid=torch.ones(active.shape[:-1], dtype=torch.bool,
                                device=active.device))


def n_clauses(pred: PredicateLike) -> int:
    return pred.n_clauses if isinstance(pred, PredicateSet) else 1


def clause_bucket(pred: PredicateLike) -> int:
    """The legalized clause bucket — part of batched group keys."""
    return legalize_clause_count(n_clauses(pred))


def pad_clauses(ps: PredicateSet, c: int) -> PredicateSet:
    """Pad the clause axis (-2) to ``c`` with invalid clauses."""
    cur = ps.active.shape[-2]
    if cur == c:
        return ps
    if cur > c:
        raise ValueError(f"cannot shrink clause axis {cur} -> {c}")
    extra = c - cur

    def pad2(x, value):
        shape = list(x.shape)
        shape[-2] = extra
        return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                        device=x.device)], dim=-2)

    cv = ps.clause_valid
    return PredicateSet(
        active=pad2(ps.active, False), lo=pad2(ps.lo, -np.inf),
        hi=pad2(ps.hi, np.inf),
        clause_valid=torch.cat([cv, torch.zeros(
            cv.shape[:-1] + (extra,), dtype=torch.bool, device=cv.device)],
            dim=-1))


def active_any(pred: PredicateLike) -> torch.Tensor:
    """(..., M) bool — columns constrained in ANY valid clause."""
    if isinstance(pred, PredicateSet):
        return torch.any(pred.active & pred.clause_valid.unsqueeze(-1),
                         dim=-2)
    return pred.active


def stack(preds: list) -> PredicateLike:
    """Stack per-query predicates along a new leading batch axis.

    All-conjunctive lists stack as ``Predicates`` ((B, M) fields); any
    ``PredicateSet`` promotes the whole list, clause-padded to the common
    bucket, giving ``(B, C, M)`` fields + ``(B, C)`` validity."""
    if all(isinstance(p, Predicates) for p in preds):
        return Predicates(active=torch.stack([p.active for p in preds]),
                          lo=torch.stack([p.lo for p in preds]),
                          hi=torch.stack([p.hi for p in preds]))
    c = legalize_clause_count(max(n_clauses(p) for p in preds))
    sets = [pad_clauses(as_set(p), c) for p in preds]
    return PredicateSet(
        active=torch.stack([p.active for p in sets]),
        lo=torch.stack([p.lo for p in sets]),
        hi=torch.stack([p.hi for p in sets]),
        clause_valid=torch.stack([p.clause_valid for p in sets]))


def take(pred: PredicateLike, idx) -> PredicateLike:
    """Gather along the leading (batch) axis of a stacked predicate."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                          device=pred.active.device)
    return dataclasses.replace(
        pred, **{f.name: getattr(pred, f.name)[idx]
                 for f in dataclasses.fields(pred)})


def fold_conjunct(pred: PredicateLike, col_idx: int, lo: float,
                  hi: float) -> PredicateLike:
    """Intersect ``[lo, hi]`` on column ``col_idx`` into EVERY clause.

    How an implicit constraint (a tenant namespace) compiles into an
    existing predicate: the clause count, bucket and ``clause_valid`` stay
    as they are, so batched group keys do not change. A clause whose
    intersection is empty ends with ``lo > hi`` on an active column, which
    :func:`eval_mask` evaluates as matching nothing. Idempotent. Works on
    any leading (batch) dims; returns new tensors of the same type."""
    active = pred.active.clone()
    los = pred.lo.to(torch.float32).clone()
    his = pred.hi.to(torch.float32).clone()
    active[..., col_idx] = True
    los[..., col_idx] = torch.clamp(los[..., col_idx],
                                    min=float(np.float32(lo)))
    his[..., col_idx] = torch.clamp(his[..., col_idx],
                                    max=float(np.float32(hi)))
    if isinstance(pred, PredicateSet):
        return PredicateSet(active, los, his, pred.clause_valid)
    return Predicates(active, los, his)


def eval_mask(pred: PredicateLike, scalars: torch.Tensor) -> torch.Tensor:
    """DNF mask. ``scalars`` is ``(n, M)`` shared by every query, or
    ``(..., n, M)`` with the predicate's leading (batch) dims — e.g. each
    query's gathered candidate rows. -> ``(..., n)`` bool."""
    ps = as_set(pred)
    out = None
    for c in range(ps.n_clauses):
        lo = ps.lo[..., c:c + 1, :]  # (..., 1, M) against (..., n, M)
        hi = ps.hi[..., c:c + 1, :]
        act = ps.active[..., c:c + 1, :]
        ok = ((scalars >= lo) & (scalars <= hi)) | ~act
        clause = torch.all(ok, dim=-1) & ps.clause_valid[..., c:c + 1]
        out = clause if out is None else out | clause
    return out


def _encode_clauses(active, lo, hi, edges):
    """Per-clause scalar encoding (paper §3.2 rule on each conjunction).

    ``active/lo/hi``: (..., M); ``edges``: (M, B+1). A point value one-hots
    into its bin; a range spreads unit mass over the bins it overlaps; an
    inactive column is uniform. -> (..., M, B)."""
    e_lo, e_hi = edges[:, :-1], edges[:, 1:]  # (M, B)
    l, h = lo.unsqueeze(-1), hi.unsqueeze(-1)
    clo = torch.maximum(l, e_lo)
    chi = torch.minimum(h, e_hi)
    width = torch.clamp(e_hi - e_lo, min=1e-12)
    overlap = torch.clamp(chi - clo, min=0.0) / width
    point = (l >= e_lo) & (l <= e_hi)
    is_point = ((hi - lo) <= 1e-12) & (hi >= lo)
    mass = torch.where(is_point.unsqueeze(-1), point.to(torch.float32),
                       overlap)
    mass_sum = mass.sum(dim=-1, keepdim=True)
    uniform = torch.full_like(mass, 1.0 / mass.shape[-1])
    enc = torch.where(mass_sum > 0,
                      mass / torch.clamp(mass_sum, min=1e-12), uniform)
    return torch.where(active.unsqueeze(-1), enc, uniform)


def clause_weights(ps: PredicateSet, edges: torch.Tensor) -> torch.Tensor:
    """(..., C) normalized per-clause masses under the bin-uniform measure
    (invalid clauses weigh zero; all-zero mass falls back to uniform over
    the valid clauses)."""
    span = torch.clamp(edges[:, -1] - edges[:, 0], min=1e-12)  # (M,)
    b = edges.shape[1] - 1
    cov_lo = torch.maximum(ps.lo, edges[:, 0])
    cov_hi = torch.minimum(ps.hi, edges[:, -1])
    cov = torch.clamp(cov_hi - cov_lo, min=0.0) / span
    is_point = ((ps.hi - ps.lo) <= 1e-12) & (ps.hi >= ps.lo)
    cov = torch.where(is_point, torch.full_like(cov, 1.0 / b), cov)
    cov = torch.where(ps.active, cov, torch.ones_like(cov))
    mass = torch.prod(cov, dim=-1)  # (..., C)
    valid = ps.clause_valid
    mass = torch.where(valid, mass, torch.zeros_like(mass))
    total = mass.sum(dim=-1, keepdim=True)
    vf = valid.to(torch.float32)
    uniform = vf / torch.clamp(vf.sum(dim=-1, keepdim=True), min=1.0)
    return torch.where(total > 0, mass / torch.clamp(total, min=1e-12),
                       uniform)


def soft_encode(pred: PredicateLike, edges: torch.Tensor) -> torch.Tensor:
    """Paper §3.2 'Scalar Encoding' generalized to DNF: each clause is
    encoded with the conjunctive rule and the per-clause (M, B) masses fold
    with the normalized clause weights. -> (..., M, B)."""
    ps = as_set(pred)
    enc_c = _encode_clauses(ps.active, ps.lo, ps.hi, edges)  # (..., C, M, B)
    w = clause_weights(ps, edges)  # (..., C)
    return torch.einsum("...c,...cmb->...mb", w, enc_c)


def value_encode(values: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """One-hot bin encoding of concrete scalar values: (..., M) -> (..., M, B).

    ``searchsorted(side="right") - 1`` clipped to [0, B-1] — the binning
    rule of ``histogram.build``, so a value on an interior bin edge
    one-hots into the bin the selectivity stats count it in."""
    m = edges.shape[0]
    b = edges.shape[1] - 1
    flat = values.reshape(-1, m).transpose(0, 1).contiguous()  # (M, N)
    idx = torch.clamp(torch.searchsorted(edges.contiguous(), flat,
                                         right=True) - 1, 0, b - 1)
    idx = idx.transpose(0, 1).reshape(values.shape)
    return torch.nn.functional.one_hot(idx, b).to(torch.float32)
