"""Histogram-based global selectivity estimation (paper §3.3).

Port of ``repro.vectordb.histogram``: per scalar column, equi-width bin
edges and a prefix-sum count array; a range is answered by two interpolated
prefix lookups and conjunctions multiply under independence. DNF sets
estimate the clause union by full inclusion–exclusion over the clause grid
(C <= 4: at most 11 intersection terms). Every function takes predicates
with leading batch dimensions.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from repro_torch.vectordb.predicates import PredicateLike, as_set


@dataclasses.dataclass
class Histograms:
    edges: torch.Tensor  # (M, B+1)
    prefix: torch.Tensor  # (M, B+1) cumulative counts, prefix[:, 0] = 0
    n_rows: torch.Tensor  # ()


def build(scalars: torch.Tensor, n_bins: int = 64) -> Histograms:
    """scalars: (n, M). Equi-width per column with a tiny epsilon pad so the
    max value falls inside the last bin."""
    n, m = scalars.shape
    lo = scalars.amin(dim=0)
    hi = scalars.amax(dim=0)
    span = torch.clamp(hi - lo, min=1e-9)
    ramp = torch.linspace(0.0, 1.0 + 1e-6, n_bins + 1, device=scalars.device)
    edges = lo[:, None] + span[:, None] * ramp[None, :]
    return Histograms(edges=edges, prefix=_binned_prefix(edges, scalars),
                      n_rows=torch.tensor(float(n), device=scalars.device))


def _binned_prefix(edges: torch.Tensor, scalars: torch.Tensor
                   ) -> torch.Tensor:
    """(M, B+1) cumulative counts of ``scalars`` (n, M) binned into
    ``edges``: ``searchsorted(right) - 1`` clipped to [0, B-1]."""
    m, n_bins = edges.shape[0], edges.shape[1] - 1
    idx = torch.searchsorted(edges.contiguous(),
                             scalars.T.contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, n_bins - 1)  # (M, n)
    counts = torch.zeros((m, n_bins), device=scalars.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    return torch.cat([torch.zeros((m, 1), device=scalars.device),
                      torch.cumsum(counts, dim=1)], dim=1)


def update(h: Histograms, scalars_new: torch.Tensor) -> Histograms:
    """Incremental maintenance on insert: the new rows (n_new, M) re-binned
    into the existing edges (kept — the paper's 'offline background'
    statistics) and their counts added to ``prefix``."""
    return Histograms(h.edges, h.prefix + _binned_prefix(h.edges, scalars_new),
                      h.n_rows + scalars_new.shape[0])


def _prefix_at(h: Histograms, x: torch.Tensor) -> torch.Tensor:
    """Interpolated cumulative count of values <= x, per column.
    x: (M, N) -> (M, N)."""
    e, p = h.edges, h.prefix
    b = p.shape[1] - 1
    idx = torch.clamp(torch.searchsorted(e.contiguous(), x.contiguous(),
                                         right=True) - 1, 0, b - 1)
    left, right = e.gather(1, idx), e.gather(1, idx + 1)
    frac = torch.clamp((x - left) / torch.clamp(right - left, min=1e-12),
                       0.0, 1.0)
    p0, p1 = p.gather(1, idx), p.gather(1, idx + 1)
    below = p0 + frac * (p1 - p0)
    below = torch.where(x < e[:, :1], torch.zeros_like(below), below)
    return torch.where(x >= e[:, -1:], p[:, -1:].expand_as(below), below)


def _clause_selectivity(h: Histograms, lo, hi, active) -> torch.Tensor:
    """Independence-product selectivity of conjunctive clauses.

    lo/hi/active: (..., M) -> (...). An empty range (hi < lo) contributes
    selectivity 0."""
    m = lo.shape[-1]
    lead = lo.shape[:-1]
    lo2 = lo.reshape(-1, m).T  # (M, N)
    hi2 = hi.reshape(-1, m).T
    act2 = active.reshape(-1, m).T
    p = h.prefix
    b = p.shape[1] - 1
    cnt = _prefix_at(h, hi2) - _prefix_at(h, lo2 - 1e-9)
    # point predicates (equality): interpolation of discrete mass is ~0;
    # answer with the containing bin's full count instead
    is_point = ((hi2 - lo2) <= 1e-12) & (hi2 >= lo2)
    idx = torch.clamp(torch.searchsorted(h.edges.contiguous(),
                                         lo2.contiguous(), right=True) - 1,
                      0, b - 1)
    bin_cnt = p.gather(1, idx + 1) - p.gather(1, idx)
    cnt = torch.where(is_point, bin_cnt, cnt)
    sel = torch.clamp(cnt / torch.clamp(p[:, -1:], min=1.0), 0.0, 1.0)
    sel = torch.where(hi2 < lo2, torch.zeros_like(sel), sel)
    sel = torch.where(act2, sel, torch.ones_like(sel))
    return torch.prod(sel, dim=0).reshape(lead)


def estimate_selectivity(h: Histograms, pred: PredicateLike) -> torch.Tensor:
    """σ_est ∈ [0, 1] per query (leading dims of the predicate fields).

    C=1: the independence product. C>=2: full inclusion–exclusion over the
    clause union, every r-way intersection being the conjunction of its
    per-column intersected ranges (inactive columns' bounds masked to ±inf
    first — evaluation never reads them); terms with a padding clause
    contribute 0."""
    ps = as_set(pred)
    sels = _clause_selectivity(h, ps.lo, ps.hi, ps.active)  # (..., C)
    sels = torch.where(ps.clause_valid, sels, torch.zeros_like(sels))
    c = ps.n_clauses
    if c == 1:
        return sels[..., 0]
    total = sels.sum(dim=-1)
    inf = torch.full_like(ps.lo, float("inf"))
    ilo = torch.where(ps.active, ps.lo, -inf)
    ihi = torch.where(ps.active, ps.hi, inf)
    for r in range(2, c + 1):
        sign = -1.0 if r % 2 == 0 else 1.0
        for combo in itertools.combinations(range(c), r):
            lo = ilo[..., combo[0], :]
            hi = ihi[..., combo[0], :]
            act = ps.active[..., combo[0], :]
            valid = ps.clause_valid[..., combo[0]]
            for ci in combo[1:]:
                lo = torch.maximum(lo, ilo[..., ci, :])
                hi = torch.minimum(hi, ihi[..., ci, :])
                act = act | ps.active[..., ci, :]
                valid = valid & ps.clause_valid[..., ci]
            total = total + sign * _clause_selectivity(h, lo, hi, act) \
                * valid.to(torch.float32)
    return torch.clamp(total, 0.0, 1.0)
