"""Query workload generation (paper §4 'Query Generation').

Port of ``repro.bench.queries``: query vectors uniform within each
dimension's data range, predicates over a random subset of scalar columns,
the predicate SELECTIVITY stratified ~uniformly over [0, 1] by
oversample-then-flatten, and w₁ ~ U[0,1], w₂ = 1 − w₁ for two-vector MHQs.
``gen_dnf_workload`` emits OR-of-ranges / IN-list / NOT predicates through
the builder algebra. Every random draw is numpy ``default_rng`` in the same
order as the JAX package, so the same seed gives the same workload.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.query import MHQ
from repro_torch.vectordb.algebra import col
from repro_torch.vectordb.predicates import Predicates, eval_mask
from repro_torch.vectordb.table import Table


def _selectivity(table: Table, pred) -> float:
    """Exact qualifying fraction, rounded as float32 count / n."""
    cnt = int(eval_mask(pred, table.scalars).sum())
    return float(np.float32(cnt) / np.float32(table.n_rows))


def _random_predicates(table: Table, scal: np.ndarray, rng) -> Predicates:
    m = table.schema.n_scalar
    n_active = rng.integers(1, m + 1)
    cols = rng.choice(m, size=n_active, replace=False)
    conds = {}
    for c in cols:
        column = table.schema.scalar_cols[c]
        if column.kind == "cat":
            v = float(rng.choice(scal[:, c]))
            conds[int(c)] = (v, v)  # equality
        else:
            lo, hi = scal[:, c].min(), scal[:, c].max()
            a, b = sorted(rng.uniform(lo, hi, size=2))
            kind = rng.integers(0, 3)
            if kind == 0:
                conds[int(c)] = (float(a), float(b))  # closed range
            elif kind == 1:
                conds[int(c)] = (-np.inf, float(b))  # x < b
            else:
                conds[int(c)] = (float(a), np.inf)  # x > a
    return Predicates.from_conditions(m, conds, device=table.device)


def _random_range(scal, c, rng):
    lo, hi = scal[:, c].min(), scal[:, c].max()
    a, b = sorted(rng.uniform(lo, hi, size=2))
    return col(int(c)).between(float(a), float(b))


def _random_dnf_expr(table: Table, scal: np.ndarray, rng, *, n_clauses: int):
    """A random builder expression whose DNF has ~``n_clauses`` clauses
    (IN-list, OR of ranges, IN-list ∧ range, NOT of a range), optionally
    AND-ed with one extra range condition."""
    m = table.schema.n_scalar
    cats = [i for i in range(m) if table.schema.scalar_cols[i].kind == "cat"]
    nums = [i for i in range(m) if table.schema.scalar_cols[i].kind == "num"]

    def in_list(size):
        c = int(rng.choice(cats))
        vals = np.unique(scal[:, c])
        pick = rng.choice(vals, size=min(size, len(vals)), replace=False)
        return col(c).isin([float(v) for v in pick])

    shape = rng.integers(0, 4)
    if shape == 0 and cats:  # plain IN-list
        expr = in_list(n_clauses)
    elif shape == 1 and nums:  # OR of ranges
        parts = [_random_range(scal, int(rng.choice(nums)), rng)
                 for _ in range(n_clauses)]
        expr = parts[0]
        for p in parts[1:]:
            expr = expr | p
    elif shape == 2 and cats and nums:  # IN-list ∧ range
        expr = in_list(n_clauses) & _random_range(
            scal, int(rng.choice(nums)), rng)
    else:  # NOT of a range (≤ 2 clauses), widened toward n_clauses by ORs
        c = int(rng.choice(nums)) if nums else 0
        expr = ~_random_range(scal, c, rng)
        if n_clauses > 2 and nums:
            expr = expr | _random_range(scal, int(rng.choice(nums)), rng)
    if rng.random() < 0.5 and nums:  # extra conjunct: intersects every clause
        expr = expr & _random_range(scal, int(rng.choice(nums)), rng)
    return expr


def _stratify(pool: list, n_queries: int, stratify_bins: int) -> list:
    """Flatten the selectivity histogram of (sel, pred) pairs, then
    round-robin fill from the rest."""
    bins = [[] for _ in range(stratify_bins)]
    for sel, pred in pool:
        b = min(int(sel * stratify_bins), stratify_bins - 1)
        bins[b].append((sel, pred))
    cap = max(1, n_queries // stratify_bins)
    chosen, chosen_ids = [], set()
    for b in bins:
        for item in b[:cap]:
            chosen.append(item)
            chosen_ids.add(id(item))
    for b in bins:
        for item in b[cap:]:
            if len(chosen) >= n_queries:
                break
            if id(item) not in chosen_ids:
                chosen.append(item)
                chosen_ids.add(id(item))
    return chosen[:n_queries]


def _attach_vectors(table: Table, chosen: list, rng, *, n_vec_used: int,
                    k: int, recall_target: float) -> list:
    n_vec = table.schema.n_vec
    # each column's per-dimension data range, read once per workload
    ranges = [(v.amin(dim=0).cpu().numpy(), v.amax(dim=0).cpu().numpy())
              for v in table.vectors]
    out = []
    for sel, pred in chosen:
        qs = tuple(torch.as_tensor(rng.uniform(lo, hi).astype(np.float32),
                                   device=table.device)
                   for lo, hi in ranges)
        if n_vec_used == 1 or n_vec == 1:
            weights = tuple(1.0 if i == 0 else 0.0 for i in range(n_vec))
        else:
            w1 = float(rng.uniform(0.0, 1.0))
            weights = (w1, 1.0 - w1) + tuple(0.0 for _ in range(n_vec - 2))
        out.append(MHQ(query_vectors=qs, weights=weights, predicates=pred,
                       k=k, recall_target=recall_target))
    return out


def gen_workload(table: Table, n_queries: int, *, n_vec_used: int = 1,
                 k: int = 10, recall_target: float = 0.9, seed: int = 0,
                 stratify_bins: int = 10, oversample: int = 6) -> list:
    """Selectivity-stratified conjunctive workload. ``n_vec_used`` ∈ {1, 2}."""
    rng = np.random.default_rng(seed)
    scal = table.scalars.cpu().numpy()
    pool = []
    for _ in range(n_queries * oversample):
        pred = _random_predicates(table, scal, rng)
        pool.append((_selectivity(table, pred), pred))
    chosen = _stratify(pool, n_queries, stratify_bins)
    return _attach_vectors(table, chosen, rng, n_vec_used=n_vec_used, k=k,
                           recall_target=recall_target)


def gen_dnf_workload(table: Table, n_queries: int, *, n_vec_used: int = 1,
                     k: int = 10, recall_target: float = 0.9, seed: int = 0,
                     clause_counts=(2, 3, 4), stratify_bins: int = 10,
                     oversample: int = 6) -> list:
    """Selectivity-stratified DNF workload (OR-of-ranges, IN-lists, NOTs)."""
    rng = np.random.default_rng(seed)
    scal = table.scalars.cpu().numpy()
    pool = []
    while len(pool) < n_queries * oversample:
        nc = int(rng.choice(clause_counts))
        expr = _random_dnf_expr(table, scal, rng, n_clauses=nc)
        try:
            pred = expr.compile(table.schema, device=table.device)
        except ValueError:  # blew the clause grid — resample
            continue
        pool.append((_selectivity(table, pred), pred))
    chosen = _stratify(pool, n_queries, stratify_bins)
    return _attach_vectors(table, chosen, rng, n_vec_used=n_vec_used, k=k,
                           recall_target=recall_target)


def workload_selectivities(table: Table, workload) -> np.ndarray:
    """Exact qualifying fraction of each query's predicate on ``table``."""
    return np.asarray([_selectivity(table, q.predicates) for q in workload])
