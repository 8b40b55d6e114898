"""Predicate builder algebra: AND/OR/NOT/IN expressions that ``compile()``
to the static-shape DNF :class:`~repro_torch.vectordb.predicates.PredicateSet`.

Port of ``repro.vectordb.algebra``::

    from repro_torch.vectordb.algebra import col

    expr = col("price").between(10, 50) | (col("brand") == 3) \\
        & ~col("size").below(5)
    pred = expr.compile(table.schema, device=table.device)

Atoms are closed ranges ``[lo, hi]`` over the float32 scalar storage;
strict bounds (``<``, ``>``, NOT of a range) are exact via ``nextafter`` in
float32. Compilation pushes NOT down to the atoms, expands to DNF,
intersects conditions sharing a column, drops empty clauses, dedupes, and
pads the clause count onto ``CLAUSE_GRID``. A predicate that simplifies to
false compiles to a set whose single clause is invalid.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.vectordb.predicates import (
    MAX_CLAUSES, PredicateSet, legalize_clause_count,
)

# intermediate-expansion guard: DNF cross products may transiently exceed
# the final clause count before intersection/dedup collapses them
_EXPANSION_CAP = 256


def _f32(v) -> float:
    return float(np.float32(v))


def _next_below(v: float) -> float:
    return float(np.nextafter(np.float32(v), np.float32(-np.inf)))


def _next_above(v: float) -> float:
    return float(np.nextafter(np.float32(v), np.float32(np.inf)))


class Expr:
    """Base class: boolean composition plus compilation."""

    def __and__(self, other: "Expr") -> "Expr":
        return And((self, other))

    def __or__(self, other: "Expr") -> "Expr":
        return Or((self, other))

    def __invert__(self) -> "Expr":
        return Not(self)

    def compile(self, schema=None, *, m: int | None = None,
                n_clauses: int | None = None, device=None) -> PredicateSet:
        """Compile to a clause-grid-legalized ``PredicateSet`` on
        ``device`` (the CUDA device by default)."""
        return compile(self, schema, m=m, n_clauses=n_clauses, device=device)


@dataclasses.dataclass(frozen=True)
class Cond(Expr):
    """Atomic closed-range condition ``col ∈ [lo, hi]``."""

    col: int | str
    lo: float
    hi: float


@dataclasses.dataclass(frozen=True)
class And(Expr):
    parts: tuple


@dataclasses.dataclass(frozen=True)
class Or(Expr):
    parts: tuple


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    part: Expr


class ColumnRef:
    """Named/indexed column handle producing atomic conditions."""

    __slots__ = ("_col",)

    def __init__(self, column: int | str):
        self._col = column

    def between(self, lo, hi) -> Cond:
        """Closed range ``lo <= x <= hi``."""
        return Cond(self._col, _f32(lo), _f32(hi))

    def isin(self, values) -> Expr:
        """IN-list: equality with any of ``values`` (one clause each)."""
        vals = [_f32(v) for v in values]
        if not vals:
            return Or(())  # empty IN-list is false
        return Or(tuple(Cond(self._col, v, v) for v in vals))

    def below(self, v) -> Cond:
        """Strict ``x < v``."""
        return Cond(self._col, -np.inf, _next_below(v))

    def above(self, v) -> Cond:
        """Strict ``x > v``."""
        return Cond(self._col, _next_above(v), np.inf)

    def __eq__(self, v) -> Cond:  # type: ignore[override]
        return Cond(self._col, _f32(v), _f32(v))

    def __ne__(self, v) -> Expr:  # type: ignore[override]
        return Not(Cond(self._col, _f32(v), _f32(v)))

    def __le__(self, v) -> Cond:
        return Cond(self._col, -np.inf, _f32(v))

    def __lt__(self, v) -> Cond:
        return self.below(v)

    def __ge__(self, v) -> Cond:
        return Cond(self._col, _f32(v), np.inf)

    def __gt__(self, v) -> Cond:
        return self.above(v)

    __hash__ = None  # rich __eq__ builds conditions; refs are not hashable


def col(column: int | str) -> ColumnRef:
    """Entry point of the builder: ``col("price")`` or ``col(3)``."""
    return ColumnRef(column)


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

def _negate(e: Expr) -> Expr:
    """Push one NOT through ``e`` (De Morgan down to the atoms)."""
    if isinstance(e, Not):
        return e.part
    if isinstance(e, And):
        return Or(tuple(_negate(p) for p in e.parts))
    if isinstance(e, Or):
        return And(tuple(_negate(p) for p in e.parts))
    if not isinstance(e, Cond):
        raise TypeError(f"not a predicate expression: {e!r}")
    parts = []
    if np.isfinite(e.lo):
        parts.append(Cond(e.col, -np.inf, _next_below(e.lo)))
    if np.isfinite(e.hi):
        parts.append(Cond(e.col, _next_above(e.hi), np.inf))
    return Or(tuple(parts))  # empty (full-range atom) -> false


def _intersect(clause: dict, cond: Cond) -> dict | None:
    """Merge an atom into a conjunctive clause; None = empty clause."""
    lo, hi = clause.get(cond.col, (-np.inf, np.inf))
    lo, hi = max(lo, cond.lo), min(hi, cond.hi)
    if lo > hi:
        return None
    out = dict(clause)
    out[cond.col] = (lo, hi)
    return out


def _dnf(e: Expr) -> list:
    """-> clauses as {col: (lo, hi)} dicts (empty list = false)."""
    if isinstance(e, Not):
        return _dnf(_negate(e.part))
    if isinstance(e, Cond):
        return [{e.col: (e.lo, e.hi)}]
    if isinstance(e, Or):
        out = []
        for p in e.parts:
            out.extend(_dnf(p))
            if len(out) > _EXPANSION_CAP:
                raise ValueError("predicate DNF expansion too large")
        return _dedupe(out)
    if not isinstance(e, And):
        raise TypeError(f"not a predicate expression: {e!r}")
    clauses: list = [{}]
    for p in e.parts:
        nxt = []
        for pc in _dnf(p):
            for c in clauses:
                merged = c
                for ccol, (lo, hi) in pc.items():
                    merged = _intersect(merged, Cond(ccol, lo, hi))
                    if merged is None:
                        break
                if merged is not None:
                    nxt.append(merged)
            if len(nxt) > _EXPANSION_CAP:
                raise ValueError("predicate DNF expansion too large")
        clauses = nxt
        if not clauses:
            return []
    return _dedupe(clauses)


def _dedupe(clauses: list) -> list:
    seen, out = set(), []
    for c in clauses:
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def _resolve(clauses: list, schema, m: int | None) -> tuple:
    names = {}
    if schema is not None:
        names = {sc.name: i for i, sc in enumerate(schema.scalar_cols)}
        m = len(schema.scalar_cols)
    if m is None:
        raise ValueError("compile() needs a schema or m=<n_scalar_columns>")
    out = []
    for c in clauses:
        rc = {}
        for key, rng in c.items():
            if isinstance(key, str):
                if key not in names:
                    raise KeyError(f"unknown scalar column {key!r}")
                idx = names[key]
            else:
                idx = int(key)
            if not 0 <= idx < m:
                raise IndexError(f"scalar column {idx} out of range [0, {m})")
            if idx in rc:  # two names aliasing one index: intersect
                lo, hi = rc[idx]
                rng = (max(lo, rng[0]), min(hi, rng[1]))
            rc[idx] = rng
        out.append(rc)
    return out, m


def constrain(pred, cond: Cond, schema=None, *, m: int | None = None):
    """Fold an atomic condition conjunctively into EVERY clause of an
    already-compiled predicate (``Predicates`` or ``PredicateSet``) — the
    compile step of implicit constraints such as tenant namespaces. The
    column resolves as in :func:`compile` (a name against
    ``schema.scalar_cols`` or an index against ``m``)."""
    from repro_torch.vectordb.predicates import fold_conjunct

    resolved, _ = _resolve([{cond.col: (cond.lo, cond.hi)}], schema,
                           m if m is not None else pred.active.shape[-1])
    ((idx, (lo, hi)),) = resolved[0].items()
    return fold_conjunct(pred, idx, lo, hi)


def compile(expr: Expr, schema=None, *, m: int | None = None,
            n_clauses: int | None = None, device=None) -> PredicateSet:
    """Compile an expression tree to a ``PredicateSet`` (see module doc)."""
    if isinstance(expr, ColumnRef):
        raise TypeError("a bare col(...) is not a predicate; add a condition")
    clauses = _dnf(expr)
    clauses, m = _resolve(clauses, schema, m)
    if len(clauses) > MAX_CLAUSES:
        raise ValueError(
            f"predicate compiles to {len(clauses)} DNF clauses, more than the "
            f"clause-grid cap {MAX_CLAUSES}; simplify the expression")
    if n_clauses is not None:
        n_clauses = legalize_clause_count(max(n_clauses, len(clauses)))
    return PredicateSet.from_clauses(m, clauses, n_clauses=n_clauses,
                                     device=device)
