"""Columnar vector+scalar table — the storage substrate for MHQ.

Port of ``repro.vectordb.table``: N vector columns and a dense ``(n, M)``
float32 scalar matrix (categoricals carry integer codes, so every predicate
is a closed range). Tensors live on one device, the CUDA device unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ScalarCol:
    name: str
    kind: str  # "num" | "cat"
    n_categories: int = 0  # for "cat"


@dataclasses.dataclass(frozen=True)
class VectorCol:
    name: str
    dim: int


@dataclasses.dataclass(frozen=True)
class TableSchema:
    vector_cols: tuple
    scalar_cols: tuple
    metric: str = "dot"  # "dot" (higher=closer) | "l2" (lower=closer)

    @property
    def n_vec(self) -> int:
        return len(self.vector_cols)

    @property
    def n_scalar(self) -> int:
        return len(self.scalar_cols)

    def vec_index(self, name: str) -> int:
        return [v.name for v in self.vector_cols].index(name)


@dataclasses.dataclass
class Table:
    schema: TableSchema
    vectors: list  # one (n, d_i) f32 tensor per vector column
    scalars: torch.Tensor  # (n, M) float32
    # per-column symmetric int8 replica (the quantized scoring tier), built
    # lazily per column: vectors_i8[i] (n, d_i) int8, scales[i] (n,) f32
    vectors_i8: Optional[list] = None
    scales: Optional[list] = None

    @property
    def n_rows(self) -> int:
        return int(self.scalars.shape[0])

    @property
    def device(self) -> torch.device:
        return self.scalars.device

    def quantized(self, i: int) -> tuple:
        """The column's int8 replica, built on first use and cached.
        -> ((n, d_i) int8, (n,) f32 per-row scales). A cached replica whose
        row count is not the table's is never served: it was built for
        another table (one that shared this object's replica lists)."""
        if self.vectors_i8 is None:
            self.vectors_i8 = [None] * self.schema.n_vec
            self.scales = [None] * self.schema.n_vec
        if self.vectors_i8[i] is None:
            from repro_torch.kernels.int8_scan import quantize_rows

            self.vectors_i8[i], self.scales[i] = quantize_rows(self.vectors[i])
        vq, sc = self.vectors_i8[i], self.scales[i]
        if vq.shape[0] != self.n_rows or sc.shape[0] != self.n_rows:
            raise ValueError(f"column {i}: the cached int8 replica holds "
                             f"{vq.shape[0]} rows, the table {self.n_rows}")
        return vq, sc

    @staticmethod
    def from_numpy(schema: TableSchema, vectors: list, scalars: np.ndarray,
                   *, device=None) -> "Table":
        """Build a table on ``device`` (the CUDA device by default)."""
        dev = resolve_device(device)
        if len(vectors) != schema.n_vec:
            raise ValueError(f"{len(vectors)} vector columns, schema has "
                             f"{schema.n_vec}")
        n = scalars.shape[0]
        for v, c in zip(vectors, schema.vector_cols):
            if v.shape != (n, c.dim):
                raise ValueError(f"column {c.name}: shape {v.shape}, "
                                 f"expected {(n, c.dim)}")
        if scalars.shape != (n, schema.n_scalar):
            raise ValueError(f"scalars shape {scalars.shape}, expected "
                             f"{(n, schema.n_scalar)}")
        return Table(
            schema=schema,
            vectors=[torch.as_tensor(np.asarray(v, np.float32), device=dev)
                     for v in vectors],
            scalars=torch.as_tensor(np.asarray(scalars, np.float32),
                                    device=dev))

    def append(self, vectors: list, scalars: np.ndarray) -> "Table":
        """Immutable append: a new ``Table`` on the same device.

        The scale is per ROW, so an append never re-quantizes old rows: a
        column whose int8 replica is built carries over as (old replica ‖
        quantized new rows); a column never quantized stays unbuilt. The
        new table gets replica lists of its own, so a replica built later
        on this (old) table never reaches it."""
        dev = self.device
        new_vecs = [torch.as_tensor(np.asarray(v, np.float32), device=dev)
                    for v in vectors]
        new = Table(
            schema=self.schema,
            vectors=[torch.cat([a, b]) for a, b in zip(self.vectors,
                                                         new_vecs)],
            scalars=torch.cat([self.scalars, torch.as_tensor(
                np.asarray(scalars, np.float32), device=dev)]))
        if self.vectors_i8 is not None and any(
                q is not None for q in self.vectors_i8):
            from repro_torch.kernels.int8_scan import quantize_rows

            new.vectors_i8 = [None] * self.schema.n_vec
            new.scales = [None] * self.schema.n_vec
            for i, nv in enumerate(new_vecs):
                if self.vectors_i8[i] is None:
                    continue
                qn, sn = quantize_rows(nv)
                new.vectors_i8[i] = torch.cat([self.vectors_i8[i], qn])
                new.scales[i] = torch.cat([self.scales[i], sn])
        return new


def similarity(q: torch.Tensor, vecs: torch.Tensor, metric: str
               ) -> torch.Tensor:
    """Score rows of ``vecs`` (..., n, d) against ``q`` (..., d) -> (..., n).
    Higher = better; l2 is the expanded negative squared distance."""
    if q.dim() == 1 and vecs.dim() == 2:
        dots = vecs @ q
    else:
        dots = torch.einsum("...nd,...d->...n", vecs, q)
    if metric == "dot":
        return dots
    if metric == "l2":
        return (2.0 * dots - torch.sum(vecs * vecs, dim=-1)
                - torch.sum(q * q, dim=-1, keepdim=True))
    raise ValueError(f"unknown metric {metric!r}")


def similarity_batch(q_b: torch.Tensor, vecs: torch.Tensor, metric: str
                     ) -> torch.Tensor:
    """(B, n) similarities of every row of ``vecs`` (n, d) against every
    query of ``q_b`` (B, d) — one GEMM."""
    dots = q_b @ vecs.T
    if metric == "dot":
        return dots
    if metric == "l2":
        return (2.0 * dots - torch.sum(vecs * vecs, dim=-1)[None, :]
                - torch.sum(q_b * q_b, dim=-1, keepdim=True))
    raise ValueError(f"unknown metric {metric!r}")


def weighted_score(table: Table, query_vectors: list, weights,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Composite score Σ_i w_i · sim(q_i, o.v_i) (paper §1 definition)."""
    total = None
    for i, q in enumerate(query_vectors):
        vecs = table.vectors[i] if rows is None else table.vectors[i][rows]
        s = weights[i] * similarity(q, vecs, table.schema.metric)
        total = s if total is None else total + s
    return total
