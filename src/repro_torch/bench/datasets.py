"""The benchmark dataset registry (paper Table 1), offline-reproducible.

Port of ``repro.bench.datasets``. Each entry reproduces its set's SHAPE
(dims preserved, row counts scalable up to the paper's) and CHARACTER:
  * v+s / v->s sets: Gaussian-mixture vectors (clusterable, like real
    embeddings) + the paper's three correlated-scalar constructions
    (``augment.augment_with_scalars``);
  * s->v sets, which include TPC-H Part: realistic scalar marginals (Zipf
    categoricals, lognormal and uniform numerics) plus correlated
    embeddings of them (``augment.hash_embed``).
The data is generated in numpy exactly as the JAX package generates it,
then placed on the device; only ``cluster_id`` (the port's own k-means)
differs from the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.bench.augment import augment_with_scalars, hash_embed
from repro_torch.common.device import resolve_device
from repro_torch.vectordb.table import ScalarCol, Table, TableSchema, VectorCol


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    kind: str  # "v+s" | "v->s" | "s->v"
    paper_rows: int
    dims: tuple  # one entry per vector column
    n_vec_queries: int = 1  # 2 for Part / Aka_title (multi-vector MHQs)


SPECS: dict = {
    "fungis": DatasetSpec("fungis", "v+s", 295_938, (768,)),
    "sift": DatasetSpec("sift", "v->s", 1_000_000, (128,)),
    "glove": DatasetSpec("glove", "v->s", 1_183_514, (100,)),
    "deep1b": DatasetSpec("deep1b", "v->s", 9_990_000, (96,)),
    "aka_title": DatasetSpec("aka_title", "s->v", 361_472, (768, 768), 2),
    "title": DatasetSpec("title", "s->v", 2_528_312, (768,)),
    "aka_name": DatasetSpec("aka_name", "s->v", 901_343, (768,)),
    "part": DatasetSpec("part", "s->v", 200_000, (768, 768), 2),
    "partsupp": DatasetSpec("partsupp", "s->v", 800_000, (768,)),
    "orders": DatasetSpec("orders", "s->v", 1_500_000, (768,)),
    "lineitem": DatasetSpec("lineitem", "s->v", 6_000_000, (768,)),
}


def _mixture_vectors(n: int, dim: int, *, n_comp: int = 24, seed: int = 0,
                     spread: float = 0.35) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(n_comp, dim)).astype(np.float32)
    comp = rng.integers(0, n_comp, n)
    v = mus[comp] + spread * rng.normal(size=(n, dim)).astype(np.float32)
    return v.astype(np.float32)


def _scalar_table(n: int, seed: int) -> tuple:
    """TPC-H/IMDb-flavoured scalar columns: two Zipf categoricals, a
    lognormal 'size' and a uniform 'price'."""
    rng = np.random.default_rng(seed)
    cat1 = np.minimum(rng.zipf(1.5, n) - 1, 24).astype(np.float32)
    cat2 = np.minimum(rng.zipf(1.3, n) - 1, 49).astype(np.float32)
    size = rng.lognormal(1.0, 0.6, n).astype(np.float32)
    price = rng.uniform(1.0, 1000.0, n).astype(np.float32)
    cols = [ScalarCol("category", "cat", 25), ScalarCol("brand", "cat", 50),
            ScalarCol("size", "num"), ScalarCol("price", "num")]
    return np.stack([cat1, cat2, size, price], axis=1), cols


def make(name: str, *, rows: int = 20_000, seed: int = 0,
         metric: str = "dot", device=None) -> Table:
    """A fully built ``Table`` on ``device`` (the CUDA device by default;
    the v->s sets' k-means runs there too)."""
    spec = SPECS[name]
    dev = resolve_device(device)
    n = min(rows, spec.paper_rows)
    if spec.kind in ("v+s", "v->s"):
        vectors = [_mixture_vectors(n, d, seed=seed + i)
                   for i, d in enumerate(spec.dims)]
        scalars, cols = augment_with_scalars(vectors[0], seed=seed,
                                             device=dev)
        if spec.kind == "v+s":  # fungis: extra native metadata column
            rng = np.random.default_rng(seed + 3)
            extra = (scalars[:, 0] * 2.0 + rng.normal(0, 1.0, n)).astype(
                np.float32)
            scalars = np.concatenate([scalars, extra[:, None]], axis=1)
            cols = cols + [ScalarCol("obs_count", "num")]
    else:  # s->v
        scalars, cols = _scalar_table(n, seed)
        vectors = [hash_embed(scalars, d, seed=seed + 11 * (i + 1),
                              noise=0.25 + 0.1 * i)
                   for i, d in enumerate(spec.dims)]
    schema = TableSchema(
        vector_cols=tuple(VectorCol(f"vec{i}", d)
                          for i, d in enumerate(spec.dims)),
        scalar_cols=tuple(cols), metric=metric)
    return Table.from_numpy(schema, vectors, scalars, device=dev)


def table_row(name: str) -> dict:
    """The set's row of the paper's Table 1."""
    s = SPECS[name]
    return {"Benchmark": name, "Type": s.kind, "Rows": s.paper_rows,
            "Dimension": "/".join(str(d) for d in s.dims)}
