"""IVF, flat and executor parity between the JAX package and the port.

A JAX-built ``IVFIndex`` is carried across with ``repro_torch.convert``;
on the same table and the same workload (the port's generators reproduce
the JAX package's draws) the port's ``search``, ``search_local_batch``,
``filter_first_local_batch`` and ``HybridExecutor.execute`` must return the
same ids, with scores to ``atol=1e-4`` (float reduction order). The port's
own k-means is held to the ``FLOOR=0.95`` oracle recall of
``tests/test_oracle.py`` at generous budgets, and ``rrf_extras`` to its
docstring's (-fused, id) order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax.numpy as jnp  # noqa: E402

from oracle import brute_force_topk, tie_aware_recall  # noqa: E402

from repro.bench import datasets as jds  # noqa: E402
from repro.bench import queries as jq  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.core.query import ExecutionPlan as JPlan  # noqa: E402
from repro.core.query import SubqueryParams as JSub  # noqa: E402
from repro.vectordb import flat as jflat  # noqa: E402
from repro.vectordb import ivf as jivf  # noqa: E402
from repro.vectordb import predicates as jp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.bench import datasets as tds  # noqa: E402
from repro_torch.bench import queries as tq  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core.query import ExecutionPlan as TPlan  # noqa: E402
from repro_torch.core.query import SubqueryParams as TSub  # noqa: E402
from repro_torch.vectordb import flat as tflat  # noqa: E402
from repro_torch.vectordb import ivf as tivf  # noqa: E402
from repro_torch.vectordb import predicates as tp  # noqa: E402

FLOOR = 0.95
SCORE_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def tables():
    jt = jds.make("part", rows=1500, seed=0)
    tt = tds.make("part", rows=1500, seed=0, device="cpu")
    return jt, tt


@pytest.fixture(scope="module")
def workloads(tables):
    jt, tt = tables
    jw = jq.gen_workload(jt, 5, n_vec_used=2, seed=31) + \
        jq.gen_dnf_workload(jt, 5, n_vec_used=2, seed=32)
    tw = tq.gen_workload(tt, 5, n_vec_used=2, seed=31) + \
        tq.gen_dnf_workload(tt, 5, n_vec_used=2, seed=32)
    return jw, tw


@pytest.fixture(scope="module")
def carried(tables):
    jt, tt = tables
    jidx = [jivf.build(v, 16, seed=i, metric=jt.schema.metric)
            for i, v in enumerate(jt.vectors)]
    tidx = [convert.ivf_index(np.asarray(x.centroids),
                              np.asarray(x.sorted_rows),
                              np.asarray(x.offsets), x.metric, device="cpu")
            for x in jidx]
    return jidx, tidx


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_tables_and_workloads_are_the_same(tables, workloads):
    jt, tt = tables
    for a, b in zip(jt.vectors, tt.vectors):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jt.scalars), tt.scalars.numpy())
    for qj, qt in zip(*workloads):
        assert qj.weights == qt.weights
        for a, b in zip(qj.query_vectors, qt.query_vectors):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for f in ("active", "lo", "hi"):
            np.testing.assert_array_equal(np.asarray(getattr(qj.predicates, f)),
                                          _np(getattr(qt.predicates, f)))


def test_search_on_carried_index_matches_jax(tables, workloads, carried):
    jt, tt = tables
    jidx, tidx = carried
    for qj, qt in zip(*workloads):
        for col in (0, 1):
            for nprobe, max_scan, k in ((2, 256, 10), (8, 1500, 32)):
                a = jivf.search(jidx[col], jt.vectors[col], jt.scalars,
                                qj.predicates, qj.query_vectors[col],
                                nprobe=nprobe, max_scan=max_scan, k=k)
                b = tivf.search(tidx[col], tt.vectors[col], tt.scalars,
                                qt.predicates, qt.query_vectors[col],
                                nprobe=nprobe, max_scan=max_scan, k=k)
                np.testing.assert_array_equal(_np(a[0]), _np(b[0]))
                np.testing.assert_allclose(_np(b[1]), _np(a[1]), **SCORE_TOL)
                assert int(a[2]) == int(b[2]) and int(a[3]) == int(b[3])


def test_local_batch_paths_on_carried_index_match_jax(tables, workloads,
                                                      carried):
    jt, tt = tables
    jidx, tidx = carried
    jw, tw = workloads
    pj = jp.stack([q.predicates for q in jw])
    pt = tp.stack([q.predicates for q in tw])
    qj = jnp.stack([q.query_vectors[0] for q in jw])
    qt = torch.stack([q.query_vectors[0] for q in tw])
    a = jivf.search_local_batch(jidx[0], jt.vectors[0], jt.scalars, pj, qj,
                                nprobe=4, max_scan=512, k=16)
    b = tivf.search_local_batch(tidx[0], tt.vectors[0], tt.scalars, pt, qt,
                                nprobe=4, max_scan=512, k=16)
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(y), _np(x), **SCORE_TOL)
    np.testing.assert_array_equal(_np(a[0]), _np(b[0]))
    w = np.asarray([q.weights for q in jw], np.float32)
    qvj = tuple(jnp.stack([q.query_vectors[i] for q in jw]) for i in (0, 1))
    qvt = tuple(torch.stack([q.query_vectors[i] for q in tw]) for i in (0, 1))
    a = jflat.filter_first_local_batch(
        tuple(jt.vectors), jt.scalars, pj, qvj, jnp.asarray(w), k=10,
        max_candidates=256, n_vec=2, metric=jt.schema.metric)
    b = tflat.filter_first_local_batch(
        tuple(tt.vectors), tt.scalars, pt, qvt, torch.as_tensor(w), k=10,
        max_candidates=256, n_vec=2, metric=tt.schema.metric)
    np.testing.assert_array_equal(_np(a[0]), _np(b[0]))
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_allclose(_np(y), _np(x), **SCORE_TOL)


PLANS = [
    ("filter_first", {}, "fp32", 0),
    ("index_scan", dict(k_mult=2, nprobe=2, max_scan=2048), "fp32", 0),
    ("index_scan", dict(k_mult=8, nprobe=1, max_scan=8192), "fp32", 0),
    ("index_scan", dict(k_mult=2, nprobe=8, max_scan=131072), "int8", 0),
    ("single_index", dict(k_mult=8, nprobe=8, max_scan=32768), "fp32", 1),
    ("graph", dict(k_mult=2, nprobe=4, max_scan=8192), "fp32", 0),
]


@pytest.mark.parametrize("strategy,knobs,precision,dominant", PLANS)
def test_hybrid_executor_matches_jax(tables, workloads, carried, strategy,
                                     knobs, precision, dominant):
    """Sequential execution on carried indexes: filter-first, iterative
    index scans with the RRF union, the int8 tier, single-index, and a
    graph plan legalized to index_scan (no graph tier bound)."""
    jt, tt = tables
    jidx, tidx = carried
    jx = jex.HybridExecutor(jt, jidx)
    tx = tex.HybridExecutor(tt, tidx)
    jplan = JPlan(strategy, tuple(JSub(**knobs) for _ in range(2)),
                  dominant=dominant, precision=precision)
    tplan = TPlan(strategy, tuple(TSub(**knobs) for _ in range(2)),
                  dominant=dominant, precision=precision)
    for qj, qt in zip(*workloads):
        a_ids, a_s = jx.execute(qj, jplan)
        b_ids, b_s = tx.execute(qt, tplan)
        np.testing.assert_allclose(_np(b_s), _np(a_s), **SCORE_TOL)
        np.testing.assert_array_equal(_np(a_ids), _np(b_ids))


def test_own_kmeans_clears_oracle_floor_at_generous_budget(tables):
    """The port's own k-means (torch.Generator init) probing every cluster
    with an uncapped scan degenerates to an exhaustive filtered scan."""
    _, tt = tables
    idx = tivf.build(tt.vectors[0], 16, seed=0, metric=tt.schema.metric)
    assert int(idx.offsets[-1]) == tt.n_rows
    np.testing.assert_array_equal(np.sort(idx.sorted_rows.numpy()),
                                  np.arange(tt.n_rows))
    rng = np.random.default_rng(5)
    wl = tq.gen_workload(tt, 5, n_vec_used=2, seed=43) + \
        tq.gen_dnf_workload(tt, 5, n_vec_used=2, seed=44)
    for q in wl:
        qv = torch.as_tensor(rng.normal(size=tt.vectors[0].shape[1]).astype(
            np.float32))
        ids, _, _, _ = tivf.search(idx, tt.vectors[0], tt.scalars,
                                   q.predicates, qv, nprobe=idx.n_clusters,
                                   max_scan=tt.n_rows, k=q.k)
        _, _, masked = brute_force_topk(
            tt, [qv.numpy(), np.zeros(tt.vectors[1].shape[1], np.float32)],
            [1.0, 0.0], q.predicates, q.k)
        assert tie_aware_recall(ids.numpy(), masked, q.k) >= FLOOR


def test_rrf_extras_ranks_by_fused_then_id():
    """The inputs of test_batch.test_rrf_extras_fuses_and_excludes: 20 and
    21 fuse to the same score (1/63 + 1/64) and the smaller id wins."""
    a = torch.tensor([[10, 11, 20, 21, 30]])
    b = torch.tensor([[12, 13, 21, 20, -1]])
    ex = tex.rrf_extras((a, b), kis=(2, 2), n_extra=4)
    assert ex.tolist() == [[20, 21, 30, -1]]
    a2 = torch.tensor([[1, 2, 40, 50]])
    b2 = torch.tensor([[3, 4, 40, -1]])
    assert tex.rrf_extras((a2, b2), kis=(2, 2), n_extra=2).tolist() == \
        [[40, 50]]
