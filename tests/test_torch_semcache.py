"""The semantic cache, the tenant fold and their signatures against the
JAX package.

* ``predicate_signature`` and ``query_signature`` give the JAX package's
  bytes over a seeded sweep of 240 DNF predicates (inactive-column
  garbage, padding clauses, clauses emptied by ``lo > hi``, the
  conjunctive shim and clause-padded copies); ``fold_conjunct`` and
  ``algebra.constrain`` give the same arrays, batched too; ``k_bucket``
  the same values.
* The cache claims of ``tests/test_semcache.py`` on the port's cache: the
  per-tenant LRU bound, token staleness (epoch and row count), the eps
  gate, the miss storm, tenant isolation and ``invalidate_tenant``.
* End to end on a JAX instance carried across (900-row ``part`` with a
  categorical tenant column, namespaces bound): the tenant fold scopes
  results exactly as in JAX, and through the port's ``AsyncServingEngine``
  a cache hit stays within its tenant, never crosses an epoch, and a hot
  insert makes the next repeat miss and see the row.
"""
import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax  # noqa: E402

from oracle import brute_force_topk, eval_mask_np, tie_tolerance  # noqa: E402

from repro.bench import datasets as jds  # noqa: E402
from repro.bench import queries as jq  # noqa: E402
from repro.core.boomhq import BoomHQ as JBoomHQ  # noqa: E402
from repro.core.boomhq import BoomHQConfig as JConfig  # noqa: E402
from repro.core.query import MHQ as JMHQ  # noqa: E402
from repro.core.rewriter import RewriterConfig as JRC  # noqa: E402
from repro.serve import semcache as jsc  # noqa: E402
from repro.vectordb import algebra as jal  # noqa: E402
from repro.vectordb import predicates as jp  # noqa: E402
from repro.vectordb.table import ScalarCol as JScalarCol  # noqa: E402
from repro.vectordb.table import Table as JTable  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core.boomhq import BoomHQConfig  # noqa: E402
from repro_torch.core.query import MHQ  # noqa: E402
from repro_torch.core.rewriter import RewriterConfig  # noqa: E402
from repro_torch.serve import semcache as tsc  # noqa: E402
from repro_torch.serve.queue import AsyncServingEngine  # noqa: E402
from repro_torch.serve.semcache import SemanticCache  # noqa: E402
from repro_torch.vectordb import algebra as tal  # noqa: E402
from repro_torch.vectordb import predicates as tp  # noqa: E402
from repro_torch.vectordb.table import (  # noqa: E402
    ScalarCol, Table, TableSchema, VectorCol,
)

TENANTS = 3
M = 4


# ---------------------------------------------------------------------------
# signatures, the fold and k buckets
# ---------------------------------------------------------------------------

def _fields(rng, c: int, m: int = M):
    """Random (active, lo, hi, clause_valid) numpy fields of one DNF with
    ``c`` clause slots: garbage bounds on inactive columns, some invalid
    (padding) clauses, some clauses emptied by lo > hi on an active
    column, and a few exact duplicates of another clause."""
    active = rng.random((c, m)) < 0.5
    lo = rng.choice([-np.inf, 0.0, 1.0, 2.5, 7.0], (c, m)).astype(np.float32)
    with np.errstate(invalid="ignore"):
        hi = (lo + rng.choice([0.0, 1.0, 3.0, np.inf], (c, m))).astype(
            np.float32)
    hi[np.isneginf(lo)] = np.float32(2.0)  # no -inf + inf
    garbage = rng.normal(0, 50, (c, m)).astype(np.float32)
    lo = np.where(active, lo, garbage)
    hi = np.where(active, hi, -garbage)
    empty = rng.random(c) < 0.2
    for ci in np.flatnonzero(empty):
        j = int(rng.integers(0, m))
        active[ci, j] = True
        lo[ci, j], hi[ci, j] = 5.0, 1.0
    valid = rng.random(c) < 0.8
    if c > 1 and rng.random() < 0.3:
        active[1], lo[1], hi[1] = active[0], lo[0], hi[0]
    return active, lo, hi, valid


def _pair(fields):
    """(JAX PredicateSet, port PredicateSet) of the same fields."""
    a, lo, hi, v = fields
    return (jp.PredicateSet(jax.numpy.asarray(a), jax.numpy.asarray(lo),
                            jax.numpy.asarray(hi), jax.numpy.asarray(v)),
            tp.PredicateSet(torch.as_tensor(a), torch.as_tensor(lo),
                            torch.as_tensor(hi), torch.as_tensor(v)))


def _sweep():
    """240 (JAX, port) predicate pairs: DNF sets of 1/2/4 clause slots,
    clause-padded copies and conjunctive shims."""
    rng = np.random.default_rng(19)
    out = []
    for i in range(240):
        kind = i % 4
        if kind == 3:  # the conjunctive shim
            a, lo, hi, _ = _fields(rng, 1)
            out.append((jp.Predicates(jax.numpy.asarray(a[0]),
                                      jax.numpy.asarray(lo[0]),
                                      jax.numpy.asarray(hi[0])),
                        tp.Predicates(torch.as_tensor(a[0]),
                                      torch.as_tensor(lo[0]),
                                      torch.as_tensor(hi[0]))))
            continue
        jps, tps = _pair(_fields(rng, (1, 2, 4)[kind]))
        if kind == 1 and rng.random() < 0.5:  # padded to the next bucket
            jps, tps = jp.pad_clauses(jps, 4), tp.pad_clauses(tps, 4)
        out.append((jps, tps))
    return out


SWEEP = _sweep()


def test_predicate_signature_bytes_equal_jax():
    sigs = set()
    for jps, tps in SWEEP:
        want = jsc.predicate_signature(jps)
        assert tsc.predicate_signature(tps) == want
        sigs.add(want)
    assert b"false" in sigs and len(sigs) > 150  # the sweep is varied


def test_query_signature_bytes_equal_jax():
    rng = np.random.default_rng(3)
    for jps, tps in SWEEP[:60]:
        w = tuple(float(x) for x in rng.dirichlet([1.0, 1.0]))
        rt = float(rng.choice([0.8, 0.9, 0.95]))
        vec = rng.normal(size=8).astype(np.float32)
        jqry = JMHQ((vec, vec), w, jps, k=10, recall_target=rt)
        tqry = MHQ((torch.as_tensor(vec),) * 2, w, tps, k=10,
                   recall_target=rt)
        assert tsc.query_signature(tqry) == jsc.query_signature(jqry)


def _as_np(pred) -> tuple:
    out = [np.asarray(pred.active), np.asarray(pred.lo), np.asarray(pred.hi)]
    if isinstance(pred, (jp.PredicateSet, tp.PredicateSet)):
        out.append(np.asarray(pred.clause_valid))
    return tuple(out)


def _tnp(pred) -> tuple:
    out = [pred.active.numpy(), pred.lo.numpy(), pred.hi.numpy()]
    if isinstance(pred, tp.PredicateSet):
        out.append(pred.clause_valid.numpy())
    return tuple(out)


@pytest.mark.parametrize("how", ["fold_conjunct", "constrain", "batched"])
def test_fold_and_constrain_equal_jax(how):
    rng = np.random.default_rng({"fold_conjunct": 0, "constrain": 1,
                                 "batched": 2}[how])
    for jps, tps in SWEEP:
        col = int(rng.integers(0, M))
        lo = float(rng.choice([-1.0, 0.0, 2.0]))
        hi = lo + float(rng.choice([0.0, 1.5, 100.0]))
        if how == "constrain":
            want = jal.constrain(jps, jal.Cond(col, lo, hi), m=M)
            got = tal.constrain(tps, tal.Cond(col, lo, hi), m=M)
        elif how == "batched":
            want = jp.fold_conjunct(jp.stack([jps, jps]), col, lo, hi)
            got = tp.fold_conjunct(tp.stack([tps, tps]), col, lo, hi)
        else:
            want = jp.fold_conjunct(jps, col, lo, hi)
            got = tp.fold_conjunct(tps, col, lo, hi)
            # idempotent, and the input is left as it was
            again = tp.fold_conjunct(got, col, lo, hi)
            for a, b in zip(_tnp(again), _tnp(got)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(_tnp(tps), _as_np(jps)):
                np.testing.assert_array_equal(a, b)
        assert type(got).__name__ == type(want).__name__
        for a, b in zip(_tnp(got), _as_np(want)):
            np.testing.assert_array_equal(a, b)
        if how != "batched":
            assert tsc.predicate_signature(got) == \
                jsc.predicate_signature(want)


def test_constrain_by_column_name():
    schema = TableSchema((VectorCol("v", 4),),
                         tuple(ScalarCol(f"c{i}", "num") for i in range(3))
                         + (ScalarCol("tenant", "cat", 3),))
    base = tp.Predicates.from_conditions(4, {0: (1.0, 2.0)}, device="cpu")
    got = tal.constrain(base, tal.col("tenant") == 2, schema)
    assert got.active.tolist() == [True, False, False, True]
    assert float(got.lo[3]) == float(got.hi[3]) == 2.0


def test_k_bucket_equals_jax():
    for k in range(1, 300):
        assert tsc.k_bucket(k) == jsc.k_bucket(k)


# ---------------------------------------------------------------------------
# cache claims (tests/test_semcache.py) on the port's cache
# ---------------------------------------------------------------------------

def _mhq(vec, lo=0.0, hi=1.0, *, k=5, m=3, tenant=None) -> MHQ:
    return MHQ(query_vectors=(torch.as_tensor(np.asarray(vec, np.float32)),),
               weights=(1.0,),
               predicates=tp.Predicates.from_conditions(m, {0: (lo, hi)},
                                                        device="cpu"),
               k=k, tenant_id=tenant)


def test_k_bucket_compatibility():
    cache = SemanticCache()
    token = (0, 100)
    cache.insert(_mhq([0.0, 1.0], k=10), token, np.arange(10),
                 np.linspace(1, 0, 10))
    hit = cache.lookup(_mhq([0.0, 1.0], k=5), token)
    assert hit is not None and len(hit[0]) == 5
    np.testing.assert_array_equal(hit[0], np.arange(5))
    assert cache.lookup(_mhq([0.0, 1.0], k=12), token) is None
    assert cache.lookup(_mhq([0.0, 1.0], k=20), token) is None


def test_eps_gates_near_duplicates():
    token = (0, 100)
    exact = SemanticCache(eps=0.0)
    exact.insert(_mhq([0.0, 1.0]), token, np.arange(5), np.zeros(5))
    assert exact.lookup(_mhq([0.0, 1.0 + 1e-4]), token) is None
    assert exact.lookup(_mhq([0.0, 1.0]), token) is not None
    fuzzy = SemanticCache(eps=1e-3)
    fuzzy.insert(_mhq([0.0, 1.0]), token, np.arange(5), np.zeros(5))
    assert fuzzy.lookup(_mhq([0.0, 1.0 + 1e-4]), token) is not None
    assert fuzzy.lookup(_mhq([0.0, 1.1]), token) is None
    per = SemanticCache(eps={"dot": 1e-3, "l2": 0.0}, metric="l2")
    per.insert(_mhq([0.0, 1.0]), token, np.arange(5), np.zeros(5))
    assert per.lookup(_mhq([0.0, 1.0 + 1e-4]), token) is None


def test_token_staleness_epoch_and_rowcount():
    cache = SemanticCache()
    q = _mhq([0.0, 1.0])
    cache.insert(q, (3, 100), np.arange(5), np.zeros(5))
    assert cache.lookup(q, (3, 100)) is not None
    assert cache.lookup(q, (4, 100)) is None  # epoch bump alone
    assert cache.stats()["stale_drops"] == 1 and len(cache) == 0
    cache.insert(q, (4, 100), np.arange(5), np.zeros(5))
    assert cache.lookup(q, (4, 101)) is None  # hot insert alone
    assert cache.stats()["stale_drops"] == 2


def test_per_tenant_lru_bound():
    cache = SemanticCache(capacity_per_tenant=2)
    token = (0, 100)
    for i in range(3):
        cache.insert(_mhq([float(i), 0.0], tenant=0), token,
                     np.arange(5), np.zeros(5))
    cache.insert(_mhq([9.0, 9.0], tenant=1), token, np.arange(5), np.zeros(5))
    assert cache.stats()["evictions"] == 1 and len(cache) == 3
    assert cache.lookup(_mhq([0.0, 0.0], tenant=0), token) is None
    assert cache.lookup(_mhq([2.0, 0.0], tenant=0), token) is not None
    assert cache.lookup(_mhq([9.0, 9.0], tenant=1), token) is not None
    assert cache.invalidate_tenant(0) == 2 and len(cache) == 1


def test_miss_storm_replaces_instead_of_appending():
    cache = SemanticCache(capacity_per_tenant=3)
    token = (0, 100)
    warm = _mhq([7.0, 7.0])
    cache.insert(warm, token, np.arange(5), np.zeros(5))
    storm = _mhq([0.0, 1.0])
    for i in range(10):
        cache.insert(storm, token, np.arange(5) + i, np.zeros(5))
    assert len(cache) == 2 and cache.stats()["evictions"] == 0
    assert cache.lookup(warm, token) is not None
    np.testing.assert_array_equal(cache.lookup(storm, token)[0],
                                  np.arange(5) + 9)
    fuzzy = SemanticCache(eps=1e-2, capacity_per_tenant=8)
    fuzzy.insert(_mhq([0.0, 1.0]), token, np.arange(5), np.zeros(5))
    fuzzy.insert(_mhq([0.0, 1.0 + 1e-4]), token, np.arange(5), np.zeros(5))
    assert len(fuzzy) == 1
    fuzzy.insert(_mhq([0.0, 2.0]), token, np.arange(5), np.zeros(5))
    assert len(fuzzy) == 2


def test_tenant_isolation_and_invalidation():
    cache = SemanticCache()
    token = (0, 100)
    rng = np.random.default_rng(5)
    probes = []
    for _ in range(40):  # entries encode their tenant in the cached ids
        tenant = int(rng.integers(0, 4))
        k = int(rng.choice([3, 5, 10]))
        lo = float(rng.uniform(0, 4))
        q = _mhq(rng.uniform(-1, 1, 3), lo, lo + float(rng.uniform(0, 4)),
                 k=k, tenant=tenant)
        cache.insert(q, token, np.full(k, tenant), np.zeros(k))
        probes.append(q)
    for q in probes:
        for other in (None, 0, 1, 2, 3):
            got = cache.lookup(dataclasses.replace(q, tenant_id=other), token)
            if got is not None:
                assert np.all(got[0] == other)
    hits = cache.stats()["tenant_hits"]
    assert set(hits) <= {0, 1, 2, 3} and sum(hits.values()) >= len(probes)
    dropped = cache.invalidate_tenant(0)
    assert dropped >= 1 and 0 not in cache.stats()["tenant_hits"]


# ---------------------------------------------------------------------------
# end to end on a carried instance
# ---------------------------------------------------------------------------

def _index_dicts(indexes) -> list:
    return [dict(centroids=np.asarray(x.centroids),
                 sorted_rows=np.asarray(x.sorted_rows),
                 offsets=np.asarray(x.offsets), metric=x.metric)
            for x in indexes]


def _hist_dict(h) -> dict:
    return dict(edges=np.asarray(h.edges), prefix=np.asarray(h.prefix),
                n_rows=np.asarray(h.n_rows))


def _graph_dicts(graphs):
    if graphs is None:
        return None
    return [dict(neighbors=np.asarray(g.neighbors),
                 entry_points=np.asarray(g.entry_points), metric=g.metric)
            for g in graphs]


def _state(jbq) -> dict:
    """A fitted JAX instance's state as ``convert.boomhq`` takes it, its
    graphs included."""
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    st = {
        "indexes": _index_dicts(jbq.indexes),
        "hists": _hist_dict(jbq.hists),
        "qenc_edges": np.asarray(jbq.qenc._edges),
        "rewriter": dict(params=to_np(jbq.rewriter.params),
                         in_dim=jbq.rewriter.in_dim),
        "graphs": _graph_dicts(jbq.graphs),
    }
    if jbq.data_encoder is not None:
        st["data_encoder"] = dict(params=to_np(jbq.data_encoder.params),
                                  edges=np.asarray(jbq.data_encoder.edges))
    return st


def _port_table(jt) -> Table:
    schema = TableSchema(
        tuple(VectorCol(c.name, c.dim) for c in jt.schema.vector_cols),
        tuple(ScalarCol(c.name, c.kind, c.n_categories)
              for c in jt.schema.scalar_cols), metric=jt.schema.metric)
    return Table.from_numpy(schema, [np.array(v) for v in jt.vectors],
                            np.array(jt.scalars), device="cpu")


def _port_pred(p):
    f = [torch.as_tensor(np.array(x)) for x in _as_np(p)]
    return tp.PredicateSet(*f) if len(f) == 4 else tp.Predicates(*f)


def _port_mhq(q) -> MHQ:
    return MHQ(tuple(torch.as_tensor(np.array(v)) for v in q.query_vectors),
               tuple(q.weights), _port_pred(q.predicates), k=q.k,
               recall_target=q.recall_target, tenant_id=q.tenant_id)


@pytest.fixture(scope="module")
def tenant_pair():
    """``tests/test_semcache.py``'s ``tenant_bq`` in JAX, carried across:
    (JAX instance, port instance, held JAX queries, held port queries)."""
    base = jds.make("part", rows=900, seed=7)
    tcol = np.random.default_rng(7).integers(0, TENANTS, base.n_rows) \
        .astype(np.float32)
    schema = dataclasses.replace(
        base.schema, scalar_cols=tuple(base.schema.scalar_cols)
        + (JScalarCol("tenant", "cat", TENANTS),))
    jt = JTable.from_numpy(
        schema, [np.asarray(v) for v in base.vectors],
        np.concatenate([np.asarray(base.scalars), tcol[:, None]], axis=1))
    jbq = JBoomHQ(jt, JConfig(n_clusters=8, use_de=False, rewriter=JRC(
        steps=10, refine_columns=False)))
    jbq.fit(jq.gen_workload(jt, 12, n_vec_used=2, k=5, seed=0))
    jbq.bind_tenants("tenant")
    held = jq.gen_workload(jt, 6, n_vec_used=2, k=5, seed=1)
    tbq = convert.boomhq(_port_table(jt), BoomHQConfig(
        n_clusters=8, use_de=False,
        rewriter=RewriterConfig(steps=10, refine_columns=False)),
        _state(jbq))
    tbq.bind_tenants("tenant")
    return jbq, tbq, held, [_port_mhq(q) for q in held]


def _same(got, want) -> None:
    """Scores to atol=1e-4; a differing id only on a float tie."""
    ids_t, s_t = (np.asarray(x) for x in got)
    ids_j, s_j = (np.asarray(x) for x in want)
    np.testing.assert_allclose(s_t, s_j, atol=1e-4, rtol=1e-5)
    for p in np.flatnonzero(ids_t != ids_j):
        assert abs(s_t[p] - s_j[p]) <= tie_tolerance(float(s_j[p]))


def test_tenant_fold_scopes_results_as_jax(tenant_pair):
    jbq, tbq, jheld, theld = tenant_pair
    scal = tbq.table.scalars.numpy()
    tcol = scal[:, -1]
    scoped = 0
    for tenant in range(TENANTS):
        qj = dataclasses.replace(jheld[0], tenant_id=tenant)
        qt = dataclasses.replace(theld[0], tenant_id=tenant)
        ids, scores = tbq.execute(qt)
        _same((ids.numpy(), scores.numpy()), jbq.execute(qj))
        got = ids.numpy()[ids.numpy() >= 0]
        assert np.all(tcol[got] == tenant)
        scoped += got.size > 0
        # the fold is an intersection with the query's own predicate
        folded = tbq.resolve_tenant(qt).predicates
        want = eval_mask_np(jbq.resolve_tenant(qj).predicates, scal)
        np.testing.assert_array_equal(eval_mask_np(folded, scal), want)
        np.testing.assert_array_equal(
            want, eval_mask_np(qt.predicates, scal) & (tcol == tenant))
    assert scoped > 0
    # batched, tenants mixed in one batch
    qs = [dataclasses.replace(q, tenant_id=i % TENANTS)
          for i, q in enumerate(theld)]
    jqs = [dataclasses.replace(q, tenant_id=i % TENANTS)
           for i, q in enumerate(jheld)]
    for got, want in zip(tbq.execute_batch(qs), jbq.execute_batch(jqs)):
        _same(got, want)


def test_engine_isolates_tenants_through_cache(tenant_pair):
    _, bq, _, held = tenant_pair
    cache = SemanticCache(eps=0.0)
    eng = AsyncServingEngine(bq, batch_size=2, max_wait=0.005,
                             semcache=cache)
    q0 = dataclasses.replace(held[1], tenant_id=0)
    q1 = dataclasses.replace(held[1], tenant_id=1)

    async def main():
        async with eng:
            return [await eng.submit(q) for q in (q0, q0, q1, q1)]

    a, b, c, d = asyncio.run(main())
    assert [r.cache_hit for r in (a, b, c, d)] == [False, True, False, True]
    np.testing.assert_array_equal(np.asarray(a.result[0])[: q0.k],
                                  np.asarray(b.result[0]))
    tcol = bq.table.scalars.numpy()[:, -1]
    cids = np.asarray(c.result[0])
    assert np.all(tcol[cids[cids >= 0]] == 1)
    rep = eng.report()
    assert rep.n_cache_hits == 2 and rep.tenants[0]["n_queries"] == 2
    assert rep.tenants[0]["n_cache_hits"] == rep.tenants[1]["n_cache_hits"] \
        == 1
    assert "cache hits" in rep.describe()


def _fresh_rows(n: int, seed: int, tenant: float = 0.0):
    extra = jds.make("part", rows=n, seed=seed)
    scal = np.concatenate([np.asarray(extra.scalars),
                           np.full((n, 1), tenant, np.float32)], axis=1)
    return [np.asarray(v) for v in extra.vectors], scal


def test_cache_entry_never_served_across_epoch(tenant_pair):
    _, bq, _, held = tenant_pair
    bq.bind_tiered(hot_capacity=8)
    try:
        cache = SemanticCache(eps=0.0)
        eng = AsyncServingEngine(bq, batch_size=2, max_wait=0.005,
                                 semcache=cache)
        q = held[2]

        async def main():
            async with eng:
                r1 = await eng.submit(q)
                r2 = await eng.submit(q)
                epoch0 = bq.tiered.epoch
                bq.tiered.insert(*_fresh_rows(8, seed=31))
                bq.tiered.compact()
                assert bq.tiered.epoch == epoch0 + 1
                return r1, r2, await eng.submit(q), await eng.submit(q)

        r1, r2, r3, r4 = asyncio.run(main())
        assert not r1.cache_hit and r2.cache_hit
        assert not r3.cache_hit and r4.cache_hit
        assert cache.stats()["stale_drops"] >= 1
        _, gt_s, _ = brute_force_topk(
            bq.tiered.logical_table(), list(q.query_vectors),
            list(q.weights), q.predicates, q.k)
        np.testing.assert_allclose(np.sort(np.asarray(r3.result[1])),
                                   np.sort(gt_s), atol=1e-3, rtol=1e-4)
    finally:
        bq.unbind_tiered()


def test_hot_insert_visible_to_next_miss(tenant_pair):
    _, bq, _, held = tenant_pair
    bq.bind_tiered(hot_capacity=32)
    try:
        cache = SemanticCache(eps=0.0)
        eng = AsyncServingEngine(bq, batch_size=2, max_wait=0.005,
                                 semcache=cache)
        q = held[3]
        mask = eval_mask_np(q.predicates, bq.table.scalars.numpy())
        passing = int(np.argmax(mask))
        assert mask[passing]
        big = [100.0 * v.numpy()[None] for v in q.query_vectors]
        new_scal = bq.table.scalars.numpy()[passing: passing + 1]

        async def main():
            async with eng:
                r1 = await eng.submit(q)
                r2 = await eng.submit(q)
                new_id = bq.tiered.snapshot().n_rows
                bq.tiered.insert(big, new_scal)
                return r1, r2, await eng.submit(q), new_id

        r1, r2, r3, new_id = asyncio.run(main())
        assert r2.cache_hit and not r3.cache_hit
        assert new_id in np.asarray(r3.result[0])
    finally:
        bq.unbind_tiered()
