"""Logical-shard serving of the port against the JAX package.

Parity, on tables and workloads both packages draw from the same seeds,
with the reference's own per-shard indexes carried across
(``convert.sharded_ivf``: k-means depends on JAX's PRNG):

* ``legalize_for_shard`` over a grid, exactly;
* ``sharded_topk_ref`` for S ∈ {1, 2, 3, 4}, divisible and not, k above
  the shard length, tied scores and all-masked shards: ids equal, scores
  to ``atol=1e-6``;
* ``sharded_ivf_topk``: one and two columns (RRF extras), dot and l2, a
  non-divisible table and S=1 — ids and ``fill`` equal, scores and
  ``boundary`` to ``rtol=1e-5`` (dot ``atol=1e-4``, l2 ``atol=1e-3``);
* ``execute_batch_sharded`` without and with plans under each forced
  route and the default: ids equal, scores to ``atol=1e-4``, the
  ``escalated`` set and the dispatcher's counts equal;
* the boundary escalation's ``need`` on the reference's own fixture
  (``tests/test_sharded_ivf.py``): the rule flags shards 0 and 1 there.

Then the claims of ``tests/test_sharded_ivf.py``, ``tests/test_batch.py``
and ``tests/test_oracle.py`` on the port's own builds, and what the mesh
path refuses. The mesh cases themselves run over four ranks in
``tests/test_torch_mesh.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax.numpy as jnp  # noqa: E402

from oracle import (  # noqa: E402
    brute_force_topk, sharded_brute_force_topk, tie_aware_recall,
)

from repro.bench import datasets as jds  # noqa: E402
from repro.bench import queries as jq  # noqa: E402
from repro.core.executor import legalize_for_shard as j_legalize  # noqa: E402
from repro.core.query import MHQ as JMHQ  # noqa: E402
from repro.core.query import ExecutionPlan as JPlan  # noqa: E402
from repro.core.query import SubqueryParams as JSub  # noqa: E402
from repro.serve import batch as jb  # noqa: E402
from repro.vectordb import distributed as jdist  # noqa: E402
from repro.vectordb import histogram as jhist  # noqa: E402
from repro.vectordb import ivf as jivf  # noqa: E402
from repro.vectordb import predicates as jp  # noqa: E402
from repro.vectordb.predicates import Predicates as JPredicates  # noqa: E402
from repro.vectordb.table import ScalarCol as JScalarCol  # noqa: E402
from repro.vectordb.table import Table as JTable  # noqa: E402
from repro.vectordb.table import TableSchema as JSchema  # noqa: E402
from repro.vectordb.table import VectorCol as JVectorCol  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.bench import datasets as tds  # noqa: E402
from repro_torch.bench import queries as tq  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    legalize_for_shard, rrf_extras, rrf_union_total,
)
from repro_torch.core.query import MHQ, ExecutionPlan, SubqueryParams  # noqa: E402
from repro_torch.serve import batch as tb  # noqa: E402
from repro_torch.serve.batch import (  # noqa: E402
    CANDIDATE_LOCAL, DENSE, SHARDED_LOCAL, SINGLE_DEVICE,
    BatchedHybridExecutor, CostModel,
)
from repro_torch.vectordb import distributed as tdist  # noqa: E402
from repro_torch.vectordb import histogram, ivf  # noqa: E402
from repro_torch.vectordb import predicates as tp  # noqa: E402
from repro_torch.vectordb.predicates import Predicates  # noqa: E402
from repro_torch.vectordb.table import (  # noqa: E402
    ScalarCol, Table, TableSchema, VectorCol,
)

DOT_TOL = dict(atol=1e-4, rtol=1e-5)
L2_TOL = dict(atol=1e-3, rtol=1e-5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _carry_idx(jidx):
    return [convert.ivf_index(np.asarray(x.centroids),
                              np.asarray(x.sorted_rows),
                              np.asarray(x.offsets), x.metric, device="cpu")
            for x in jidx]


def _carry_sivf(js):
    return convert.sharded_ivf(np.asarray(js.centroids),
                               np.asarray(js.sorted_rows),
                               np.asarray(js.offsets), js.metric,
                               device="cpu")


def _oracle_recall(table, q, ids) -> float:
    _, _, masked = brute_force_topk(
        table, [_np(v) for v in q.query_vectors], list(q.weights),
        q.predicates, q.k)
    return tie_aware_recall(_np(ids), masked, q.k)


@pytest.fixture(scope="module")
def part():
    """1,500-row ``part`` in both packages, a mixed conjunctive + DNF
    workload, and the port's own IVF indexes (16 clusters)."""
    jt = jds.make("part", rows=1500, seed=0)
    tt = tds.make("part", rows=1500, seed=0, device="cpu")
    idx = [ivf.build(v, 16, seed=i, metric=tt.schema.metric)
           for i, v in enumerate(tt.vectors)]
    return jt, tt, idx


def _mixed_wl(qmod, t, seed):
    return qmod.gen_workload(t, 5, n_vec_used=2, seed=seed) + \
        qmod.gen_dnf_workload(t, 5, n_vec_used=2, seed=seed + 1,
                              clause_counts=(2, 3, 4))


def _plan(t, cls_plan, cls_sub, *, k_mult=4, nprobe=64, max_scan=None,
          iterative=False):
    ms = t.n_rows if max_scan is None else max_scan
    return cls_plan("index_scan", tuple(
        cls_sub(k_mult=k_mult, nprobe=nprobe, max_scan=ms,
                iterative=iterative) for _ in range(t.schema.n_vec)))


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_legalize_for_shard_matches_jax_over_a_grid():
    n = 0
    for k_i in (1, 10, 40, 160):
        for nprobe in (1, 4, 16, 64):
            for max_scan in (8, 96, 2048, 131072):
                for s in (1, 2, 3, 4, 7):
                    for shard_len in (50, 500, 125_000):
                        for c in (1, 8, 64):
                            kw = dict(n_shards=s, shard_len=shard_len,
                                      n_clusters=c)
                            assert legalize_for_shard(
                                k_i, nprobe, max_scan, **kw) == \
                                j_legalize(k_i, nprobe, max_scan, **kw)
                            n += 1
    assert n == 4 * 4 * 4 * 5 * 3 * 3


@pytest.mark.parametrize("n,s,k", [(40, 1, 10), (40, 2, 10), (41, 3, 10),
                                   (43, 4, 16), (10, 4, 8), (6, 3, 10)],
                         ids=lambda v: str(v))
def test_sharded_topk_ref_matches_jax(n, s, k):
    """Scores drawn from 6 values (ties), one all-masked shard, k above
    the shard length in the last two cases (the last merges fewer than k
    candidates and pads)."""
    rng = np.random.default_rng(n * 10 + s)
    q = 5
    scores = rng.integers(0, 6, (q, n)).astype(np.float32)
    mask = rng.uniform(size=(q, n)) < 0.6
    per = -(-n // s)
    mask[:, :per] = False  # shard 0 qualifies nothing
    want_i, want_s = jdist.sharded_topk_ref(jnp.asarray(scores),
                                            jnp.asarray(mask), k=k,
                                            n_shards=s)
    got_i, got_s = tdist.sharded_topk_ref(torch.as_tensor(scores),
                                          torch.as_tensor(mask), k=k,
                                          n_shards=s)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)
    assert got_i.shape == (q, k)


@pytest.mark.parametrize("metric,n_cols,s,rows",
                         [("dot", 1, 3, 1500), ("dot", 2, 4, 1500),
                          ("l2", 2, 2, 1203), ("dot", 2, 1, 1500)],
                         ids=lambda v: str(v))
def test_sharded_ivf_topk_matches_jax(metric, n_cols, s, rows):
    jt = jds.make("part", rows=rows, seed=1, metric=metric)
    tt = tds.make("part", rows=rows, seed=1, metric=metric, device="cpu")
    jwl = jq.gen_workload(jt, 8, n_vec_used=2, seed=5)
    twl = tq.gen_workload(tt, 8, n_vec_used=2, seed=5)
    jsiv = [jdist.build_sharded_ivf(jt.vectors[c], s, n_clusters=8,
                                    seed=c, metric=metric)
            for c in range(n_cols)]
    tsiv = [_carry_sivf(x) for x in jsiv]
    subs = tuple((c, 20, 32, 2, 96) for c in range(n_cols))
    pad_total = rrf_union_total(20 * n_cols) if n_cols > 1 else 64
    kw = dict(subs=subs, k=10, metric=metric, pad_total=pad_total)
    jfn = jdist.sharded_ivf_topk(s, None, n_cols=n_cols, **kw)
    tfn = tdist.sharded_ivf_topk(s, None, **kw)
    w = np.asarray([q.weights[:n_cols] for q in jwl], np.float32)
    want = jfn(tuple(x.centroids for x in jsiv),
               tuple(x.sorted_rows for x in jsiv),
               tuple(x.offsets for x in jsiv), tuple(jt.vectors[:n_cols]),
               jt.scalars, jp.stack([q.predicates for q in jwl]),
               tuple(jnp.stack([q.query_vectors[c] for q in jwl])
                     for c in range(n_cols)), jnp.asarray(w))
    got = tfn(tuple(x.centroids for x in tsiv),
              tuple(x.sorted_rows for x in tsiv),
              tuple(x.offsets for x in tsiv), tuple(tt.vectors[:n_cols]),
              tt.scalars, tp.stack([q.predicates for q in twl]),
              tuple(torch.stack([q.query_vectors[c] for q in twl])
                    for c in range(n_cols)), torch.as_tensor(w))
    tol = L2_TOL if metric == "l2" else DOT_TOL
    names = ("ids", "scores", "fill", "boundary")
    for name, g, wnt in zip(names, got, want):
        assert tuple(g.shape) == tuple(np.asarray(wnt).shape), name
        if name in ("ids", "fill"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **tol)
    assert got[2].shape[1] == s


def test_rrf_extras_on_global_ids_keep_the_local_order():
    """A shard's probed lists carry global ids (local + a constant row0):
    the fused extras are the local extras shifted by row0, so the
    reference's shard-local RRF and the port's global one agree."""
    rng = np.random.default_rng(3)
    local = [torch.as_tensor(np.stack([rng.permutation(60)[:24]
                                       for _ in range(4)]), dtype=torch.int32)
             for _ in range(2)]
    for lst in local:
        lst[:, -3:] = -1  # empty tail slots
    want = rrf_extras(tuple(local), kis=(6, 6), n_extra=16)
    for row0 in (500, 12_345):
        shifted = tuple(torch.where(lst >= 0, lst + row0, lst)
                        for lst in local)
        got = rrf_extras(shifted, kis=(6, 6), n_extra=16)
        np.testing.assert_array_equal(
            got.numpy(), np.where(want.numpy() >= 0, want.numpy() + row0, -1))


@pytest.fixture(scope="module")
def exec_pair():
    """1,200-row ``part`` in both packages, the JAX IVF indexes and
    histograms carried across, and six conjunctive + two DNF queries."""
    jt = jds.make("part", rows=1200, seed=2)
    tt = tds.make("part", rows=1200, seed=2, device="cpu")
    jidx = [jivf.build(v, 16, seed=i, metric=jt.schema.metric)
            for i, v in enumerate(jt.vectors)]
    jh = jhist.build(jt.scalars, 32)
    th = convert.histograms(np.asarray(jh.edges), np.asarray(jh.prefix),
                            np.asarray(jh.n_rows), device="cpu")
    jwl = jq.gen_workload(jt, 6, n_vec_used=2, seed=7) + \
        jq.gen_dnf_workload(jt, 2, n_vec_used=2, seed=8, clause_counts=(2,))
    twl = tq.gen_workload(tt, 6, n_vec_used=2, seed=7) + \
        tq.gen_dnf_workload(tt, 2, n_vec_used=2, seed=8, clause_counts=(2,))
    return jt, tt, jidx, _carry_idx(jidx), jh, th, jwl, twl


@pytest.mark.parametrize("plans", [False, True], ids=["exact", "plans"])
@pytest.mark.parametrize("force", [None, SHARDED_LOCAL, DENSE, SINGLE_DEVICE])
def test_execute_batch_sharded_matches_jax(exec_pair, force, plans):
    jt, tt, jidx, tidx, jh, th, jwl, twl = exec_pair
    s = 3
    jbx = jb.BatchedHybridExecutor(jt, jidx, n_shards=s, hists=jh,
                                   cost_model=jb.CostModel(force=force))
    tbx = BatchedHybridExecutor(tt, tidx, n_shards=s, hists=th,
                                cost_model=CostModel(force=force))
    for c in range(tt.schema.n_vec):
        tbx._sivf[c] = _carry_sivf(jbx._sivf_col(c))
    if plans:
        kw = dict(k_mult=2, nprobe=2, max_scan=256)
        want = jbx.execute_batch_sharded(
            jwl, [_plan(jt, JPlan, JSub, **kw)] * len(jwl))
        got = tbx.execute_batch_sharded(
            twl, [_plan(tt, ExecutionPlan, SubqueryParams, **kw)] * len(twl))
    else:
        want = jbx.execute_batch_sharded(jwl)
        got = tbx.execute_batch_sharded(twl)
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_allclose(gs, np.asarray(ws), **DOT_TOL)
    assert tbx.escalated == jbx.escalated
    assert tbx.dispatcher.take()[0] == jbx.dispatcher.take()[0]


def _boundary_fixture(n_clusters_base=24, seed=5):
    """The reference's boundary fixture: 600 rows over 3 shards, shard 1's
    rows carrying a strong query-direction component. -> (numpy vectors,
    scalars, the query direction)."""
    rng = np.random.default_rng(seed)
    n, d, m, n_shards = 600, 16, 2, 3
    shard_len = n // n_shards
    qdir = rng.normal(size=(d,)).astype(np.float32)
    qdir /= np.linalg.norm(qdir)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    boost = np.linspace(4.0, 12.0, shard_len).astype(np.float32)
    vecs[shard_len: 2 * shard_len] += boost[:, None] * qdir[None, :]
    scal = rng.uniform(0, 1, (n, m)).astype(np.float32)
    return vecs, scal, qdir


def _spy(monkeypatch, cls, captured):
    orig = cls._escalate_shards

    def spy(self, ids, scores, need, **kw):
        captured.append(need.copy())
        return orig(self, ids, scores, need, **kw)

    monkeypatch.setattr(cls, "_escalate_shards", spy)


def test_boundary_escalation_need_matches_jax(monkeypatch):
    """On the reference's fixture the boundary rule flags shards 0 AND 1:
    the dominant shard kept 7 rows (fill [1, 7, 3]), so the merged top-10
    takes shard 0's single row, whose boundary reaches the merged k-th.
    The port flags the same shards; the merged result is full, the retry
    covers a strict subset of the shards (2 of 3) and restores the oracle
    top-k; with escalation stubbed out the same probe misses part of it."""
    vecs, scal, qdir = _boundary_fixture()
    m, k = scal.shape[1], 10
    jschema = JSchema(vector_cols=(JVectorCol("v0", 16),),
                      scalar_cols=tuple(JScalarCol(f"s{i}", "num")
                                        for i in range(m)))
    jt = JTable.from_numpy(jschema, [vecs], scal)
    tt = Table.from_numpy(
        TableSchema((VectorCol("v0", 16),),
                    tuple(ScalarCol(f"s{i}", "num") for i in range(m))),
        [vecs], scal, device="cpu")
    jidx = [jivf.build(jt.vectors[0], 24, seed=0)]
    jq0 = JMHQ(query_vectors=(jnp.asarray(qdir),), weights=(1.0,),
               predicates=JPredicates.none(m), k=k)
    tq0 = MHQ(query_vectors=(torch.as_tensor(qdir),), weights=(1.0,),
              predicates=Predicates.none(m, device="cpu"), k=k)
    jtight = JPlan("index_scan", (JSub(k_mult=2, nprobe=1, max_scan=96,
                                       iterative=False),))
    ttight = ExecutionPlan("index_scan", (SubqueryParams(
        k_mult=2, nprobe=1, max_scan=96, iterative=False),))
    jneed, tneed = [], []
    _spy(monkeypatch, jb.BatchedHybridExecutor, jneed)
    _spy(monkeypatch, BatchedHybridExecutor, tneed)
    jbx = jb.BatchedHybridExecutor(jt, jidx, n_shards=3,
                                   cost_model=jb.CostModel(force=SHARDED_LOCAL))
    jbx.execute_batch_sharded([jq0], [jtight])
    tbx = BatchedHybridExecutor(tt, _carry_idx(jidx), n_shards=3,
                                cost_model=CostModel(force=SHARDED_LOCAL))
    tbx._sivf[0] = _carry_sivf(jbx._sivf_col(0))
    (ids, _), = tbx.execute_batch_sharded([tq0], [ttight])
    assert len(tneed) == len(jneed) == 1
    np.testing.assert_array_equal(tneed[0], jneed[0])
    assert tneed[0][0].tolist() == [True, True, False]
    assert not tneed[0][1:].any()  # padding queries never escalate
    assert tbx.escalated == {0}
    assert int(np.sum(ids >= 0)) == k  # the merged result was full
    assert 0 < int(tneed[0][0].sum()) < 3  # a strict subset of the shards
    assert _oracle_recall(tt, tq0, ids) == 1.0
    # counterfactual: escalation stubbed out
    monkeypatch.setattr(BatchedHybridExecutor, "_escalate_shards",
                        lambda self, ids, scores, need, **kw: (ids, scores))
    tbx2 = BatchedHybridExecutor(tt, _carry_idx(jidx), n_shards=3,
                                 cost_model=CostModel(force=SHARDED_LOCAL))
    tbx2._sivf[0] = tbx._sivf[0]
    (ids2, _), = tbx2.execute_batch_sharded([tq0], [ttight])
    assert _oracle_recall(tt, tq0, ids2) < 1.0


def test_boundary_escalation_flags_the_dominant_shard_only(monkeypatch):
    """The port's own case where the dominant shard holds the whole merged
    top-k: with 4 clusters a probe surfaces at least k of its rows, the
    other shards' boundaries lie far below the merged k-th, and only the
    dominant shard re-runs."""
    vecs, scal, qdir = _boundary_fixture()
    m, k = scal.shape[1], 10
    tt = Table.from_numpy(
        TableSchema((VectorCol("v0", 16),),
                    tuple(ScalarCol(f"s{i}", "num") for i in range(m))),
        [vecs], scal, device="cpu")
    q = MHQ(query_vectors=(torch.as_tensor(qdir),), weights=(1.0,),
            predicates=Predicates.none(m, device="cpu"), k=k)
    plan = ExecutionPlan("index_scan", (SubqueryParams(
        k_mult=2, nprobe=1, max_scan=300, iterative=False),))
    need = []
    _spy(monkeypatch, BatchedHybridExecutor, need)
    bx = BatchedHybridExecutor(tt, [ivf.build(tt.vectors[0], 4, seed=0)],
                               n_shards=3,
                               cost_model=CostModel(force=SHARDED_LOCAL))
    (ids, _), = bx.execute_batch_sharded([q], [plan])
    assert bx.escalated == {0}
    assert need[0][0].tolist() == [False, True, False]
    assert _oracle_recall(tt, q, ids) == 1.0
    valid = ids[ids >= 0]
    assert valid.size == k and np.all((valid >= 200) & (valid < 400))


def test_mesh_path_is_refused(part):
    """What the mesh path refuses: an object that is not a ``DeviceMesh``
    (``TypeError``), rows that do not divide over the mesh's shards
    (``ValueError``, as the reference asserts), and a shard count that is
    not the mesh's."""
    from test_torch_mesh import fake_mesh

    _, tt, idx = part
    with pytest.raises(TypeError, match="DeviceMesh"):
        BatchedHybridExecutor(tt, idx, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tdist.shard_rows(tt.n_rows, object())
    with fake_mesh(7, rank=3) as mesh:  # 1,500 rows over 7 ranks
        with pytest.raises(ValueError, match="not divisible"):
            BatchedHybridExecutor(tt, idx, mesh=mesh)
        with pytest.raises(ValueError, match="not divisible"):
            tdist.shard_rows(tt.n_rows, mesh)
        with pytest.raises(ValueError, match="lack"):
            tdist.mesh_shard(mesh, ("data", "model"))
        fn = tdist.sharded_ivf_topk(2, mesh, subs=((0, 10, 16, 1, 32),),
                                    k=10, metric="dot", pad_total=64)
        with pytest.raises(ValueError, match="mesh of 7"):
            fn(*[None] * 4, tt.scalars[:10], *[None] * 3)
        assert tdist.shard_rows(1400, mesh) == (600, 800)


# ---------------------------------------------------------------------------
# the reference's claims on the port's own builds
# ---------------------------------------------------------------------------

def test_one_shard_is_single_device_bit_for_bit(part):
    _, t, idx = part
    wl = _mixed_wl(tq, t, 31)
    plans = [_plan(t, ExecutionPlan, SubqueryParams)] * len(wl)
    res1 = BatchedHybridExecutor(
        t, idx, n_shards=1, cost_model=CostModel(force=SHARDED_LOCAL)
    ).execute_batch_sharded(wl, plans)
    res0 = BatchedHybridExecutor(
        t, idx, cost_model=CostModel(force=CANDIDATE_LOCAL)
    ).execute_batch(wl, plans)
    for (i1, s1), (i0, s0) in zip(res1, res0):
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(s1, s0)


def test_one_shard_tight_budget_never_below_single_device(part):
    _, t, idx = part
    wl = _mixed_wl(tq, t, 31)
    plans = [_plan(t, ExecutionPlan, SubqueryParams, k_mult=2, nprobe=2,
                   max_scan=128)] * len(wl)
    res1 = BatchedHybridExecutor(
        t, idx, n_shards=1, cost_model=CostModel(force=SHARDED_LOCAL)
    ).execute_batch_sharded(wl, plans)
    res0 = BatchedHybridExecutor(
        t, idx, cost_model=CostModel(force=CANDIDATE_LOCAL)
    ).execute_batch(wl, plans)
    for q, (i1, _), (i0, _) in zip(wl, res1, res0):
        assert _oracle_recall(t, q, i1) >= _oracle_recall(t, q, i0) - 1e-9


def test_non_divisible_row_count_pads_exactly(part):
    _, t, idx = part
    assert t.n_rows % 7 != 0
    bx = BatchedHybridExecutor(t, idx, n_shards=7,
                               cost_model=CostModel(force=SHARDED_LOCAL))
    wl = _mixed_wl(tq, t, 43)
    res = bx.execute_batch_sharded(
        wl, [_plan(t, ExecutionPlan, SubqueryParams)] * len(wl))
    for q, (ids, scores) in zip(wl, res):
        assert _oracle_recall(t, q, ids) == 1.0
        valid = ids[ids >= 0]
        assert valid.size == len(set(valid.tolist()))
        assert np.all(valid < t.n_rows)
        o_ids, o_scores, _ = sharded_brute_force_topk(
            t, [v.numpy() for v in q.query_vectors], list(q.weights),
            q.predicates, q.k, n_shards=7)
        np.testing.assert_allclose(
            np.sort(scores[ids >= 0]), np.sort(o_scores[o_ids >= 0]),
            atol=1e-4, rtol=1e-5)


def test_all_filtered_shard_contributes_nothing():
    rng = np.random.default_rng(0)
    n, d, m, n_shards = 900, 16, 2, 3
    scal = rng.uniform(0.0, 1.0, (n, m)).astype(np.float32)
    scal[:, 0] = np.repeat(np.arange(n_shards), n // n_shards)
    t = Table.from_numpy(
        TableSchema((VectorCol("v0", d),),
                    tuple(ScalarCol(f"s{i}", "num") for i in range(m))),
        [rng.normal(size=(n, d)).astype(np.float32)], scal, device="cpu")
    wl = [MHQ(query_vectors=(torch.as_tensor(
        rng.normal(size=(d,)).astype(np.float32)),), weights=(1.0,),
        predicates=Predicates.from_conditions(m, {0: (1.0, 2.0)},
                                              device="cpu"), k=10)
        for _ in range(4)]
    bx = BatchedHybridExecutor(t, [ivf.build(t.vectors[0], 8, seed=0)],
                               n_shards=n_shards,
                               cost_model=CostModel(force=SHARDED_LOCAL))
    res = bx.execute_batch_sharded(
        wl, [_plan(t, ExecutionPlan, SubqueryParams)] * len(wl))
    for q, (ids, scores) in zip(wl, res):
        assert _oracle_recall(t, q, ids) == 1.0
        valid = ids[ids >= 0]
        assert valid.size > 0 and np.all(valid >= n // n_shards)
        assert np.all(scores[ids < 0] < -1e29)


def test_selective_predicate_escalates_to_exact(part):
    _, t, idx = part
    scal = t.scalars.numpy()
    col = next(i for i, c in enumerate(t.schema.scalar_cols)
               if c.kind == "num")
    vals = np.sort(scal[:, col])
    rng = np.random.default_rng(3)
    q = MHQ(query_vectors=tuple(torch.as_tensor(
        rng.normal(size=(v.shape[1],)).astype(np.float32))
        for v in t.vectors), weights=(0.6, 0.4),
        predicates=Predicates.from_conditions(
            t.schema.n_scalar, {col: (float(vals[2]), float(vals[6]))},
            device="cpu"), k=10)
    _, _, masked = brute_force_topk(
        t, [v.numpy() for v in q.query_vectors], list(q.weights),
        q.predicates, q.k)
    assert 0 < int(np.sum(masked > -1e29)) < q.k
    bx = BatchedHybridExecutor(t, idx, n_shards=4,
                               cost_model=CostModel(force=SHARDED_LOCAL))
    (ids, _), = bx.execute_batch_sharded(
        [q], [_plan(t, ExecutionPlan, SubqueryParams, k_mult=1, nprobe=1,
                    max_scan=32)])
    assert _oracle_recall(t, q, ids) == 1.0
    assert set(ids[ids >= 0].tolist()) == \
        set(np.flatnonzero(masked > -1e29).tolist())
    assert bx.escalated == {0}


def test_histogram_cap_estimates_and_stays_exact(part, monkeypatch):
    """The capped gather sizes itself from the estimate: the counts are
    read once, after the gather, never before it."""
    _, t, idx = part
    bx = BatchedHybridExecutor(t, idx, n_shards=3,
                               cost_model=CostModel(force=CANDIDATE_LOCAL),
                               hists=histogram.build(t.scalars, 32))
    calls = []
    orig = tb._selectivity_batch
    monkeypatch.setattr(tb, "_selectivity_batch",
                        lambda h, p: calls.append(1) or orig(h, p))
    wl = _mixed_wl(tq, t, 61)
    for q, (ids, _) in zip(wl, bx.execute_batch_sharded(wl)):
        assert _oracle_recall(t, q, ids) == 1.0
    assert calls and set(bx.dispatcher.take()[0]) == {CANDIDATE_LOCAL}


def test_histogram_cap_undershoot_escalates_exactly(part, monkeypatch):
    _, t, idx = part
    wl = _mixed_wl(tq, t, 67)
    masks = np.stack([brute_force_topk(
        t, [v.numpy() for v in q.query_vectors], list(q.weights),
        q.predicates, q.k)[2] > -1e29 for q in wl])
    assert masks.sum(axis=1).max() > 64  # the floor-sized cap undershoots
    monkeypatch.setattr(tb, "_selectivity_batch",
                        lambda hists, pred_b: torch.zeros(
                            pred_b.active.shape[0]))
    regathers = []
    orig = BatchedHybridExecutor._regather_overflow
    monkeypatch.setattr(
        BatchedHybridExecutor, "_regather_overflow",
        lambda self, *a, **kw: regathers.append(1) or orig(self, *a, **kw))
    bx = BatchedHybridExecutor(t, idx, n_shards=3,
                               cost_model=CostModel(force=CANDIDATE_LOCAL),
                               hists=histogram.build(t.scalars, 32))
    for q, (ids, _) in zip(wl, bx.execute_batch_sharded(wl)):
        assert _oracle_recall(t, q, ids) == 1.0
    assert regathers


def test_choose_sharded_three_way():
    cm = CostModel(crossover=1.0, overhead=0, min_shard_rows=256)
    assert cm.choose_sharded(batch=4, scan=64, n_rows=4096,
                             n_shards=4) == SHARDED_LOCAL
    assert cm.choose_sharded(batch=8, scan=4096, n_rows=4096,
                             n_shards=4) == DENSE
    assert cm.choose_sharded(batch=4, scan=64, n_rows=512,
                             n_shards=4) == SINGLE_DEVICE
    for force, want in ((SHARDED_LOCAL, SHARDED_LOCAL),
                        (CANDIDATE_LOCAL, SHARDED_LOCAL), (DENSE, DENSE),
                        (SINGLE_DEVICE, SINGLE_DEVICE)):
        assert CostModel(force=force).choose_sharded(
            batch=1, scan=1, n_rows=10**9, n_shards=4) == want
        # the reference's CostModel routes the same way
        assert jb.CostModel(force=force).choose_sharded(
            batch=1, scan=1, n_rows=10**9, n_shards=4) == want
    # the paid-for-GEMM pin: dense score matrices already exist
    d = tb.ScoringDispatcher(1 << 20, CostModel(min_shard_rows=1))
    assert d.choose_sharded(batch=1, scan=1, n_shards=2,
                            prefer_dense=True) == DENSE
    assert d.choose_sharded(batch=1, scan=1, n_shards=2) == SHARDED_LOCAL


def test_small_shards_route_single_device(part):
    _, t, idx = part
    bx = BatchedHybridExecutor(t, idx, n_shards=3)
    wl = _mixed_wl(tq, t, 83)
    res = bx.execute_batch_sharded(
        wl, [_plan(t, ExecutionPlan, SubqueryParams)] * len(wl))
    counts, decisions = bx.dispatcher.take()
    assert counts.get(SINGLE_DEVICE, 0) >= 1
    routed = [d for d in decisions if d["group"][0] == "sharded-ivf"]
    assert routed and all(d["path"] == SINGLE_DEVICE for d in routed)
    recs = [_oracle_recall(t, q, ids) for q, (ids, _) in zip(wl, res)]
    assert float(np.mean(recs)) >= 0.9 and min(recs) >= 0.5, recs


def _single_col_mixed_wl(t, *, n_conj=4, n_dnf=4, seed=31):
    return tq.gen_workload(t, n_conj, n_vec_used=1, seed=seed) + \
        tq.gen_dnf_workload(t, n_dnf, n_vec_used=1, seed=seed + 1,
                            clause_counts=(2, 3, 4))


@pytest.mark.parametrize("seed,shards", [(301, (2, 7)), (402, (2, 7)),
                                         (4242, (4,)), (17, (4,))])
def test_sharded_ivf_three_way_parity(part, seed, shards):
    """Single-column index_scan at exhaustive budgets is the exact filtered
    top-k: the sequential executor, ``execute_batch`` and the sharded
    probing path agree with the oracle and with each other (the last two
    seeds stand in for the reference's hypothesis sweep)."""
    from repro_torch.core.executor import HybridExecutor

    _, t, idx = part
    wl = _single_col_mixed_wl(t, seed=seed)
    assert len({tp.clause_bucket(q.predicates) for q in wl}) >= 2
    plan = _plan(t, ExecutionPlan, SubqueryParams)
    seq = HybridExecutor(t, idx)
    batched = BatchedHybridExecutor(t, idx).execute_batch(wl, [plan] * len(wl))
    sharded = {s: BatchedHybridExecutor(
        t, idx, n_shards=s, cost_model=CostModel(force=SHARDED_LOCAL)
    ).execute_batch_sharded(wl, [plan] * len(wl)) for s in shards}
    for j, q in enumerate(wl):
        ids_s, scores_s = (x.numpy() for x in seq.execute(q, plan))
        assert _oracle_recall(t, q, ids_s) == 1.0
        assert _oracle_recall(t, q, batched[j][0]) == 1.0
        for s in shards:
            ids_x, scores_x = sharded[s][j]
            assert _oracle_recall(t, q, ids_x) == 1.0
            np.testing.assert_allclose(np.sort(scores_x[ids_x >= 0]),
                                       np.sort(scores_s[ids_s >= 0]),
                                       atol=1e-4, rtol=1e-5)


def test_multicolumn_sharded_never_below_batched(part):
    _, t, idx = part
    wl = _mixed_wl(tq, t, 83)
    plans = [_plan(t, ExecutionPlan, SubqueryParams)] * len(wl)
    batched = BatchedHybridExecutor(t, idx).execute_batch(wl, plans)
    for s in (2, 4):
        sharded = BatchedHybridExecutor(
            t, idx, n_shards=s, cost_model=CostModel(force=SHARDED_LOCAL)
        ).execute_batch_sharded(wl, plans)
        for q, (ids_b, _), (ids_x, _) in zip(wl, batched, sharded):
            assert _oracle_recall(t, q, ids_x) >= \
                _oracle_recall(t, q, ids_b) - 1e-9


def test_cross_shard_executor_oracle_exactness(part):
    _, t, idx = part
    wl = _mixed_wl(tq, t, 47)
    scores_b = tb.compute_batch_scores(t, wl)
    for n_shards in (2, 7):
        bx = BatchedHybridExecutor(t, idx, n_shards=n_shards)
        for q, (ids, _) in zip(wl, bx.execute_batch_sharded(
                wl, scores_b=scores_b)):
            assert _oracle_recall(t, q, ids) == 1.0


def test_dispatcher_sharded_chunks_route_and_match(part):
    _, t, idx = part
    wl = _mixed_wl(tq, t, 95)
    results = {}
    for force in (DENSE, CANDIDATE_LOCAL):
        bx = BatchedHybridExecutor(t, idx, n_shards=3,
                                   cost_model=CostModel(force=force))
        results[force] = bx.execute_batch_sharded(wl)
        counts, decisions = bx.dispatcher.take()
        assert set(counts) == {force}
        assert all(d["group"][0] == "sharded" for d in decisions)
    for (ids_d, s_d), (ids_l, s_l) in zip(results[DENSE],
                                          results[CANDIDATE_LOCAL]):
        np.testing.assert_allclose(s_d, s_l, atol=1e-4, rtol=1e-5)


def test_sharded_probing_launches_per_chunk_do_not_grow_with_shards(
        part, monkeypatch):
    """The shards fold into the query axis: one gather call per probed
    column and one for the rerank, whatever S is (the plain version's
    calls, counted on the CPU through the entry point)."""
    from repro_torch.kernels import gather_score as gs

    _, t, idx = part
    wl = tq.gen_workload(t, 6, n_vec_used=2, seed=5)
    plan = _plan(t, ExecutionPlan, SubqueryParams, k_mult=2, nprobe=4,
                 max_scan=256)
    calls = []
    orig = gs.gather_score_topk

    def counting(cand, *a, **kw):
        calls.append(cand.shape[0])
        return orig(cand, *a, **kw)

    monkeypatch.setattr(gs, "gather_score_topk", counting)
    for s in (1, 2, 4):
        bx = BatchedHybridExecutor(t, idx, n_shards=s,
                                   cost_model=CostModel(force=SHARDED_LOCAL))
        for c in range(t.schema.n_vec):
            bx._sivf_col(c)
        calls.clear()
        bx._run_chunk_sharded_ivf(
            bx._group_key(wl[0], bx.legalize(plan)), wl, list(range(6)),
            [None] * 6, bucket_cap=64)
        assert len(calls) == t.schema.n_vec + 1, (s, calls)
        assert calls == [s * 8] * len(calls)  # bucket 8, S rows each


def test_compaction_warm_up_builds_a_sharded_executor_of_its_epoch():
    """Under ``bind_shards(2)`` and ``bind_tiered`` the compaction warm-up
    builds the next epoch's executor with the bound shard config, and its
    per-shard indexes are built on the new table: none is carried across
    the swap."""
    from repro_torch.bench import datasets, queries
    from repro_torch.core.boomhq import BoomHQ, BoomHQConfig

    t = datasets.make("part", rows=600, seed=5, device="cpu")
    bq = BoomHQ(t, BoomHQConfig(n_clusters=8, use_de=False, graph_degree=0))
    bq.bind_shards(2).bind_cost_model(CostModel(force=SHARDED_LOCAL))
    bq.bind_tiered(hot_capacity=16)
    wl = queries.gen_workload(t, 4, n_vec_used=2, seed=6)
    bq.execute_batch(wl)
    old = bq._batched
    assert old.n_shards == 2 and old._sivf
    extra = datasets.make("part", rows=16, seed=9, device="cpu")
    bq.insert([v.numpy() for v in extra.vectors], extra.scalars.numpy())
    bq.tiered.compact()
    new = bq._batched
    assert new is not old and new.table is bq.tiered.snapshot().cold.table
    assert new.n_shards == 2 and new.table.n_rows == 616
    assert new._sivf and all(s.shard_len == 308 for s in new._sivf.values())
    assert not {id(s) for s in new._sivf.values()} & \
        {id(s) for s in old._sivf.values()}
    bq.unbind_tiered()
