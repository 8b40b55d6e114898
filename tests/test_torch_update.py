"""The data-update path (``BoomHQ.insert`` and its parts) against the JAX
package.

State is built by the JAX package, carried across with
``repro_torch.convert``, and the same numpy inserts go through both:

* ``Table.append``: vectors, scalars and the int8 replica equal; an
  append quantizes the new rows only, and a column never quantized stays
  unbuilt; a replica built on the old table after the append never reaches
  the new one, and a cached replica of another row count is refused.
* ``histogram.update``: ``prefix`` equal, edges kept, and the estimate
  within 0.05 of the exact selectivity (``tests/test_vectordb.py``).
* ``ivf.extend``: the nearest-centroid assignment equal except where the
  two nearest distances tie within 1e-5 relative; ``sorted_rows`` and
  ``offsets`` equal on both paths (incremental and regroup), with empty
  clusters (``tests/test_batch.py``) and incremental equal to regroup
  (``tests/test_tiered.py``).
* ``graph.extend`` on a carried graph: edge for edge.
* ``DataEncoder.update`` / ``embed_rows`` on carried parameters: within
  ``ENC_ATOL`` (below).
* ``BoomHQ.insert`` on a carried fitted instance: the grown table, layouts
  and histograms equal, and ``execute_batch`` on both scoring paths equal
  (scores to ``atol=1e-4``, a differing id only on a float tie); and the
  ``tests/test_core.py`` floor (recall >= 0.5 after 100 inserted rows) on
  the port's own fit, graphs included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oracle import tie_tolerance  # noqa: E402

from repro.bench import datasets as jds  # noqa: E402
from repro.bench import queries as jq  # noqa: E402
from repro.core.boomhq import BoomHQ as JBoomHQ  # noqa: E402
from repro.core.boomhq import BoomHQConfig as JConfig  # noqa: E402
from repro.core.data_encoder import DataEncoderConfig as JDEC  # noqa: E402
from repro.core.rewriter import RewriterConfig as JRC  # noqa: E402
from repro.serve.batch import CostModel as JCostModel  # noqa: E402
from repro.vectordb import graph as jgraph  # noqa: E402
from repro.vectordb import histogram as jhist  # noqa: E402
from repro.vectordb import ivf as jivf  # noqa: E402
from repro.vectordb.predicates import Predicates as JPredicates  # noqa: E402
from repro.vectordb.table import Table as JTable  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.bench import datasets as tds  # noqa: E402
from repro_torch.bench import queries as tq  # noqa: E402
from repro_torch.core.boomhq import BoomHQ, BoomHQConfig  # noqa: E402
from repro_torch.core.data_encoder import DataEncoderConfig  # noqa: E402
from repro_torch.core.executor import recall_at_k  # noqa: E402
from repro_torch.core.rewriter import RewriterConfig  # noqa: E402
from repro_torch.kernels import int8_scan  # noqa: E402
from repro_torch.serve.batch import (  # noqa: E402
    CANDIDATE_LOCAL, DENSE, CostModel,
)
from repro_torch.vectordb import flat, graph, histogram, ivf  # noqa: E402
from repro_torch.vectordb.predicates import Predicates  # noqa: E402
from repro_torch.vectordb.table import (  # noqa: E402
    ScalarCol, Table, TableSchema, VectorCol,
)

ENC = dict(frozen_steps=25, ae_steps=40, sample=512, update_steps=20)
REW = dict(steps=80, refine_columns=False)
# DataEncoder.update on carried parameters: 20 AdamW steps from the same
# parameters and minibatches. The two packages sum in other orders (fp32
# einsums and matmuls) and clip with gnorm + 1e-9 (JAX) against
# gnorm + 1e-6 (torch), so the trajectories part by rounding: measured
# |difference| <= 2.7e-6 for parameters, 3e-7 for embeddings and 3e-9 for
# recon errors on the CPU; held at 1e-4.
ENC_ATOL = 1e-4
N_NEW = 100


def _port_table(jt) -> Table:
    schema = TableSchema(
        tuple(VectorCol(c.name, c.dim) for c in jt.schema.vector_cols),
        tuple(ScalarCol(c.name, c.kind, c.n_categories)
              for c in jt.schema.scalar_cols), metric=jt.schema.metric)
    return Table.from_numpy(schema, [np.array(v) for v in jt.vectors],
                            np.array(jt.scalars), device="cpu")


def _inserts(table_np_vectors, table_np_scalars, n, seed):
    """Rows near existing ones (shifted copies), like test_core's insert."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(table_np_scalars.shape[0], n, replace=False)
    vecs = [(v[rows] + 0.01 + rng.normal(0, 0.01, v[rows].shape)).astype(
        np.float32) for v in table_np_vectors]
    return vecs, table_np_scalars[rows].copy()


# ---------------------------------------------------------------------------
# Table.append
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """(JAX table, port table) of 400-row ``part``."""
    jt = jds.make("part", rows=400, seed=0)
    return jt, _port_table(jt)


@pytest.mark.parametrize("built", [(), (0,), (0, 1)],
                         ids=["none", "col0", "both"])
def test_append_equals_jax(small, built, monkeypatch):
    jt0, tt0 = small
    jt = JTable(jt0.schema, list(jt0.vectors), jt0.scalars)
    tt = Table(tt0.schema, list(tt0.vectors), tt0.scalars)
    for i in built:
        jt.quantized(i)
        tt.quantized(i)
    vecs, scal = _inserts([np.asarray(v) for v in jt.vectors],
                          np.asarray(jt.scalars), 50, seed=1)
    seen = []
    inner = int8_scan.quantize_rows
    monkeypatch.setattr(int8_scan, "quantize_rows",
                        lambda v: seen.append(v.clone()) or inner(v))
    jn, tn = jt.append(vecs, scal), tt.append(vecs, scal)
    assert tn.n_rows == jn.n_rows == 450 and tn.device == tt.device
    for a, b in zip(tn.vectors, jn.vectors):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tn.scalars.numpy(), np.asarray(jn.scalars))
    # new rows only, once per built column
    assert len(seen) == len(built)
    for v, i in zip(seen, built):
        np.testing.assert_array_equal(v.numpy(), vecs[i])
    for i in range(2):
        if i not in built:
            assert tn.vectors_i8 is None or tn.vectors_i8[i] is None
            continue
        q, s = tn.vectors_i8[i], tn.scales[i]
        np.testing.assert_array_equal(q.numpy(), np.asarray(jn.vectors_i8[i]))
        np.testing.assert_array_equal(s.numpy(), np.asarray(jn.scales[i]))
        # old rows carried byte for byte
        assert torch.equal(q[:400], tt.vectors_i8[i])
        assert torch.equal(s[:400], tt.scales[i])


def test_replica_built_on_the_old_table_never_reaches_the_new(small):
    _, tt0 = small
    tt = Table(tt0.schema, list(tt0.vectors), tt0.scalars)
    tt.quantized(0)
    vecs, scal = _inserts([v.numpy() for v in tt.vectors],
                          tt.scalars.numpy(), 30, seed=2)
    new = tt.append(vecs, scal)
    # an executor still holding the old table builds column 1 there
    old_q1, _ = tt.quantized(1)
    assert old_q1.shape[0] == 400
    assert new.vectors_i8[1] is None and new.vectors_i8 is not tt.vectors_i8
    q1, s1 = new.quantized(1)
    want_q, want_s = int8_scan.quantize_rows(new.vectors[1])
    assert torch.equal(q1, want_q) and torch.equal(s1, want_s)
    # a replica of another row count planted in the cache is refused
    new.vectors_i8[1], new.scales[1] = old_q1, tt.scales[1]
    with pytest.raises(ValueError, match="replica"):
        new.quantized(1)


# ---------------------------------------------------------------------------
# histogram.update
# ---------------------------------------------------------------------------

def test_histogram_update_equals_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 10, (2000, 2)).astype(np.float32)
    b = rng.uniform(0, 12, (500, 2)).astype(np.float32)  # some past the edges
    jh = jhist.build(jnp.asarray(a), 32)
    th = convert.histograms(np.asarray(jh.edges), np.asarray(jh.prefix),
                            np.asarray(jh.n_rows), device="cpu")
    jh2 = jhist.update(jh, jnp.asarray(b))
    th2 = histogram.update(th, torch.as_tensor(b))
    np.testing.assert_array_equal(th2.prefix.numpy(), np.asarray(jh2.prefix))
    assert torch.equal(th2.edges, th.edges)
    assert float(th2.n_rows) == float(jh2.n_rows) == 2500.0
    # the JAX test's claim, on the port's own build + update, same range
    b = b.clip(0, 10)
    h = histogram.update(histogram.build(torch.as_tensor(a), 32),
                         torch.as_tensor(b))
    pred = Predicates.from_conditions(2, {0: (2.0, 5.0)}, device="cpu")
    est = float(histogram.estimate_selectivity(h, pred))
    both = np.concatenate([a, b])[:, 0]
    assert abs(est - float(np.mean((both >= 2) & (both <= 5)))) < 0.05
    jpred = JPredicates.from_conditions(2, {0: (2.0, 5.0)})
    jest = float(jhist.estimate_selectivity(
        jhist.update(jhist.build(jnp.asarray(a), 32), jnp.asarray(b)), jpred))
    assert est == pytest.approx(jest, abs=1e-6)


# ---------------------------------------------------------------------------
# ivf.extend
# ---------------------------------------------------------------------------

def _carried(jidx):
    return convert.ivf_index(np.asarray(jidx.centroids),
                             np.asarray(jidx.sorted_rows),
                             np.asarray(jidx.offsets), jidx.metric,
                             device="cpu")


def _assert_assign_ties(cent, new, got, want):
    """Assignments equal except where the two nearest centroids tie within
    1e-5 relative."""
    d = (cent * cent).sum(1)[None, :] - 2.0 * new.astype(np.float64) @ \
        cent.T.astype(np.float64)
    for r in np.flatnonzero(got != want):
        a, b = d[r, got[r]], d[r, want[r]]
        assert abs(a - b) <= 1e-5 * max(abs(a), abs(b), 1e-12), r


def _with_empty_clusters(jidx, base):
    """The index with its last three centroids moved far from every row:
    those clusters own no row (the k-means layout rebuilt around them)."""
    cent = np.asarray(jidx.centroids).copy()
    cent[-3:] = -55.0 + np.arange(3)[:, None]
    moved = jivf.IVFIndex(jnp.asarray(cent), jidx.sorted_rows, jidx.offsets,
                          jidx.metric)
    assign = jivf._assign_to_centroids(moved, jnp.asarray(base))
    counts = np.bincount(assign, minlength=cent.shape[0])
    assert (counts[-3:] == 0).all() and (counts > 0).sum() >= 2
    return jivf.IVFIndex(
        jnp.asarray(cent),
        jnp.asarray(np.argsort(assign, kind="stable").astype(np.int32)),
        jnp.asarray(np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int32)), jidx.metric)


def _layout(idx):
    return np.asarray(idx.sorted_rows), np.asarray(idx.offsets)


@pytest.mark.parametrize("case", ["incremental", "regroup", "empty_clusters",
                                  "seed_semantics"])
def test_ivf_extend_equals_jax(case):
    rng = np.random.default_rng({"incremental": 0, "regroup": 1,
                                 "empty_clusters": 2,
                                 "seed_semantics": 3}[case])
    if case == "empty_clusters":  # tests/test_batch.py: 30 rows, 8 clusters
        base = (rng.normal(size=(30, 8)) + 5.0).astype(np.float32)
        new = (rng.normal(size=(4, 8)) + 5.0).astype(np.float32)
        new[0] -= 60.0  # lands in a cluster that owned no row
        n_clusters, seed = 8, 1
    elif case == "seed_semantics":  # tests/test_batch.py: 800 + 137 rows
        base = rng.normal(size=(800, 16)).astype(np.float32)
        new = rng.normal(size=(137, 16)).astype(np.float32)
        n_clusters, seed = 12, 0
    else:
        base = rng.normal(size=(400, 8)).astype(np.float32)
        m = 60 if case == "incremental" else 150
        new = rng.normal(size=(m, 8)).astype(np.float32)
        n_clusters, seed = 8, 3
    jidx = jivf.build(jnp.asarray(base), n_clusters, seed=seed)
    if case == "empty_clusters":
        jidx = _with_empty_clusters(jidx, base)
    tidx = _carried(jidx)
    n = base.shape[0]
    want_assign = jivf._assign_to_centroids(jidx, jnp.asarray(new))
    got_assign = ivf._assign_to_centroids(tidx, torch.as_tensor(new))
    _assert_assign_ties(np.asarray(jidx.centroids), new, got_assign,
                        want_assign)
    rows = np.arange(n, n + new.shape[0], dtype=np.int32)
    for j_fn, t_fn in ((jivf._extend_incremental, ivf._extend_incremental),
                       (jivf._extend_regroup, ivf._extend_regroup)):
        want = _layout(j_fn(jidx, want_assign, rows))
        got = _layout(t_fn(tidx, want_assign, rows))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    incremental = new.shape[0] <= max(
        1, int(n * ivf.EXTEND_INCREMENTAL_FRACTION))
    assert incremental == (case != "regroup")
    ext = ivf.extend(tidx, torch.as_tensor(new), n)
    via = (ivf._extend_incremental if incremental
           else ivf._extend_regroup)(tidx, got_assign, rows)
    for a, b in zip(_layout(ext), _layout(via)):
        np.testing.assert_array_equal(a, b)
    assert ext.sorted_rows.dtype == torch.int32
    assert sorted(ext.sorted_rows.tolist()) == list(range(n + new.shape[0]))
    assert int(ext.offsets[-1]) == n + new.shape[0]
    assert torch.equal(ext.centroids, tidx.centroids)
    if case == "empty_clusters":
        sizes = np.diff(ext.offsets.numpy())
        assert (sizes == 0).any() and sizes[-3:].sum() == 1
    if np.array_equal(got_assign, want_assign):
        for a, b in zip(_layout(ext),
                        _layout(jivf.extend(jidx, jnp.asarray(new), n))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m", [1, 20, 99, 100, 101, 400])
def test_ivf_incremental_equals_regroup(m):
    """tests/test_tiered.py's pin on the port's own build, on both sides
    of the dispatch threshold (100 of 400 rows)."""
    rng = np.random.default_rng(m)
    base = torch.as_tensor(rng.standard_normal((400, 8)).astype(np.float32))
    idx = ivf.build(base, 8, seed=3)
    new = torch.as_tensor(rng.standard_normal((m, 8)).astype(np.float32))
    assign = ivf._assign_to_centroids(idx, new)
    rows = np.arange(400, 400 + m, dtype=np.int32)
    inc = ivf._extend_incremental(idx, assign, rows)
    reg = ivf._extend_regroup(idx, assign, rows)
    ext = ivf.extend(idx, new, 400)
    for a in (inc, ext):
        assert torch.equal(a.sorted_rows, reg.sorted_rows)
        assert torch.equal(a.offsets, reg.offsets)


def test_ivf_extend_finds_new_rows():
    """tests/test_vectordb.py's claim: a near-copy of an indexed row is
    found through the extended index."""
    t = tds.make("part", rows=1500, seed=0, device="cpu")
    idx = ivf.build(t.vectors[0], 16)
    new_vecs = t.vectors[0][:5].numpy() + 1e-4
    idx2 = ivf.extend(idx, torch.as_tensor(new_vecs), t.n_rows)
    t2 = t.append([new_vecs] + [v[:5].numpy() for v in t.vectors[1:]],
                  t.scalars[:5].numpy())
    ids, _, _, _ = ivf.search(idx2, t2.vectors[0], t2.scalars,
                              Predicates.none(4, device="cpu"),
                              torch.as_tensor(new_vecs[0]), nprobe=16,
                              max_scan=t2.n_rows, k=3)
    assert int(ids[0]) in (t.n_rows, 0)


# ---------------------------------------------------------------------------
# graph.extend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_graph_extend_on_carried_graph_equals_jax(metric):
    v = jds._mixture_vectors(700, 32, seed=4)
    base, new = v[:600], v[600:]
    jg = jgraph.build(jnp.asarray(base), 8, metric=metric)
    tg = convert.graph_index(np.asarray(jg.neighbors),
                             np.asarray(jg.entry_points), metric,
                             device="cpu")
    want = jgraph.extend(jg, jnp.asarray(v), 600)
    got = graph.extend(tg, torch.as_tensor(v), 600)
    assert got.n_rows == 700
    np.testing.assert_array_equal(got.neighbors.numpy(),
                                  np.asarray(want.neighbors))
    assert torch.equal(got.entry_points, tg.entry_points)
    assert not new.size or (got.neighbors[600:] >= 0).any()


# ---------------------------------------------------------------------------
# BoomHQ.insert and DataEncoder.update on a carried fitted instance
# ---------------------------------------------------------------------------

def _state(jbq) -> dict:
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {
        "indexes": [dict(centroids=np.asarray(x.centroids),
                         sorted_rows=np.asarray(x.sorted_rows),
                         offsets=np.asarray(x.offsets), metric=x.metric)
                    for x in jbq.indexes],
        "hists": dict(edges=np.asarray(jbq.hists.edges),
                      prefix=np.asarray(jbq.hists.prefix),
                      n_rows=np.asarray(jbq.hists.n_rows)),
        "data_encoder": dict(params=to_np(jbq.data_encoder.params),
                             edges=np.asarray(jbq.data_encoder.edges)),
        "qenc_edges": np.asarray(jbq.qenc._edges),
        "rewriter": dict(params=to_np(jbq.rewriter.params),
                         in_dim=jbq.rewriter.in_dim),
    }


def _workload(qmod, table):
    """5 conjunctive training queries; 8 conjunctive + 4 two-clause DNF
    test queries."""
    conj = qmod.gen_workload(table, 13, n_vec_used=2, seed=1)
    dnf = qmod.gen_dnf_workload(table, 4, n_vec_used=2, seed=2,
                                clause_counts=(2,))
    return conj + dnf


@pytest.fixture(scope="module")
def inserted():
    """A JAX BoomHQ fitted on 2000-row ``part`` (graph tier off), carried
    across, then the same 100 rows inserted into both with ``finetune``.
    -> (JAX instance, port instance, JAX test queries, port test queries,
    the port's encoder before the insert, the inserted rows)."""
    jt = jds.make("part", rows=2000, seed=0)
    jwl = _workload(jq, jt)
    jbq = JBoomHQ(jt, JConfig(n_clusters=16, graph_degree=0,
                              encoder=JDEC(**ENC), rewriter=JRC(**REW)))
    jbq.fit(jwl[:5])
    tt = tds.make("part", rows=2000, seed=0, device="cpu")
    twl = _workload(tq, tt)
    tbq = convert.boomhq(tt, BoomHQConfig(
        n_clusters=16, graph_degree=0, encoder=DataEncoderConfig(**ENC),
        rewriter=RewriterConfig(**REW)), _state(jbq))
    before = convert.data_encoder(
        _state(jbq)["data_encoder"]["params"],
        np.asarray(jbq.data_encoder.edges), [768, 768], 4,
        DataEncoderConfig(**ENC), device="cpu")
    vecs, scal = _inserts([np.asarray(v) for v in jt.vectors],
                          np.asarray(jt.scalars), N_NEW, seed=5)
    j_out = jbq.insert(vecs, scal, finetune=True)
    t_out = tbq.insert(vecs, scal, finetune=True)
    assert t_out["ae_update_loss"] == pytest.approx(
        j_out["ae_update_loss"], abs=ENC_ATOL)
    return jbq, tbq, jwl[5:], twl[5:], before, (vecs, scal)


def test_insert_grows_every_structure_as_jax(inserted):
    jbq, tbq, *_ = inserted
    n = 2000 + N_NEW
    assert tbq.table.n_rows == n
    for a, b in zip(tbq.table.vectors, jbq.table.vectors):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for ti, ji in zip(tbq.indexes, jbq.indexes):
        np.testing.assert_array_equal(ti.sorted_rows.numpy(),
                                      np.asarray(ji.sorted_rows))
        np.testing.assert_array_equal(ti.offsets.numpy(),
                                      np.asarray(ji.offsets))
    np.testing.assert_array_equal(tbq.hists.prefix.numpy(),
                                  np.asarray(jbq.hists.prefix))
    assert float(tbq.hists.n_rows) == n
    np.testing.assert_array_equal(tbq.qenc._edges.numpy(),
                                  np.asarray(jbq.qenc._edges))
    # the executors serve the grown table, never the pre-insert one
    assert tbq.executor.table is tbq.table
    assert tbq._batched_executor().table is tbq.table
    assert tbq._batched_executor().dispatcher.n_rows == n
    assert tbq.qenc.table is tbq.table
    assert set(tbq.insert_seconds) == {"append", "ivf", "histograms",
                                       "graphs", "encoder_update",
                                       "rebuild"}


def test_batched_executor_of_the_old_table_is_rebuilt(inserted):
    _, tbq, *_ = inserted
    stale = tbq._batched_executor()
    state = tbq.state
    tbq.state = dataclasses.replace(state, table=Table(
        state.table.schema, state.table.vectors, state.table.scalars))
    try:
        assert tbq._batched_executor() is not stale
    finally:
        tbq.state = state
        tbq._batched = stale


def _flat_params(de) -> dict:
    out = {}
    for i, m in enumerate(de.trainable):
        for j, layer in enumerate(m.layers):
            out[f"trainable{i}.l{j}.w"] = layer.w
            out[f"trainable{i}.l{j}.b"] = layer.b
    for name in ("ae_enc", "ae_dec"):
        for j, layer in enumerate(getattr(de, name).layers):
            out[f"{name}.l{j}.w"] = layer.w
            out[f"{name}.l{j}.b"] = layer.b
    for i, fp in enumerate(de.frozen):
        for name in ("w0", "b0", "w1", "b1"):
            out[f"frozen{i}.{name}"] = getattr(fp, name)
    return {k: v.detach().numpy() for k, v in out.items()}


def test_data_encoder_update_matches_jax(inserted):
    jbq, tbq, jtest, ttest, before, (vecs, scal) = inserted
    got = _flat_params(tbq.data_encoder)
    jp = jbq.data_encoder.params
    want = {}
    for i in range(2):
        for j in range(2):
            want[f"trainable{i}.l{j}.w"] = jp["trainable"][i][f"l{j}"]["w"]
            want[f"trainable{i}.l{j}.b"] = jp["trainable"][i][f"l{j}"]["b"]
        for name in ("w0", "b0", "w1", "b1"):
            want[f"frozen{i}.{name}"] = jp["frozen"][i][name]
    for name in ("ae_enc", "ae_dec"):
        for j in range(2):
            want[f"{name}.l{j}.w"] = jp[name][f"l{j}"]["w"]
            want[f"{name}.l{j}.b"] = jp[name][f"l{j}"]["b"]
    assert set(got) == set(want)
    prior = _flat_params(before)
    moved = 0
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                   atol=ENC_ATOL, err_msg=k)
        if k.startswith("frozen"):  # no gradient, not in the optimizer
            np.testing.assert_array_equal(got[k], prior[k], err_msg=k)
        else:
            moved += not np.array_equal(got[k], prior[k])
    assert moved > 0
    for qj, qt in zip(jtest, ttest):
        np.testing.assert_allclose(
            tbq.data_encoder.recon_errors(list(qt.query_vectors),
                                          qt.predicates).numpy(),
            np.asarray(jbq.data_encoder.recon_errors(
                list(qj.query_vectors), qj.predicates)), atol=ENC_ATOL)
    for i in range(2):
        got_e = tbq.data_encoder.embed_rows(
            i, torch.as_tensor(vecs[i]), torch.as_tensor(scal))
        want_e = jbq.data_encoder.embed_rows(i, jnp.asarray(vecs[i]),
                                             jnp.asarray(scal))
        np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e),
                                   atol=ENC_ATOL)


@pytest.mark.parametrize("force", [DENSE, CANDIDATE_LOCAL])
def test_execute_batch_after_insert_matches_jax(inserted, force):
    jbq, tbq, jtest, ttest, *_ = inserted
    try:
        jbq.bind_cost_model(JCostModel(force=force))
        tbq.bind_cost_model(CostModel(force=force))
        want = jbq.execute_batch(jtest)
        got = tbq.execute_batch(ttest)
        assert set(tbq._batched_executor().dispatcher.take()[0]) == {force}
    finally:
        jbq.bind_cost_model()
        tbq.bind_cost_model()
    for (ids_t, s_t), (ids_j, s_j) in zip(got, want):
        ids_j, s_j = np.asarray(ids_j), np.asarray(s_j)
        np.testing.assert_allclose(s_t, s_j, atol=1e-4, rtol=1e-5)
        for p in np.flatnonzero(ids_t != ids_j):
            assert abs(s_t[p] - s_j[p]) <= tie_tolerance(float(s_j[p]))
    # some query's top-10 holds an inserted row
    assert any((np.asarray(ids) >= 2000).any() for ids, _ in got)


def test_own_fit_keeps_working_after_insert():
    """tests/test_core.py's floor on the port's own fit with its default
    graph tier: recall >= 0.5 after 100 inserted rows, and every index,
    histogram and graph grown to the new row count."""
    t = tds.make("part", rows=2000, seed=0, device="cpu")
    wl = tq.gen_workload(t, 20, n_vec_used=2, seed=1)
    bq = BoomHQ(t, BoomHQConfig(
        n_clusters=16, encoder=DataEncoderConfig(frozen_steps=25, ae_steps=40,
                                                 sample=512),
        rewriter=RewriterConfig(steps=80, refine_columns=False)))
    bq.fit(wl[:10])
    n0 = bq.table.n_rows
    bq.insert([v[:100].numpy() + 0.01 for v in t.vectors],
              t.scalars[:100].numpy(), finetune=True)
    n = n0 + 100
    assert bq.table.n_rows == n and float(bq.hists.n_rows) == n
    assert all(g.n_rows == n for g in bq.graphs)
    assert all(int(i.offsets[-1]) == n for i in bq.indexes)
    q = wl[12]
    gt, _ = flat.ground_truth(bq.table, list(q.query_vectors),
                              list(q.weights), q.predicates, q.k)
    ids, _ = bq.execute(q)
    assert recall_at_k(ids.numpy(), gt.numpy()) >= 0.5
