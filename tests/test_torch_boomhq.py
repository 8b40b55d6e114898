"""The port's first slice as a whole, against the JAX package.

A JAX ``BoomHQ(graph_degree=0)`` is fitted at the size of the shared
``fitted`` fixture (2000-row ``part``, a mixed conjunctive + DNF workload)
and carried across with ``repro_torch.convert``. On the same table and the
same unseen queries the port must produce the same fused features
(``atol=1e-4``), the same plans from ``optimize_batch``, and the same
``execute_batch`` results under both scoring paths (scores to ``atol=1e-4``,
ids equal except on float ties). With JAX-built graphs of the same table
carried across, fixed graph plans give the same results through both
executors. The port's OWN fit (labels priced by the values each plan
reads, so the fit does not move with the host's load) must then clear
the ``tests/test_oracle.py`` floors: mean oracle recall ≥ 0.95 on both
scoring paths, the two means within 0.02, and the default-plan batched
floor; at the default graph
degree the port builds its own graph tier and keeps graph plans.

Under ``bind_shards`` the carried fit serves the same results as JAX's on
every route (the probing route on the reference's carried per-shard
indexes), the exact sharded scan holds the exact floor over 2 and 4
shards, and fixed index_scan plans through per-shard probing on the port's
own per-shard indexes hold the single-shard mean. ``bind_shards(mesh=)``
on a one-rank ``gloo`` mesh in this process serves what JAX's one-device
mesh serves, and what a mesh refuses is refused. The query encoder's
single-query probes (``encode`` under every ablation flag,
``QueryFeatures.x_in``) match JAX on the carried state, ``x_in`` is
``encode_batch``'s row, and ``tests/test_core.py``'s pre-probe claim holds
on the port's own indexes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax  # noqa: E402

from oracle import brute_force_topk, tie_aware_recall, tie_tolerance  # noqa: E402

from repro.bench import datasets as jds  # noqa: E402
from repro.bench import queries as jq  # noqa: E402
from repro.core.boomhq import BoomHQ as JBoomHQ  # noqa: E402
from repro.core.boomhq import BoomHQConfig as JConfig  # noqa: E402
from repro.core.data_encoder import DataEncoderConfig as JDEC  # noqa: E402
from repro.core.executor import HybridExecutor as JHybridExecutor  # noqa: E402
from repro.core.query import ExecutionPlan as JPlan  # noqa: E402
from repro.core.query import SubqueryParams as JSub  # noqa: E402
from repro.core.query import default_plan as j_default_plan  # noqa: E402
from repro.core.rewriter import RewriterConfig as JRC  # noqa: E402
from repro.serve.batch import BatchedHybridExecutor as JBX  # noqa: E402
from repro.serve.batch import CostModel as JCostModel  # noqa: E402
from repro.vectordb import graph as jgraph  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.bench import datasets as tds  # noqa: E402
from repro_torch.bench import queries as tq  # noqa: E402
from repro_torch.core.boomhq import BoomHQ, BoomHQConfig  # noqa: E402
from repro_torch.core.data_encoder import DataEncoderConfig  # noqa: E402
from repro_torch.core.executor import HybridExecutor  # noqa: E402
from repro_torch.core.query import (  # noqa: E402
    ExecutionPlan, SubqueryParams, default_plan,
)
from repro_torch.core.rewriter import RewriterConfig, work_timer  # noqa: E402
from repro_torch.serve.batch import (  # noqa: E402
    CANDIDATE_LOCAL, DENSE, SHARDED_LOCAL, BatchedHybridExecutor, CostModel,
    ServingEngine,
)

FLOOR = 0.95
ENC = dict(frozen_steps=25, ae_steps=40, sample=512)
REW = dict(steps=80, refine_columns=False)


def _workload(qmod, table):
    conj = qmod.gen_workload(table, 22, n_vec_used=2, seed=1)
    dnf = qmod.gen_dnf_workload(table, 10, n_vec_used=2, seed=2,
                                clause_counts=(2, 3, 4))
    return conj[:12] + dnf[:6] + conj[12:] + dnf[6:]


def _port_config():
    return BoomHQConfig(n_clusters=16, graph_degree=0,
                        encoder=DataEncoderConfig(**ENC),
                        rewriter=RewriterConfig(**REW))


@pytest.fixture(scope="module")
def pair():
    """(JAX BoomHQ, port BoomHQ carried across, JAX test queries, port test
    queries, port table)."""
    jt = jds.make("part", rows=2000, seed=0)
    jwl = _workload(jq, jt)
    jbq = JBoomHQ(jt, JConfig(n_clusters=16, graph_degree=0,
                              encoder=JDEC(**ENC), rewriter=JRC(**REW)))
    jbq.fit(jwl[:18])
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    state = {
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
    tt = tds.make("part", rows=2000, seed=0, device="cpu")
    twl = _workload(tq, tt)
    tbq = convert.boomhq(tt, _port_config(), state)
    return jbq, tbq, jwl[18:], twl[18:], tt


def test_fused_features_match_jax(pair):
    jbq, tbq, jtest, ttest, _ = pair
    for qj, qt in zip(jtest, ttest):
        np.testing.assert_allclose(
            tbq._features_batch([qt], tbq.state)[0].numpy(),
            jbq._features(qj), atol=1e-4)


def test_optimize_batch_gives_the_same_plans(pair):
    jbq, tbq, jtest, ttest, _ = pair
    for dense in (True, False):
        pj = jbq.optimize_batch(jtest, dense=dense)
        pt = tbq.optimize_batch(ttest, dense=dense)
        assert [p.describe() for p in pt] == [p.describe() for p in pj]
        assert [p.dominant for p in pt] == [p.dominant for p in pj]
    assert tbq.optimize(ttest[0]).describe() == \
        jbq.optimize(jtest[0]).describe()


def _assert_results_match(got, want):
    """Scores to atol 1e-4; a differing id only on a float tie."""
    for (ids_t, s_t), (ids_j, s_j) in zip(got, want):
        ids_j, s_j = np.asarray(ids_j), np.asarray(s_j)
        np.testing.assert_allclose(s_t, s_j, atol=1e-4, rtol=1e-5)
        for p in np.flatnonzero(ids_t != ids_j):
            assert abs(s_t[p] - s_j[p]) <= tie_tolerance(float(s_j[p])), (
                p, ids_t, ids_j)


@pytest.mark.parametrize("force", [DENSE, CANDIDATE_LOCAL])
def test_execute_batch_matches_jax_on_both_paths(pair, force):
    jbq, tbq, jtest, ttest, _ = pair
    try:
        jbq.bind_cost_model(JCostModel(force=force))
        tbq.bind_cost_model(CostModel(force=force))
        want = jbq.execute_batch(jtest)
        got = tbq.execute_batch(ttest)
        counts = tbq._batched_executor().dispatcher.take()[0]
        assert set(counts) == {force}
    finally:
        jbq.bind_cost_model()
        tbq.bind_cost_model()
    _assert_results_match(got, want)


def test_single_query_execute_matches_jax(pair):
    """``BoomHQ.execute``: one planner pass, the sequential executor and the
    underfill escalation, query by query."""
    jbq, tbq, jtest, ttest, _ = pair
    got, want = [], []
    for qj, qt in zip(jtest[:6], ttest[:6]):
        ids, scores = tbq.execute(qt)
        got.append((ids.numpy(), scores.numpy()))
        want.append(jbq.execute(qj))
    _assert_results_match(got, want)


def test_default_plan_batched_path_matches_jax(pair):
    """Robust default plans through the batched executor, no planner."""
    jbq, tbq, jtest, ttest, _ = pair
    want = JBX(jbq.table, jbq.indexes, jbq.engine).execute_batch(
        jtest, [j_default_plan(2, jbq.engine) for _ in jtest])
    got = BatchedHybridExecutor(tbq.table, tbq.indexes, tbq.engine
                                ).execute_batch(
        ttest, [default_plan(2, tbq.engine) for _ in ttest])
    _assert_results_match(got, want)


@pytest.fixture(scope="module")
def graphs(pair):
    """JAX graphs (degree 16) of the fixture's table, and the same graphs
    carried across to the port."""
    jbq = pair[0]
    jg = tuple(jgraph.build(v, 16, metric=jbq.table.schema.metric)
               for v in jbq.table.vectors)
    tg = tuple(convert.graph_index(np.asarray(g.neighbors),
                                   np.asarray(g.entry_points), g.metric,
                                   device="cpu") for g in jg)
    return jg, tg


@pytest.mark.parametrize("knobs", [(16, 8, 8), (4, 2, 2), (8, 4, 1)],
                         ids=lambda kb: "beam{}-hops{}-kmult{}".format(*kb))
def test_graph_plans_match_jax(pair, graphs, knobs):
    """Fixed graph plans through both executors, the graphs carried
    across: ``HybridExecutor.execute`` query by query, then
    ``BatchedHybridExecutor.execute_batch`` (graph groups, pinned
    candidate-local)."""
    jbq, tbq, jtest, ttest, _ = pair
    jg, tg = graphs
    bw, nh, km = knobs

    def plans(plan_cls, sub_cls, qs):
        return [plan_cls("graph", tuple(sub_cls(k_mult=km, iterative=False)
                                        for _ in range(q.n_vec)),
                         beam_width=bw, n_hops=nh) for q in qs]

    jx = JHybridExecutor(jbq.table, jbq.indexes, jbq.engine, graphs=jg)
    tx = HybridExecutor(tbq.table, tbq.indexes, tbq.engine, graphs=tg)
    want = [jx.execute(q, p) for q, p in zip(jtest, plans(JPlan, JSub,
                                                           jtest))]
    got = [tuple(x.numpy() for x in tx.execute(q, p))
           for q, p in zip(ttest, plans(ExecutionPlan, SubqueryParams,
                                        ttest))]
    _assert_results_match(got, want)
    want = JBX(jbq.table, jbq.indexes, jbq.engine, graphs=jg).execute_batch(
        jtest, plans(JPlan, JSub, jtest))
    bx = BatchedHybridExecutor(tbq.table, tbq.indexes, tbq.engine,
                               graphs=tg)
    got = bx.execute_batch(ttest, plans(ExecutionPlan, SubqueryParams,
                                        ttest))
    assert set(bx.dispatcher.take()[0]) == {CANDIDATE_LOCAL}
    _assert_results_match(got, want)


def _oracle_recall(table, q, ids) -> float:
    _, _, masked = brute_force_topk(
        table, [qv.numpy() for qv in q.query_vectors], list(q.weights),
        q.predicates, q.k)
    return tie_aware_recall(ids, masked, q.k)


def test_own_fit_clears_oracle_floors(pair):
    """The port's own fit (torch initialisation, its own IVF k-means) on
    the fixture's training split: both scoring paths clear the mean
    oracle-recall floor and track each other; the default plan clears the
    batched floor. The labels price each plan by the elements it reads
    (``rewriter.work_timer``), not by wall-clock timings, which move with
    the host's load and with them the learned plans."""
    *_, tt = pair
    wl = _workload(tq, tt)
    bq = BoomHQ(tt, _port_config())
    metrics = bq.fit(wl[:18], label_timer=work_timer)
    assert np.isfinite(metrics["rewriter_loss"])
    test = wl[18:]
    means = {}
    try:
        for force in (DENSE, CANDIDATE_LOCAL):
            bq.bind_cost_model(CostModel(force=force))
            results, report = ServingEngine(bq, batch_size=8).serve(test)
            assert report.path_counts == {
                force: report.path_counts[force]}
            recs = [_oracle_recall(tt, q, ids)
                    for q, (ids, _) in zip(test, results)]
            assert float(np.mean(recs)) >= FLOOR, (force, recs)
            means[force] = float(np.mean(recs))
    finally:
        bq.bind_cost_model()
    assert abs(means[CANDIDATE_LOCAL] - means[DENSE]) <= 0.02, means
    bx = BatchedHybridExecutor(tt, bq.indexes, bq.engine)
    results = bx.execute_batch(test, [default_plan(2, bq.engine)
                                      for _ in test])
    recs = [_oracle_recall(tt, q, ids) for q, (ids, _) in zip(test, results)]
    assert float(np.mean(recs)) >= FLOOR, recs
    assert min(recs) >= 0.5, recs
    # the default graph degree builds the port's own graph tier, and
    # graph plans then stay graph plans
    gbq = BoomHQ(tt, dataclasses.replace(_port_config(), graph_degree=16),
                 indexes=bq.indexes, hists=bq.hists)
    assert [g.degree for g in gbq.graphs] == [16, 16]
    assert all(g.n_rows == tt.n_rows for g in gbq.graphs)
    plan = gbq.executor.legalize(ExecutionPlan(
        "graph", tuple(SubqueryParams(k_mult=8, iterative=False)
                       for _ in range(2)), beam_width=5, n_hops=3))
    assert (plan.strategy, plan.beam_width, plan.n_hops) == ("graph", 8, 4)


# ---------------------------------------------------------------------------
# logical shards (bind_shards) on the carried fit
# ---------------------------------------------------------------------------

def _carry_shard_indexes(jbq, tbq) -> None:
    """The JAX executor's per-shard indexes carried into the port's, so
    the probing route probes the same clusters."""
    jbx, tbx = jbq._batched_executor(), tbq._batched_executor()
    for c in range(tbq.table.schema.n_vec):
        js = jbx._sivf_col(c)
        tbx._sivf[c] = convert.sharded_ivf(
            np.asarray(js.centroids), np.asarray(js.sorted_rows),
            np.asarray(js.offsets), js.metric, device="cpu")


@pytest.mark.parametrize("plans,force", [
    ("learned", None), ("learned", DENSE), ("default_plan", None),
    ("default_plan", SHARDED_LOCAL)])
def test_bind_shards_execute_batch_matches_jax(pair, monkeypatch, plans,
                                                force):
    """``bind_shards(2)`` then ``execute_batch`` on the carried fit. The
    learned plans are all filter_first on this fixture, so they take the
    exact sharded scan; ``default_plan`` (both planners patched to it)
    gives index groups, which route single-device by default (1,000-row
    shards) and probe per shard when forced, on the reference's carried
    per-shard indexes. Scores to ``atol=1e-4``, a differing id only on a
    tie; the dispatcher's counts and the escalated sets equal."""
    jbq, tbq, jtest, ttest, _ = pair
    if plans == "default_plan":
        for bq, dp in ((jbq, j_default_plan), (tbq, default_plan)):
            monkeypatch.setattr(bq, "optimize_batch", lambda qs, dp=dp, **kw:
                                [dp(q.n_vec) for q in qs])
    try:
        jbq.bind_shards(2).bind_cost_model(JCostModel(force=force))
        tbq.bind_shards(2).bind_cost_model(CostModel(force=force))
        assert tbq._batched_executor().n_shards == 2
        _carry_shard_indexes(jbq, tbq)
        want = jbq.execute_batch(jtest)
        got = tbq.execute_batch(ttest)
        assert tbq._batched_executor().dispatcher.take()[0] == \
            jbq._batched_executor().dispatcher.take()[0]
        assert tbq._batched_executor().escalated == \
            jbq._batched_executor().escalated
    finally:
        jbq.bind_shards().bind_cost_model()
        tbq.bind_shards().bind_cost_model()
    assert tbq._batched_executor().n_shards == 1
    _assert_results_match(got, want)


def test_cross_shard_recall_floor_and_acceptance(pair):
    """The exact sharded scan (cost model pinned dense) over 2 and 4
    shards: per-query oracle recall at the exact floor and never below
    the single-shard learned path."""
    _, tbq, _, ttest, tt = pair
    single = tbq.execute_batch(ttest)
    recs_single = [_oracle_recall(tt, q, ids)
                   for q, (ids, _) in zip(ttest, single)]
    try:
        tbq.bind_cost_model(CostModel(force=DENSE))
        for n_shards in (2, 4):
            tbq.bind_shards(n_shards)
            recs = [_oracle_recall(tt, q, ids)
                    for q, (ids, _) in zip(ttest, tbq.execute_batch(ttest))]
            assert min(recs) >= FLOOR, (n_shards, recs)
            for rs, r1 in zip(recs, recs_single):
                assert rs >= r1 - 1e-9, (n_shards, rs, r1)
    finally:
        tbq.bind_shards().bind_cost_model()


def test_sharded_ivf_probing_acceptance(pair, monkeypatch):
    """Per-shard probing through ``BoomHQ.execute_batch`` on the port's own
    per-shard indexes (torch k-means), with per-shard escalation: mean
    oracle recall no worse than the single-shard path under the same
    plans. The plans are fixed index_scan plans (k_i = 4k, nprobe 8,
    max_scan 512): the fixture's learned plans come from a fit labelled by
    wall-clock timings, so their mix moves from run to run."""
    _, tbq, _, ttest, tt = pair
    plan = ExecutionPlan("index_scan", tuple(
        SubqueryParams(k_mult=4, nprobe=8, max_scan=512, iterative=False)
        for _ in range(2)))
    monkeypatch.setattr(tbq, "optimize_batch",
                        lambda qs, **kw: [plan] * len(qs))
    mean_single = float(np.mean([_oracle_recall(tt, q, ids) for q, (ids, _)
                                 in zip(ttest, tbq.execute_batch(ttest))]))
    try:
        tbq.bind_cost_model(CostModel(force=SHARDED_LOCAL))
        for n_shards in (2, 4):
            tbq.bind_shards(n_shards)
            got = tbq.execute_batch(ttest)
            # index groups probe per shard; a query still under k re-runs
            # through the exact filter_first (candidate-local when forced)
            counts = tbq._batched_executor().dispatcher.take()[0]
            assert counts[SHARDED_LOCAL] >= 1 and \
                set(counts) <= {SHARDED_LOCAL, CANDIDATE_LOCAL}, counts
            mean_sh = float(np.mean([_oracle_recall(tt, q, ids)
                                     for q, (ids, _) in zip(ttest, got)]))
            assert mean_sh >= mean_single - 1e-3, (n_shards, mean_sh,
                                                   mean_single)
    finally:
        tbq.bind_shards().bind_cost_model()


@pytest.mark.parametrize("plans,force", [
    ("learned", None), ("learned", DENSE), ("default_plan", SHARDED_LOCAL)])
def test_one_rank_mesh_matches_jax_one_device_mesh(pair, monkeypatch,
                                                   tmp_path, plans, force):
    """``bind_shards(mesh=)`` on a one-rank ``gloo`` mesh in this process
    against JAX's ``bind_shards(mesh=)`` on a one-device mesh: the sharded
    executor at one shard (the exact scan through the mesh's gather, the
    probing route on the bound index). Scores to ``atol=1e-4``, a
    differing id only on a tie; the dispatcher's counts and the escalated
    sets equal."""
    from jax.sharding import Mesh

    from test_torch_mesh import one_rank_mesh

    jbq, tbq, jtest, ttest, _ = pair
    if plans == "default_plan":
        for bq, dp in ((jbq, j_default_plan), (tbq, default_plan)):
            monkeypatch.setattr(bq, "optimize_batch", lambda qs, dp=dp, **kw:
                                [dp(q.n_vec) for q in qs])
    with one_rank_mesh(tmp_path) as mesh:
        try:
            jbq.bind_shards(mesh=Mesh(np.array(jax.devices()[:1]), ("data",))
                            ).bind_cost_model(JCostModel(force=force))
            tbq.bind_shards(mesh=mesh).bind_cost_model(CostModel(force=force))
            want = jbq.execute_batch(jtest)
            got = tbq.execute_batch(ttest)
            tbx, jbx = tbq._batched_executor(), jbq._batched_executor()
            assert tbx.mesh is mesh and tbx.n_shards == 1
            assert tbx.dispatcher.take()[0] == jbx.dispatcher.take()[0]
            assert tbx.escalated == jbx.escalated
        finally:
            jbq.bind_shards().bind_cost_model()
            tbq.bind_shards().bind_cost_model()
    assert tbq._batched_executor().mesh is None
    _assert_results_match(got, want)


def test_bind_shards_refuses_a_mesh(pair):
    """What ``bind_shards(mesh=)`` refuses: an object that is not a
    ``DeviceMesh`` (``TypeError``), rows that do not divide over its ranks
    (``ValueError``), and, over more than one rank, the async front-end
    anywhere but on the first rank (``ValueError`` naming
    ``serve_follower``, which the other ranks run). Tiered ingest binds
    over more than one rank, on every rank, with a ``hot_capacity`` its
    shards divide (``ValueError`` otherwise); ``insert`` belongs to the
    first rank."""
    from test_torch_mesh import fake_mesh

    from repro_torch.serve.queue import AsyncServingEngine, serve_follower

    tbq = pair[1]
    with pytest.raises(TypeError, match="DeviceMesh"):
        tbq.bind_shards(4, mesh=object())
    assert tbq.n_shards == 1 and tbq.shard_mesh is None
    with fake_mesh(3) as mesh:  # 2,000 rows over 3 ranks
        with pytest.raises(ValueError, match="not divisible"):
            tbq.bind_shards(mesh=mesh)
    assert tbq.shard_mesh is None
    with fake_mesh(4, rank=2) as mesh:
        try:
            tbq.bind_shards(mesh=mesh)
            assert tbq._batched_executor().rows == (1000, 1500)
            with pytest.raises(ValueError, match="not divisible"):
                tbq.bind_tiered(66)
            assert tbq.bind_tiered(64).tiered.row_multiple == 4
            with pytest.raises(ValueError, match="first rank"):
                tbq.insert([v.numpy()[:4] for v in tbq.table.vectors],
                           tbq.table.scalars.numpy()[:4])
            with pytest.raises(ValueError, match="serve_follower"):
                AsyncServingEngine(tbq)
        finally:
            tbq.unbind_tiered().bind_shards()
    with fake_mesh(4, rank=0) as mesh:
        try:
            tbq.bind_shards(mesh=mesh)
            assert tbq.bind_tiered(64).tiered.snapshot().log_pos == 0
            with pytest.raises(ValueError, match="first runs"):
                serve_follower(tbq)
            assert AsyncServingEngine(tbq).bq is tbq
        finally:
            tbq.unbind_tiered().bind_shards()
    assert tbq.tiered is None and tbq.n_shards == 1


# ---------------------------------------------------------------------------
# the query encoder's single-query probes
# ---------------------------------------------------------------------------

FLAGS = ("use_de", "use_stats", "use_gse", "use_lnp")


@pytest.mark.parametrize("off", [None, *FLAGS])
def test_encode_matches_jax_under_each_ablation(pair, off):
    """``QueryEncoder.encode`` on the carried state, with every feature
    group on and with each one off: X_in to ``atol=1e-4``, and the
    single-feature probes (``global_selectivity``, ``local_probe``,
    ``recon_errors``) to the same tolerance."""
    jbq, tbq, jtest, ttest, _ = pair
    flags = {f: f != off for f in FLAGS}
    for qj, qt in zip(jtest[:6], ttest[:6]):
        want = jbq.qenc.encode(qj, **flags)
        got = tbq.qenc.encode(qt, **flags)
        np.testing.assert_allclose(got.x_in().numpy(), want.x_in(),
                                   atol=1e-4)
        assert got.x_in().shape == want.x_in().shape
    qj, qt = jtest[0], ttest[0]
    assert abs(tbq.qenc.global_selectivity(qt)
               - jbq.qenc.global_selectivity(qj)) < 1e-6
    for g, w in zip(tbq.qenc.local_probe(qt), jbq.qenc.local_probe(qj)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4)
    np.testing.assert_allclose(tbq.qenc.recon_errors(qt).numpy(),
                               jbq.qenc.recon_errors(qj), atol=1e-4)


def test_encode_x_in_is_the_encode_batch_row(pair):
    """``encode(q).x_in()`` is ``encode_batch``'s row for the same query:
    bit for bit in a batch of one, and within 1e-6 as a row of the whole
    batch."""
    _, tbq, _, ttest, _ = pair
    rows = tbq._features_batch(ttest, tbq.state)
    for j, q in enumerate(ttest):
        x = tbq.qenc.encode(q).x_in()
        assert torch.equal(x, tbq._features_batch([q], tbq.state)[0]), j
        np.testing.assert_allclose(x.numpy(), rows[j].numpy(), atol=1e-6)


def test_local_probe_tracks_neighborhood_density(pair):
    """``tests/test_core.py``'s claim on the port's own indexes: a
    predicate the row's own neighborhood satisfies rates above an
    impossible one, and the impossible one rates 0."""
    from repro_torch.core.query import MHQ
    from repro_torch.core.query_encoder import QueryEncoder
    from repro_torch.vectordb import histogram, ivf
    from repro_torch.vectordb.predicates import Predicates

    table = pair[4]
    idxs = [ivf.build(v, 16, seed=i) for i, v in enumerate(table.vectors)]
    qe = QueryEncoder(table, idxs, histogram.build(table.scalars), None)
    m = table.schema.n_scalar
    row = 17
    qv = tuple(v[row] for v in table.vectors)
    scal = table.scalars.numpy()
    pred_local = Predicates.from_conditions(
        m, {0: (float(scal[row, 0]), float(scal[row, 0]))}, device="cpu")
    pred_none = Predicates.from_conditions(m, {2: (1e9, 2e9)}, device="cpu")
    r1, _ = qe.local_probe(MHQ(qv, (1.0, 0.0), pred_local))
    r2, _ = qe.local_probe(MHQ(qv, (1.0, 0.0), pred_none))
    assert r1[0] > r2[0]
    assert r2[0] == 0.0
