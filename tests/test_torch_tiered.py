"""Tiered streaming ingest of the port against the JAX package.

A JAX ``BoomHQ`` is fitted as ``tests/test_tiered.py``'s fixture fits it
(1,200-row ``part``, its default degree-16 graph tier) and carried across
with ``repro_torch.convert``; then both ``bind_tiered`` and take the same
inserts. In definition order (the tests share the two instances):

* an empty hot segment changes nothing, bit for bit, and both packages
  serve the same results;
* after inserts, hot and cold results through ``execute_batch(snapshot=)``
  equal JAX's (scores to ``atol=1e-4``, a differing id only on a float
  tie), on the port's own snapshot and on JAX's snapshot carried across
  with ``convert.cold_state``/``tiered_snapshot``; an inserted row is
  visible to the very next batch; recall against the hot ∪ cold oracle
  (``tests/oracle.tiered_brute_force_topk``) ≥ 0.9;
* after a compaction the epoch, compaction count, table, IVF layouts,
  histograms and graphs equal JAX's and so do the results; a batch formed
  before the swap replays bit for bit on its snapshot;
* hot rows are filtered exactly; the ``rebuild_every`` decision is taken
  at seal time; publishing a view costs no device transfer; compaction
  runs in the background under the async engine with every request
  served, and ``unbind_tiered`` folds leftover hot rows in;
* under ``bind_shards(2)`` an empty hot segment still changes nothing,
  and under ``bind_shards(4)`` hot rows and their compaction serve JAX's
  results.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

from oracle import (  # noqa: E402
    eval_mask_np, tie_aware_recall, tiered_brute_force_topk,
)
from test_torch_semcache import (  # noqa: E402
    _graph_dicts, _hist_dict, _index_dicts, _port_mhq, _port_table, _same,
    _state,
)

from repro.bench import datasets as jds  # noqa: E402
from repro.bench import queries as jq  # noqa: E402
from repro.core.boomhq import BoomHQ as JBoomHQ  # noqa: E402
from repro.core.boomhq import BoomHQConfig as JConfig  # noqa: E402
from repro.core.data_encoder import DataEncoderConfig as JDEC  # noqa: E402
from repro.core.rewriter import RewriterConfig as JRC  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core.boomhq import BoomHQConfig  # noqa: E402
from repro_torch.core.data_encoder import DataEncoderConfig  # noqa: E402
from repro_torch.core.rewriter import RewriterConfig  # noqa: E402
from repro_torch.serve.queue import AsyncServingEngine  # noqa: E402
from repro_torch.vectordb import tiered as T  # noqa: E402
from repro_torch.vectordb.table import Table  # noqa: E402

ROWS = 1200
ENC = dict(frozen_steps=10, ae_steps=15, sample=256)
REW = dict(steps=30, refine_columns=False)
_STATE: dict = {}  # measurements the ordered progression carries along


@pytest.fixture(scope="module")
def pair():
    """(JAX BoomHQ, port BoomHQ carried across, JAX held queries, port held
    queries)."""
    jt = jds.make("part", rows=ROWS, seed=0)
    wl = jq.gen_workload(jt, 36, n_vec_used=2, seed=1)
    jbq = JBoomHQ(jt, JConfig(n_clusters=8, encoder=JDEC(**ENC),
                              rewriter=JRC(**REW)))
    jbq.fit(wl[:12])
    tbq = convert.boomhq(_port_table(jt), BoomHQConfig(
        n_clusters=8, encoder=DataEncoderConfig(**ENC),
        rewriter=RewriterConfig(**REW)), _state(jbq))
    return jbq, tbq, wl[12:], [_port_mhq(q) for q in wl[12:]]


def _fresh_rows(n: int, seed: int):
    extra = jds.make("part", rows=n, seed=seed)
    return [np.asarray(v) for v in extra.vectors], np.asarray(extra.scalars)


def _same_all(got_list, want_list) -> None:
    assert len(got_list) == len(want_list)
    for got, want in zip(got_list, want_list):
        _same(got, want)


def _segments(snap):
    """A port snapshot -> the oracle's segments in global row-id order."""
    segs = [([v.numpy() for v in snap.cold.table.vectors],
             snap.cold.table.scalars.numpy())]
    for view in snap.hot_views:
        segs.append(([b[: view.count] for b in view.np_vectors],
                     view.np_scalars[: view.count]))
    return segs


def _union_recall(snap, qs, results) -> float:
    segs = _segments(snap)
    metric = snap.cold.table.schema.metric
    recs = []
    for q, (ids, _) in zip(qs, results):
        _i, _s, masked = tiered_brute_force_topk(
            segs, metric, q.query_vectors, q.weights, q.predicates, q.k)
        recs.append(tie_aware_recall(np.asarray(ids), masked, q.k))
    return float(np.mean(recs))


def _carried(jsnap):
    """A JAX TieredSnapshot carried across through ``convert``."""
    jc = jsnap.cold
    cold = convert.cold_state(
        _port_table(jc.table).schema,
        [np.array(v) for v in jc.table.vectors],
        np.array(jc.table.scalars), _index_dicts(jc.indexes),
        _hist_dict(jc.hists), _graph_dicts(jc.graphs), device="cpu")
    return convert.tiered_snapshot(jsnap.epoch, cold, [
        dict(np_vectors=v.np_vectors, np_scalars=v.np_scalars,
             count=v.count, id_offset=v.id_offset)
        for v in jsnap.hot_views])


# -- 1: an empty hot segment changes nothing ---------------------------------

def test_empty_hot_bitforbit_parity(pair):
    jbq, tbq, jheld, theld = pair
    base = tbq.execute_batch(theld[:8])
    jbq.bind_tiered(hot_capacity=128)
    tbq.bind_tiered(hot_capacity=128)
    assert tbq.tiered.snapshot().n_hot == 0
    got = tbq.execute_batch(theld[:8])
    for (bi, bs), (ti, ts) in zip(base, got):
        assert np.array_equal(bi, ti) and np.array_equal(bs, ts)
    _same_all(got, jbq.execute_batch(jheld[:8]))


# -- 2: inserts — hot and cold against JAX, own and carried snapshots --------

@pytest.mark.parametrize("snapshot", ["own", "carried"])
def test_inserts_match_jax(pair, snapshot):
    jbq, tbq, jheld, theld = pair
    if "inserted" not in _STATE:
        vecs, scal = _fresh_rows(64, seed=7)
        jstats, tstats = jbq.insert(vecs, scal), tbq.insert(vecs, scal)
        assert tstats == jstats
        assert tstats["inserted"] == 64 and not tstats["needs_compaction"]
        _STATE["inserted"] = True
    jsnap = jbq.tiered.snapshot()
    tsnap = tbq.tiered.snapshot() if snapshot == "own" else _carried(jsnap)
    assert (tsnap.epoch, tsnap.n_hot, tsnap.n_rows) == \
        (jsnap.epoch, jsnap.n_hot, jsnap.n_rows) == (0, 64, ROWS + 64)
    recent = [id(q) for q in tbq._recent]
    got = tbq.execute_batch(theld[8:16], snapshot=tsnap)
    assert [id(q) for q in tbq._recent] == recent  # only outer calls record
    _same_all(got, jbq.execute_batch(jheld[8:16], snapshot=jsnap))
    assert _union_recall(tsnap, theld[8:16], got) >= 0.9


def test_insert_visible_before_compaction(pair):
    jbq, tbq, jheld, theld = pair
    q = theld[8]
    snap = tbq.tiered.snapshot()
    sentinel_id = snap.n_rows  # the next global id
    big = [100.0 * v.numpy()[None] for v in q.query_vectors]
    mask = eval_mask_np(q.predicates, tbq.table.scalars.numpy())
    passing = int(np.argmax(mask))
    assert mask[passing]
    row = tbq.table.scalars.numpy()[passing: passing + 1]
    tbq.insert(big, row)
    jbq.insert(big, row)
    ids, _ = tbq.execute_batch([q])[0]
    assert int(ids[0]) == sentinel_id
    _same_all(tbq.execute_batch(theld[:8]), jbq.execute_batch(jheld[:8]))


# -- 3: compaction — the same cold epoch as JAX ------------------------------

def test_compaction_matches_jax_and_isolates_snapshots(pair):
    jbq, tbq, jheld, theld = pair
    vecs, scal = _fresh_rows(55, seed=8)  # 65 + 55 = 10% of 1200
    jbq.insert(vecs, scal)
    tbq.insert(vecs, scal)
    snap_a = tbq.tiered.snapshot()
    assert snap_a.n_rows == ROWS + 120 and snap_a.hot_views
    r1 = tbq.execute_batch(theld[:6], snapshot=snap_a)
    out = tbq.tiered.compact()
    jout = jbq.tiered.compact()
    assert (out["compacted"], out["epoch"], out["rebuild"]) == \
        (jout["compacted"], jout["epoch"], jout["rebuild"]) == (120, 1, False)
    assert set(out) == set(jout)
    assert (tbq.tiered.epoch, tbq.tiered.n_compactions) == \
        (jbq.tiered.epoch, jbq.tiered.n_compactions)
    tc, jc = tbq.tiered.snapshot().cold, jbq.tiered.snapshot().cold
    assert tc.table.n_rows == ROWS + 120 and tbq.table is tc.table
    for a, b in zip(tc.table.vectors, jc.table.vectors):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for ti, ji in zip(tc.indexes, jc.indexes):
        np.testing.assert_array_equal(ti.sorted_rows.numpy(),
                                      np.asarray(ji.sorted_rows))
        np.testing.assert_array_equal(ti.offsets.numpy(),
                                      np.asarray(ji.offsets))
    np.testing.assert_array_equal(tc.hists.prefix.numpy(),
                                  np.asarray(jc.hists.prefix))
    for tg, jg in zip(tc.graphs, jc.graphs):
        np.testing.assert_array_equal(tg.neighbors.numpy(),
                                      np.asarray(jg.neighbors))
    # a batch formed BEFORE the swap replays bit for bit on its snapshot
    r2 = tbq.execute_batch(theld[:6], snapshot=snap_a)
    for (i1, s1), (i2, s2) in zip(r1, r2):
        assert np.array_equal(i1, i2) and np.array_equal(s1, s2)
    # after the swap: the same logical rows, no loss of recall, JAX's
    # results
    snap_b = tbq.tiered.snapshot()
    assert snap_b.n_rows == snap_a.n_rows and not snap_b.hot_views
    r3 = tbq.execute_batch(theld[:6], snapshot=snap_b)
    assert _union_recall(snap_a, theld[:6], r3) >= \
        _union_recall(snap_a, theld[:6], r1) - 0.02
    _same_all(tbq.execute_batch(theld[:16]), jbq.execute_batch(jheld[:16]))


# -- 5 of tests/test_tiered.py: parity holds under bind_shards too ----------

def test_sharded_empty_hot_parity(pair):
    """After the compaction the hot segment is empty: under
    ``bind_shards(2)`` the tiered instance serves bit for bit what the
    untiered one serves, and the same results as JAX's (the 660-row
    shards route index groups single-device, filter_first groups take the
    exact sharded scan)."""
    jbq, tbq, jheld, theld = pair
    assert not tbq.tiered.snapshot().hot_views
    tbq.bind_shards(2)
    jbq.bind_shards(2)
    try:
        got = tbq.execute_batch(theld[:6])
        assert tbq._batched_executor().n_shards == 2
        _same_all(got, jbq.execute_batch(jheld[:6]))
        tbq.unbind_tiered()
        base = tbq.execute_batch(theld[:6])
    finally:
        tbq.bind_shards(1)
        jbq.bind_shards(1)
    for (bi, bs), (ti, ts) in zip(base, got):
        assert np.array_equal(bi, ti) and np.array_equal(bs, ts)


def test_sharded_hot_rows_and_compaction_match_jax(pair):
    """Under ``bind_shards(4)`` with rows hot, then after a compaction swaps
    them cold: the port serves JAX's results (scores to ``atol=1e-4``, a
    differing id only on a float tie) on both sides of the swap, and every
    hot row of the oracle's top-k first (recall ≥ 0.9) — the one-process
    baseline a mesh of four ranks is held to."""
    jbq, tbq, jheld, theld = pair
    jbq.unbind_tiered()  # its hot segment is empty (the test above)
    for bq in (jbq, tbq):
        bq.bind_tiered(hot_capacity=64).bind_shards(4)
    try:
        vecs, scal = _fresh_rows(40, seed=24)
        for bq in (jbq, tbq):
            bq.insert(vecs, scal)
        snap = tbq.tiered.snapshot()
        assert (snap.n_hot, snap.epoch) == (40, jbq.tiered.epoch)
        got = tbq.execute_batch(theld[:8])
        assert tbq._batched_executor().n_shards == 4
        _same_all(got, jbq.execute_batch(jheld[:8]))
        assert _union_recall(snap, theld[:8], got) >= 0.9
        out, jout = tbq.tiered.compact(), jbq.tiered.compact()
        assert (out["compacted"], out["epoch"]) == \
            (jout["compacted"], jout["epoch"]) == (40, snap.epoch + 1)
        after = tbq.tiered.snapshot()
        assert not after.hot_views and after.n_rows == snap.n_rows
        got = tbq.execute_batch(theld[:8])
        _same_all(got, jbq.execute_batch(jheld[:8]))
        assert _union_recall(snap, theld[:8], got) >= 0.9
    finally:
        for bq in (jbq, tbq):
            bq.unbind_tiered().bind_shards(1)


# -- 4: standalone claims of tests/test_tiered.py on the port ----------------

def test_hot_rows_filtered_exactly(pair):
    _, tbq, _, theld = pair
    tbq.bind_tiered(hot_capacity=32)
    scal = tbq.table.scalars.numpy()
    for q in theld:
        mask = eval_mask_np(q.predicates, scal)
        if not mask.all():
            break
    failing = int(np.argmin(mask))
    assert not mask[failing]
    first_hot = tbq.table.n_rows
    big = [100.0 * v.numpy()[None] for v in q.query_vectors]
    tbq.insert(big, scal[failing: failing + 1])
    snap = tbq.tiered.snapshot()
    ids, _ = tbq.execute_batch([q], snapshot=snap)[0]
    assert first_hot not in ids
    _, _, masked = tiered_brute_force_topk(
        _segments(snap), "dot", q.query_vectors, q.weights, q.predicates,
        q.k)
    assert all(masked[i] > -1e29 for i in ids if i >= 0)
    tbq.unbind_tiered()
    assert tbq.table.n_rows == first_hot + 1  # folded in eagerly


def test_compact_rebuild_decision_locked_at_seal(pair, monkeypatch):
    _, tbq, _, _ = pair
    t = T.TieredTable(tbq.table, tbq.indexes, tbq.hists, hot_capacity=4,
                      rebuild_every=2)
    t.insert(*_fresh_rows(4, seed=21))
    r1 = t.compact()
    assert r1["compacted"] == 4 and r1["rebuild"] is False  # seq 1
    t.insert(*_fresh_rows(4, seed=22))
    orig = Table.append

    def racing_append(self, *a, **kw):
        # another compaction's counter bump landing inside this one's
        # unlocked heavy phase
        t._compactions += 9
        return orig(self, *a, **kw)

    monkeypatch.setattr(Table, "append", racing_append)
    r2 = t.compact()
    assert r2["compacted"] == 4 and r2["rebuild"] is True  # seq 2


def test_insert_publishes_without_device_transfers(pair):
    _, tbq, _, _ = pair
    t = T.TieredTable(tbq.table, tbq.indexes, tbq.hists, hot_capacity=64)
    vecs, scal = _fresh_rows(8, seed=23)
    base = T.hot_view_transfers()
    for i in range(8):
        t.insert([v[i: i + 1] for v in vecs], scal[i: i + 1])
    assert T.hot_view_transfers() - base == 0  # 8 publishes, 0 transfers
    view = t.snapshot().hot_views[0]
    _ = view.vectors, view.scalars
    per_view = len(vecs) + 1
    assert T.hot_view_transfers() - base == per_view
    _ = view.vectors  # cached per view
    assert T.hot_view_transfers() - base == per_view
    # a late materialization reads exactly the rows the view froze
    view2 = t.snapshot().hot_views[0]
    t.insert([v[:2] for v in vecs], scal[:2])
    assert view2.count == 8
    np.testing.assert_array_equal(view2.scalars.numpy()[:8], scal[:8])


def test_async_engine_background_compaction(pair):
    _, tbq, _, theld = pair
    tbq.bind_tiered(hot_capacity=64)
    vecs, scal = _fresh_rows(100, seed=9)
    n0 = tbq.table.n_rows

    async def main():
        eng = AsyncServingEngine(tbq, batch_size=6, max_wait=0.01)
        async with eng:
            tasks = [asyncio.ensure_future(eng.submit(q)) for q in theld]
            # ingest mid-stream: fills the 64-row hot segment, and the
            # engine's CompactionScheduler folds it cold on its own worker
            tbq.insert(vecs, scal)
            reqs = await asyncio.gather(*tasks)
        return eng, reqs

    eng, reqs = asyncio.run(main())
    assert all(r.status == "ok" for r in reqs)
    assert all(r.snapshot is not None for r in reqs)
    rep = eng.report()
    assert rep.n_timed_out == 0
    assert rep.n_inserted >= 100 and rep.n_compactions >= 1
    assert rep.epoch == tbq.tiered.epoch
    assert "inserted" in rep.describe()
    assert tbq._compactor is None  # the engine detached its scheduler
    snap = tbq.tiered.snapshot()
    assert snap.cold.table.n_rows + snap.n_hot == n0 + 100
    tbq.unbind_tiered()  # the rows still hot fold in eagerly
    assert tbq.table.n_rows == n0 + 100 and tbq.tiered is None
