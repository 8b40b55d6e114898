"""Tiered streaming ingest over a mesh of four ``gloo`` ranks: the first rank
runs ``AsyncServingEngine`` with a ``SemanticCache`` and owns ingest and
the epoch cuts; the others run ``serve_follower`` and replay them.

The instance is ``tests/test_torch_mesh_serve.py``'s (the 900-row tenant
instance of ``tests/test_semcache.py``, fitted once in JAX and carried
with ``convert.boomhq``), bound to a ``(data,)`` mesh of four ranks and
``bind_tiered(hot_capacity=32, rebuild_every=2)``. The module fixture
starts four rank processes of this file. The first rank serves ``SCRIPT``:
at each step one wave of held requests (tenants and repeats, batches of 4
cut as they queue), a second wave of repeats (cache hits), then a chunk
of fresh rows through ``BoomHQ.insert``; its ``CompactionScheduler``
compacts full hot generations in the background, and one chunk is
inserted while nothing compacts, so that it compacts inline. Then every
rank drives the SPMD path without an engine (``tiered.insert`` and
``execute_batch`` on every rank), once alike and once with one more row
on rank 3.

The test process then replays the first rank's log (each batch's stamp,
hot-view layout and queries, and the row range of each compaction it
ran) through the port's one-process tiered engine and JAX's ``BoomHQ``,
both over logical ``bind_shards(4)``: each compaction driven explicitly
with ``tiered.compact()`` where the log puts it, each batch on a snapshot
built at its stamp. Alongside, the mesh refusals run on torch's fake
process group.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_mesh_tiered.py``.
"""
import asyncio
import dataclasses
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

from test_torch_mesh_serve import (  # noqa: E402
    N_RANKS, ROWS, TENANTS, _host, _jax_instance, _requests, _world,
)

HOT_CAPACITY = 32
REBUILD_EVERY = 2
BATCH = 4
MAX_WAIT = 0.05
WORLD_TIMEOUT_S = 120
TIMEOUT_S = 300  # a rank process's whole run
SCORE_TOL = dict(atol=1e-5, rtol=0)
# each step: (first wave, second wave of repeats, rows inserted after,
# whether the chunk must compact inline); a request is (held query, tenant)
WAVE = [(0, 0), (1, 1), (2, 2), (3, None), (4, 0), (5, 1), (0, 2), (1, None)]
REPEATS = [(0, 0), (3, None)]
CHUNKS = (20, 30, 40, 70, 25, 33, 17)
INLINE = 3  # the 70-row chunk: both hot generations fill within one insert
SCRIPT = [(WAVE[i:] + WAVE[:i], REPEATS, n, i == INLINE)
          for i, n in enumerate(CHUNKS)] + [(WAVE, REPEATS, 0, False)]
SPMD_ROWS = 5  # the SPMD part's rows, inserted on every rank
FIRST_RANK_SLOWER_S = 1.0  # added to each of the first rank's compactions
# requests served while the first rank compacts, a batch of new ones a
# round (each misses the cache once an epoch)
DURING = [(i, t) for t in (0, 1, 2, None) for i in range(6)]
DURING_ROUNDS = 3


def _fresh_rows(n: int, seed: int) -> tuple:
    """``n`` rows of ``part`` with a tenant column: (vectors, scalars)."""
    from repro.bench import datasets as jds

    extra = jds.make("part", rows=n, seed=seed)
    tenant = np.random.default_rng(seed).integers(0, TENANTS, n)
    return ([np.asarray(v, np.float32) for v in extra.vectors],
            np.concatenate([np.asarray(extra.scalars, np.float32),
                            tenant[:, None].astype(np.float32)], axis=1))


def _digest(bq) -> int:
    from repro_torch.vectordb.tiered import cold_digest
    return cold_digest(bq.tiered.snapshot().cold)


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------

def _audit(cache) -> list:
    """Each hit's lookup token beside the token its entry was stored
    under."""
    from repro_torch.serve.semcache import query_signature

    stored, hits = {}, []
    lookup, insert = cache.lookup, cache.insert

    def key(q):
        return (q.tenant_id, query_signature(q),
                b"".join(v.numpy().tobytes() for v in q.query_vectors))

    def logged_lookup(q, token):
        got = lookup(q, token)
        if got is not None:
            hits.append((tuple(token), stored.get(key(q))))
        return got

    def logged_insert(q, token, ids, scores):
        stored[key(q)] = tuple(token)
        insert(q, token, ids, scores)

    cache.lookup, cache.insert = logged_lookup, logged_insert
    return hits


def _front(bq, x: dict) -> dict:
    """The first rank's session: ``SCRIPT`` through the engine."""
    from repro_torch.serve.queue import AsyncServingEngine
    from repro_torch.serve.semcache import SemanticCache

    cache = SemanticCache(eps=0.0)
    hits = _audit(cache)
    eng = AsyncServingEngine(bq, batch_size=BATCH, max_wait=MAX_WAIT,
                             semcache=cache)
    held = x["held"]
    rows = iter(x["chunks"])

    async def main():
        reqs = []
        async with eng:
            for first, second, n, inline in SCRIPT:
                while not n and compacting():  # the last step: no swap
                    await asyncio.sleep(0.01)  # between its two waves
                for wave in (first, second):
                    got = await asyncio.gather(*(
                        eng.submit(dataclasses.replace(held[i], tenant_id=t))
                        for i, t in wave))
                    reqs += [(r, i, t) for r, (i, t) in zip(got, wave)]
                if not n:
                    continue
                if inline:  # nothing compacts, so this insert compacts
                    while compacting():
                        await asyncio.sleep(0.01)
                    epoch = bq.tiered.epoch
                    bq.insert(*next(rows))
                    assert bq.tiered.epoch >= epoch + 1  # inline
                    continue
                bq.insert(*next(rows))
                # traffic goes on while the first rank compacts: batches
                # cut on the old epoch reach the followers after their
                # own compaction has finished
                for _ in range(DURING_ROUNDS):
                    if not compacting():
                        break
                    wave = [DURING[(during[0] + j) % len(DURING)]
                            for j in range(BATCH)]
                    during[0] += BATCH
                    got = await asyncio.gather(*(
                        eng.submit(dataclasses.replace(held[i], tenant_id=t))
                        for i, t in wave))
                    reqs += [(r, i, t) for r, (i, t) in zip(got, wave)]
                    await asyncio.sleep(0.1)
        return reqs

    during = [0]

    def compacting():
        c = eng._compactor
        return c._inflight is not None and not c._inflight.done()

    reqs = asyncio.run(main())
    asked = {r.seq: (i, t) for r, i, t in reqs}
    reqs = [r for r, _, _ in reqs]
    by_seq = {r.seq: r for r in reqs}
    batches = []
    for seqs in eng.batch_seqs:
        snap = by_seq[seqs[0]].snapshot
        batches.append(dict(
            seqs=list(seqs), stamp=snap.stamp,
            views=[(v.id_offset, v.count) for v in snap.hot_views],
            results=[_host(by_seq[s].result) for s in seqs]))
    return dict(
        requests=[dict(seq=r.seq, status=r.status, hit=r.cache_hit,
                       asked=asked[r.seq], result=_host(r.result),
                       stamp=None if r.snapshot is None
                       else r.snapshot.stamp) for r in reqs],
        batches=batches, hits=hits, n_compactions=bq.tiered.n_compactions,
        report_epoch=eng.report().epoch)


def _spmd(bq, x: dict, r: int) -> dict:
    """The SPMD path without an engine: the same rows and batch on every
    rank, then one more row on rank 3 only."""
    from repro_torch.vectordb.distributed import is_shared

    vecs, scal = x["spmd_rows"]
    qs = x["held"][:BATCH]
    bq.tiered.insert([v[:SPMD_ROWS] for v in vecs], scal[:SPMD_ROWS])
    alike = [_host(res) for res in bq.execute_batch(qs)]
    if r == 3:
        bq.tiered.insert([v[SPMD_ROWS:] for v in vecs], scal[SPMD_ROWS:])
    try:
        bq.execute_batch(qs)
        raised = None
    except RuntimeError as exc:
        raised = (str(exc), is_shared(exc))
    return dict(alike=alike, raised=raised)


def _rank(r: int, d: str) -> None:
    from repro_torch import convert
    from repro_torch.serve.queue import serve_follower

    torch.set_num_threads(1)
    with open(f"{d}/inputs.pkl", "rb") as f:
        x = pickle.load(f)
    bq = convert.boomhq(x["table"], x["cfg"], x["state"]).bind_tenants(
        "tenant")
    compactions = []
    on_compaction = bq._on_compaction

    def logged(cold, first_new, n_new):
        on_compaction(cold, first_new, n_new)
        compactions.append((first_new, first_new + n_new))
        if r == 0:
            # the first rank's compactions take longer than the
            # followers' (on the card its encoder fine-tune does), so a
            # follower finishes first and must hold its publish until
            # the first rank's log has published that epoch
            time.sleep(FIRST_RANK_SLOWER_S)

    bq._on_compaction = logged  # bind_tiered hands the table this one
    plans = []
    optimize = bq.optimize_batch
    bq.optimize_batch = lambda *a, **kw: plans.append(1) or optimize(*a,
                                                                     **kw)
    out = {}
    with _world(f"{d}/store", r, WORLD_TIMEOUT_S) as mesh:
        bq.bind_shards(mesh=mesh).bind_tiered(HOT_CAPACITY,
                                              rebuild_every=REBUILD_EVERY)
        if r == 0:
            out["front"] = _front(bq, x)
        else:
            served = serve_follower(bq)
            out["followed"] = dict(
                results=[None if res is None else [_host(y) for y in res]
                         for res in served.results],
                errors={b: repr(e) for b, e in served.errors.items()},
                stamps=served.stamps, final=served.final.stamp)
        out["final"] = bq.tiered.snapshot().stamp
        out["digest"] = _digest(bq)
        out["compactions"] = list(compactions)
        out["optimize_calls"] = len(plans)
        out["spmd"] = _spmd(bq, x, r)
    with open(f"{d}/rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# the module fixture: the ranks, then the two replays of the first rank's log
# ---------------------------------------------------------------------------

def _port_snapshot(tiered, epoch: int, views: list, rows: tuple):
    """The port's snapshot at a stamp: ``tiered``'s cold state (at that
    epoch) and hot views of the global ``rows`` laid out as logged."""
    from repro_torch.vectordb.tiered import HotView, TieredSnapshot

    cold = tiered.snapshot().cold
    assert tiered.epoch == epoch
    return TieredSnapshot(epoch=epoch, cold=cold, hot_views=tuple(
        HotView(*_view_buffers(rows, off, count), count, off, "cpu")
        for off, count in views))


def _view_buffers(rows: tuple, off: int, count: int) -> tuple:
    """Full-capacity host buffers of a hot view of global rows
    ``[off, off + count)`` (``rows`` start at global row ``ROWS``)."""
    vecs, scal = rows
    off -= ROWS
    bufs = [np.zeros((HOT_CAPACITY, v.shape[1]), np.float32) for v in vecs]
    sbuf = np.zeros((HOT_CAPACITY, scal.shape[1]), np.float32)
    for b, v in zip(bufs, vecs):
        b[:count] = v[off: off + count]
    sbuf[:count] = scal[off: off + count]
    return tuple(bufs), sbuf


def _replay(bq, batches: list, compactions: list, rows: tuple, queries,
            snapshot) -> list:
    """Each logged batch through ``bq`` (tiered, over logical shards) on a
    snapshot at its stamp: before it, the compactions its epoch needs, each
    on exactly the logged rows (inserted, then ``tiered.compact()``).
    -> per batch, each query's (ids, scores)."""
    vecs, scal = rows
    have = ROWS
    out = []
    for b in batches:
        epoch = b["stamp"][0]
        while bq.tiered.epoch < epoch:
            a, end = compactions[bq.tiered.epoch]
            assert a == bq.tiered.snapshot().cold.table.n_rows
            bq.tiered.insert([v[have - ROWS: end - ROWS] for v in vecs],
                             scal[have - ROWS: end - ROWS])
            have = end
            bq.tiered.compact()
        snap = snapshot(bq.tiered, epoch, b["views"], rows)
        out.append([_host(res) for res in bq.execute_batch(
            queries(b["seqs"]), snapshot=snap)])
    return out


def _jax_snapshot(tiered, epoch: int, views: list, rows: tuple):
    """JAX's snapshot at a stamp, as ``_port_snapshot``."""
    from repro.vectordb.tiered import HotView, TieredSnapshot

    assert tiered.epoch == epoch
    return TieredSnapshot(epoch=epoch, cold=tiered.snapshot().cold,
                          hot_views=tuple(
                              HotView(*_view_buffers(rows, off, count),
                                      count, off)
                              for off, count in views))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from test_torch_semcache import _port_mhq, _port_table, _state

    from repro_torch import convert
    from repro_torch.core.boomhq import BoomHQConfig
    from repro_torch.core.rewriter import RewriterConfig

    d = str(tmp_path_factory.mktemp("mesh_tiered"))
    jbq, jheld = _jax_instance()
    table = _port_table(jbq.table)
    cfg = BoomHQConfig(n_clusters=8, use_de=False, rewriter=RewriterConfig(
        steps=10, refine_columns=False))
    state = _state(jbq)
    held = [_port_mhq(q) for q in jheld]
    chunks = [_fresh_rows(n, 100 + i) for i, n in enumerate(CHUNKS)]
    spmd = _fresh_rows(SPMD_ROWS + 1, 99)
    with open(f"{d}/inputs.pkl", "wb") as f:
        pickle.dump(dict(table=table, cfg=cfg, state=state, held=held,
                         chunks=chunks, spmd_rows=spmd), f)
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    me = os.path.abspath(__file__)
    ranks = [subprocess.Popen([sys.executable, me, str(r), d], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(N_RANKS)]
    t0 = time.monotonic()
    try:
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    ranks_s = time.monotonic() - t0
    for r, (p, err) in enumerate(zip(ranks, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    out = []
    for r in range(N_RANKS):
        with open(f"{d}/rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    # the log: the rows in global id order, the first rank's compactions
    # and batches
    rows = ([np.concatenate([c[0][i] for c in chunks]) for i in range(2)],
            np.concatenate([c[1] for c in chunks]))
    front = out[0]["front"]
    by_seq = {q["seq"]: q for q in front["requests"]}
    compactions = out[0]["compactions"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        tbq = convert.boomhq(table, cfg, state).bind_tenants("tenant")
        tbq.bind_tiered(HOT_CAPACITY, rebuild_every=REBUILD_EVERY)
        tbq.bind_shards(N_RANKS)
        port = _replay(tbq, front["batches"], compactions, rows,
                       lambda seqs: _requests(
                           held, [by_seq[s]["asked"] for s in seqs]),
                       _port_snapshot)
    finally:
        torch.set_num_threads(threads)
    jbq.bind_tiered(HOT_CAPACITY, rebuild_every=REBUILD_EVERY)
    jbq.bind_shards(N_RANKS)
    jax_out = _replay(jbq, front["batches"], compactions, rows,
                      lambda seqs: _requests(
                          jheld, [by_seq[s]["asked"] for s in seqs]),
                      _jax_snapshot)
    return dict(ranks=out, port=port, jax=jax_out, rows=rows, held=held,
                tbq=tbq, ranks_s=ranks_s, table=table, cfg=cfg, state=state)


# ---------------------------------------------------------------------------
# the claims
# ---------------------------------------------------------------------------

def _followers(run):
    return [run["ranks"][r]["followed"] for r in range(1, N_RANKS)]


def test_followers_equal_the_first_rank_batch_for_batch(run):
    """Every follower ran the first rank's batches, in order, each with
    results equal bit for bit and no error."""
    batches = run["ranks"][0]["front"]["batches"]
    assert len(batches) >= 2 * len(SCRIPT)
    for r, f in enumerate(_followers(run), 1):
        assert f["errors"] == {} and len(f["results"]) == len(batches), r
        for j, (got, b) in enumerate(zip(f["results"], batches)):
            for (gi, gs), (wi, ws) in zip(got, b["results"]):
                np.testing.assert_array_equal(gi, wi, f"rank {r} batch {j}")
                np.testing.assert_array_equal(gs, ws, f"rank {r} batch {j}")


def test_every_batch_runs_on_its_stamp_and_every_rank_ends_alike(run):
    """Each batch's stamp is the (epoch, cold rows, rows) of the snapshot
    every rank executed it on; the stamps span two epochs or more; the
    first rank compacted five times or more (every second one a
    re-cluster), and every rank ends on its final stamp with an equal
    cold-state digest."""
    front = run["ranks"][0]["front"]
    stamps = [tuple(b["stamp"]) for b in front["batches"]]
    for r, f in enumerate(_followers(run), 1):
        assert [tuple(s) for s in f["stamps"]] == stamps, r
        assert tuple(f["final"]) == tuple(run["ranks"][0]["final"]), r
    assert len({s[0] for s in stamps}) >= 2
    assert stamps == sorted(stamps)
    n = front["n_compactions"]
    assert n >= 5 and front["report_epoch"] == n
    final = tuple(run["ranks"][0]["final"])
    assert final[0] == n and final[2] == ROWS + sum(CHUNKS)
    assert final[1] % N_RANKS == 0
    for r in range(N_RANKS):
        assert tuple(run["ranks"][r]["final"]) == final, r
        assert run["ranks"][r]["digest"] == run["ranks"][0]["digest"], r
        assert run["ranks"][r]["compactions"] == \
            run["ranks"][0]["compactions"], r


def test_replay_equals_the_one_process_engine(run):
    """The first rank's log replayed through the port's one-process tiered
    engine over logical ``bind_shards(4)``: ids equal, scores within
    1e-5, batch for batch."""
    for j, (got, b) in enumerate(zip(run["port"],
                                     run["ranks"][0]["front"]["batches"])):
        for (gi, gs), (wi, ws) in zip(got, b["results"]):
            np.testing.assert_array_equal(gi, wi, f"batch {j}")
            np.testing.assert_allclose(gs, ws, **SCORE_TOL,
                                       err_msg=f"batch {j}")


def test_replay_equals_jax(run):
    """The same replay through JAX's ``BoomHQ`` (``bind_tiered``,
    ``bind_shards(4)``, compactions driven with ``tiered.compact()``):
    scores within 1e-4, ids equal except on float ties."""
    from oracle import tie_tolerance

    for got, b in zip(run["jax"], run["ranks"][0]["front"]["batches"]):
        for (gi, gs), (wi, ws) in zip(got, b["results"]):
            np.testing.assert_allclose(ws, gs, atol=1e-4, rtol=1e-5)
            for p in np.flatnonzero(gi != wi):
                assert abs(gs[p] - ws[p]) <= tie_tolerance(float(gs[p]))


def test_no_served_result_misses_a_hot_row(run):
    """Every executed request holds every hot row that the exact filtered
    top-k over its stamp's hot ∪ cold rows ranks (a row tying the served
    k-th aside); the oracle ranks hot rows in many of them."""
    from oracle import tie_tolerance, tiered_brute_force_topk

    from repro_torch.core.boomhq import BoomHQ

    table, (vecs, scal) = run["table"], run["rows"]
    tvecs = [v.numpy() for v in table.vectors]
    tscal = table.scalars.numpy()
    resolve = BoomHQ.resolve_tenant.__get__(run["tbq"])
    hot_ranked = 0
    for q in run["ranks"][0]["front"]["requests"]:
        if q["hit"]:
            continue
        epoch, nc, t = q["stamp"]
        cut = nc - ROWS
        segs = [([np.concatenate([a, b[:cut]]) for a, b in zip(tvecs, vecs)],
                 np.concatenate([tscal, scal[:cut]])),
                ([b[cut: t - ROWS] for b in vecs], scal[cut: t - ROWS])]
        i, tenant = q["asked"]
        mq = resolve(_requests(run["held"], [(i, tenant)])[0])
        o_ids, o_s, _ = tiered_brute_force_topk(
            segs, "dot", mq.query_vectors, mq.weights, mq.predicates, mq.k)
        ids, scores = q["result"]
        kth = float(scores[-1])
        for h, sc in zip(o_ids, o_s):
            if h < nc:
                continue
            hot_ranked += 1
            assert h in ids or abs(float(sc) - kth) <= tie_tolerance(kth), \
                (q["seq"], int(h))
    assert hot_ranked > 0


def test_no_cache_hit_crosses_an_epoch(run):
    """Every cache hit replays an entry stored under the same (epoch,
    rows) token as its lookup's; repeats hit unless a compaction published
    between the two waves (never in the last step)."""
    hits = run["ranks"][0]["front"]["hits"]
    assert len(hits) >= len(REPEATS)
    for lookup, stored in hits:
        assert stored is not None and tuple(stored) == tuple(lookup)


def test_followers_never_plan(run):
    """Only the first rank plans: no follower called ``optimize_batch``,
    the first rank did for every batch."""
    assert run["ranks"][0]["optimize_calls"] >= \
        len(run["ranks"][0]["front"]["batches"])
    for r in range(1, N_RANKS):
        assert run["ranks"][r]["optimize_calls"] == 0, r


def test_spmd_path_checks_every_rank_snapshot(run):
    """Without an engine every rank inserts and executes alike and serves
    the same results; with one more row on rank 3 every rank raises the
    same shared error for the batch, naming the ranks' stamps."""
    spmd = [run["ranks"][r]["spmd"] for r in range(N_RANKS)]
    for r in range(1, N_RANKS):
        for (gi, gs), (wi, ws) in zip(spmd[r]["alike"], spmd[0]["alike"]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gs, ws)
    raised = [s["raised"] for s in spmd]
    assert raised[0] is not None and "differ" in raised[0][0]
    assert all(x == raised[0] for x in raised) and raised[0][1]


@pytest.mark.parametrize("case", ["hot_capacity", "follower_insert",
                                  "indivisible_compaction"])
def test_mesh_refusals(run, case):
    """On a four-rank fake mesh: a ``hot_capacity`` the shards do not
    divide (``bind_tiered`` and ``bind_shards`` over a tiered instance),
    ``insert`` on a rank other than the first, and a compaction on the
    first rank that would leave cold rows the shards do not divide (the
    rows stay hot)."""
    from test_torch_mesh import fake_mesh

    from repro_torch import convert

    bq = convert.boomhq(run["table"], run["cfg"], run["state"])
    vecs, scal = _fresh_rows(3, 7)
    with fake_mesh(N_RANKS, rank=2 if case == "follower_insert" else 0) \
            as mesh:
        if case == "hot_capacity":
            bq.bind_shards(mesh=mesh)
            with pytest.raises(ValueError, match="not divisible"):
                bq.bind_tiered(HOT_CAPACITY - 2)
            assert bq.tiered is None
            bq.bind_shards().bind_tiered(HOT_CAPACITY - 2)
            with pytest.raises(ValueError, match="not divisible"):
                bq.bind_shards(mesh=mesh)
            assert bq.shard_mesh is None
            return
        bq.bind_shards(mesh=mesh).bind_tiered(HOT_CAPACITY)
        if case == "follower_insert":
            with pytest.raises(ValueError, match="first rank"):
                bq.insert(vecs, scal)
            assert bq.tiered.snapshot().n_hot == 0
            return
        bq.insert(vecs, scal)
        with pytest.raises(ValueError, match="do not divide"):
            bq.tiered.compact()
        snap = bq.tiered.snapshot()
        assert (snap.epoch, snap.n_hot, bq.tiered.n_compactions) == (0, 3, 0)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2])
