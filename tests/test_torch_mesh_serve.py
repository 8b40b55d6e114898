"""The serving front end over a mesh of four ``gloo`` ranks: the first rank
runs ``AsyncServingEngine`` with a ``SemanticCache``, the others
``serve_follower``.

The instance is ``tests/test_semcache.py``'s tenant instance (900 rows of
``part`` with a categorical ``tenant`` column of 3 values, ``n_clusters=8``,
``steps=10``), fitted once in JAX and carried into the port with
``convert.boomhq``. The module fixture starts four rank processes of this
file over a ``file://`` store; each builds the port instance, binds the
tenants and ``bind_shards(mesh=...)`` on a ``(data,)`` mesh of four ranks
under the default cost model, and runs these sessions in order:

* **stream:** two ``serve_stream`` calls on one engine (batch 4, all
  requests at once, so every batch is fixed: full ones cut as they
  queue, the rest by age once ``max_wait`` has passed), held queries with
  tenants and repeats; the second stream's repeats hit the cache the
  first filled;
* **failure:** a planning fault planted in ``optimize_batch`` on the first
  rank only: the batch fails on every rank, ``submit`` re-raises it, and
  the next batch is served everywhere;
* **deadline:** under a scripted clock a request's deadline passes between
  its batch's cut and its dispatch: the followers run the batch without it;
* **stop:** ``stop(flush=False)`` while a batch is in flight;
* **idle:** in a second world whose process-group timeout is a few
  seconds, a pause in traffic longer than it, then one more batch.

A second set of four rank processes (``faulted``) plants a fault in rank
2's ``execute_batch_sharded``, after the plan broadcast, in a world whose
process-group timeout is 60 s: the first rank's ``submit`` must raise
within 10 s naming rank 2, every later request must fail alike, and every
rank process must end long before the timeout (the followers with
``distributed.FAILED_EXIT``).

Meanwhile the test process serves the same streams through the port's
one-process engine and JAX's engine, both over logical ``bind_shards(4)``
on the same state. Every follower must equal the first rank batch for
batch, exactly; the first rank must equal the one-process engine (ids
equal, scores within 1e-5, the same cache hits) and JAX's engine (scores
within 1e-4, ids equal except on float ties, the same cache hits); every
rank process must exit 0.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_mesh_serve.py``.
"""
import asyncio
import contextlib
import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

N_RANKS = 4
TENANTS = 3
ROWS = 900
BATCH = 4
MAX_WAIT = 1.0  # the streams' remainders cut by age, once all are queued
WORLD_TIMEOUT_S = 120
IDLE_TIMEOUT_S = 5  # the idle case's process-group timeout
IDLE_GAP_S = 7.0  # longer than it
TIMEOUT_S = 300  # a rank process's whole run
PLANTED = "planted planning fault"
PLANTED_ALONE = "planted fault on one follower"
FAULTY = 2  # the follower that fails alone
FAULT_TIMEOUT_S = 60  # the faulted world's process-group timeout
FAULT_NOTICE_S = 10  # the first rank's submit raises within this
SCORE_TOL = dict(atol=1e-5, rtol=0)
# (held query, tenant) of each request. The first stream's last two repeat
# two of its own (both miss: all are submitted before any batch runs); the
# second interleaves five repeats of the first (hits) with five new pairs
STREAMS = (
    [(i, i % TENANTS) for i in range(6)]
    + [(0, 1), (1, 2), (2, 0), (3, None), (0, 0), (4, 1)],
    [(0, 0), (5, 0), (1, 1), (1, None), (0, 1), (4, None), (3, None),
     (3, 1), (5, 2), (2, 1)],
)


# ---------------------------------------------------------------------------
# the rank program: one gloo rank, the first the front end
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _world(store: str, rank: int, timeout_s: float):
    """A four-rank ``gloo`` world over ``store`` and its ``(data,)`` mesh,
    destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield init_device_mesh("cpu", (N_RANKS,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def _host(res) -> tuple:
    return tuple(np.asarray(x) for x in res)


def _front(eng, reqs: list) -> dict:
    """The first rank's record of a session: each request by seq, and each
    executed batch's seqs."""
    return dict(
        requests={r.seq: dict(status=r.status, hit=r.cache_hit,
                              result=None if r.result is None
                              else _host(r.result)) for r in reqs},
        batch_seqs=[list(b) for b in eng.batch_seqs])


def _followed(served) -> dict:
    return dict(results=[None if res is None else [_host(x) for x in res]
                         for res in served.results],
                errors={b: (type(e).__name__, str(e))
                        for b, e in served.errors.items()})


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def _stream_case(bq, first: bool, streams: list):
    from repro_torch.serve.queue import (
        AsyncServingEngine, serve_follower, serve_stream,
    )
    from repro_torch.serve.semcache import SemanticCache
    from repro_torch.vectordb import distributed as tdist

    gathers = []
    gather = tdist.gather_shards
    tdist.gather_shards = lambda *a, **kw: gathers.append(1) or gather(
        *a, **kw)
    try:
        if not first:
            return dict(sessions=[_followed(serve_follower(bq))
                                  for _ in streams], gathers=len(gathers))
        eng = AsyncServingEngine(bq, batch_size=BATCH, max_wait=MAX_WAIT,
                                 semcache=SemanticCache(eps=0.0))
        reqs = [r for s in streams for r in asyncio.run(serve_stream(eng, s))]
    finally:
        tdist.gather_shards = gather
    return dict(_front(eng, reqs), n_batches=eng.report().n_batches,
                gathers=len(gathers))


def _failure_case(bq, first: bool, qs: list):
    from repro_torch.serve.queue import AsyncServingEngine, serve_follower

    if not first:
        return _followed(serve_follower(bq))
    plan = bq.optimize_batch
    calls = []

    def planted(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError(PLANTED)
        return plan(*args, **kw)

    bq.optimize_batch = planted
    eng = AsyncServingEngine(bq, batch_size=1, max_wait=0.0)

    async def main():
        async with eng:
            try:
                await eng.submit(qs[0])
                raised = None
            except RuntimeError as exc:
                raised = str(exc)
            return raised, [await eng.submit(qs[1])]

    try:
        raised, _ = asyncio.run(main())
    finally:
        del bq.optimize_batch
    return dict(_front(eng, sorted(eng._served, key=lambda r: r.seq)),
                raised=raised)


def _deadline_case(bq, first: bool, qs: list):
    from repro_torch.serve.queue import AsyncServingEngine, serve_follower

    if not first:
        return _followed(serve_follower(bq))
    clock = FakeClock()
    eng = AsyncServingEngine(bq, batch_size=2, max_wait=0.0, clock=clock)

    async def main():
        await eng.start()
        reqs = [eng.former.submit(qs[0], timeout=0.5),
                eng.former.submit(qs[1], timeout=5.0)]
        batch, expired = eng.former.poll()
        assert expired == [] and len(batch) == 2
        clock.now += 1.0  # the first deadline passes after the cut
        await eng._execute(batch)
        await eng.stop(flush=False)
        return reqs

    return _front(eng, asyncio.run(main()))


def _stop_case(bq, first: bool, qs: list):
    from repro_torch.serve.queue import AsyncServingEngine, serve_follower

    if not first:
        return _followed(serve_follower(bq))
    started = threading.Event()
    ran = []
    execute = bq.execute_batch

    def slow(queries, **kw):
        started.set()
        time.sleep(0.5)  # stop() comes while this batch is in flight
        ran.append([_host(x) for x in execute(queries, **kw)])
        return ran[-1]

    bq.execute_batch = slow
    eng = AsyncServingEngine(bq, batch_size=1, max_wait=0.0)

    async def main():
        await eng.start()
        task = asyncio.ensure_future(eng.submit(qs[0]))
        while not started.is_set():
            await asyncio.sleep(0.01)
        await eng.stop(flush=False)
        done_at_stop = len(ran)
        try:
            await task
            cancelled = False
        except asyncio.CancelledError:
            cancelled = True
        return done_at_stop, cancelled

    try:
        done_at_stop, cancelled = asyncio.run(main())
    finally:
        del bq.execute_batch
    return dict(ran=ran, done_at_stop=done_at_stop, cancelled=cancelled)


def _idle_case(bq, first: bool, qs: list):
    from repro_torch.serve.queue import AsyncServingEngine, serve_follower

    if not first:
        return _followed(serve_follower(bq))
    eng = AsyncServingEngine(bq, batch_size=1, max_wait=0.0)

    async def main():
        async with eng:
            a = await eng.submit(qs[0])
            await asyncio.sleep(IDLE_GAP_S)
            return [a, await eng.submit(qs[1])]

    return _front(eng, asyncio.run(main()))


def _rank(r: int, d: str) -> None:
    from repro_torch import convert

    torch.set_num_threads(1)
    with open(f"{d}/inputs.pkl", "rb") as f:
        x = pickle.load(f)
    bq = convert.boomhq(x["table"], x["cfg"], x["state"]).bind_tenants(
        "tenant")
    first = r == 0
    held = x["held"]
    out = {}
    with _world(f"{d}/store", r, WORLD_TIMEOUT_S) as mesh:
        bq.bind_shards(mesh=mesh)
        out["stream"] = _stream_case(bq, first, x["streams"])
        out["failure"] = _failure_case(bq, first, held[:2])
        out["deadline"] = _deadline_case(bq, first, held[2:4])
        out["stop"] = _stop_case(bq, first, held[4:])
    with _world(f"{d}/store_idle", r, IDLE_TIMEOUT_S) as mesh:
        bq.bind_shards(mesh=mesh)
        out["idle"] = _idle_case(bq, first, held[:2])
    with open(f"{d}/rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)


def _fault_rank(r: int, d: str) -> None:
    """One rank of the faulted world: rank ``FAULTY`` raises in its
    executor after the plans arrive; the others serve as usual. Only the
    first rank returns (its record in ``fault0.pkl``); the followers'
    processes end in ``serve_follower``."""
    from repro_torch import convert
    from repro_torch.serve import batch as batchmod
    from repro_torch.serve.queue import AsyncServingEngine, serve_follower
    from repro_torch.vectordb.distributed import MeshSessionError

    torch.set_num_threads(1)
    with open(f"{d}/inputs.pkl", "rb") as f:
        x = pickle.load(f)
    bq = convert.boomhq(x["table"], x["cfg"], x["state"]).bind_tenants(
        "tenant")
    held = x["held"]
    with _world(f"{d}/store_fault", r, FAULT_TIMEOUT_S) as mesh:
        bq.bind_shards(mesh=mesh)
        if r == FAULTY:
            def planted(self, *a, **kw):
                raise RuntimeError(PLANTED_ALONE)

            batchmod.BatchedHybridExecutor.execute_batch_sharded = planted
        if r != 0:
            serve_follower(bq)
            raise AssertionError("serve_follower returned after a failure")
        eng = AsyncServingEngine(bq, batch_size=1, max_wait=0.0)

        async def main():
            out = {}
            async with eng:
                for name, q in (("first", held[0]), ("later", held[1])):
                    t = time.monotonic()
                    out[f"{name}_at"] = time.time()
                    try:
                        await eng.submit(q)
                        out[name] = None
                    except MeshSessionError as exc:
                        out[name] = (exc.rank, str(exc))
                    out[f"{name}_s"] = time.monotonic() - t
                t = time.monotonic()
            out["stop_s"] = time.monotonic() - t
            return out

        out = asyncio.run(main())
    with open(f"{d}/fault0.pkl", "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# the module fixture: the ranks, and beside them the two references
# ---------------------------------------------------------------------------

def _jax_instance():
    """``tests/test_semcache.py``'s ``tenant_bq``: (the fitted JAX instance,
    its six held queries)."""
    from repro.bench import datasets as jds
    from repro.bench import queries as jq
    from repro.core.boomhq import BoomHQ, BoomHQConfig
    from repro.core.rewriter import RewriterConfig
    from repro.vectordb.table import ScalarCol, Table

    base = jds.make("part", rows=ROWS, seed=7)
    tcol = np.random.default_rng(7).integers(0, TENANTS, base.n_rows) \
        .astype(np.float32)
    schema = dataclasses.replace(
        base.schema, scalar_cols=tuple(base.schema.scalar_cols)
        + (ScalarCol("tenant", "cat", TENANTS),))
    jt = Table.from_numpy(
        schema, [np.asarray(v) for v in base.vectors],
        np.concatenate([np.asarray(base.scalars), tcol[:, None]], axis=1))
    jbq = BoomHQ(jt, BoomHQConfig(n_clusters=8, use_de=False,
                                  rewriter=RewriterConfig(
                                      steps=10, refine_columns=False)))
    jbq.fit(jq.gen_workload(jt, 12, n_vec_used=2, k=5, seed=0))
    jbq.bind_tenants("tenant")
    return jbq, jq.gen_workload(jt, 6, n_vec_used=2, k=5, seed=1)


def _requests(held: list, stream: list) -> list:
    return [dataclasses.replace(held[i], tenant_id=t) for i, t in stream]


def _serve(eng, streams: list, serve_stream) -> list:
    """Each stream through ``serve_stream`` on one engine. -> per request
    (cache hit, ids, scores), in submission order."""
    out = []
    for s in streams:
        out += [(r.cache_hit, *_host(r.result))
                for r in asyncio.run(serve_stream(eng, s))]
    return out


def _one_process(tbq, streams: list) -> list:
    """The port's one-process engine over logical ``bind_shards(4)``."""
    from repro_torch.serve.queue import AsyncServingEngine, serve_stream
    from repro_torch.serve.semcache import SemanticCache

    tbq.bind_shards(N_RANKS)
    try:
        return _serve(AsyncServingEngine(tbq, batch_size=BATCH, max_wait=MAX_WAIT,
                                         semcache=SemanticCache(eps=0.0)),
                      streams, serve_stream)
    finally:
        tbq.bind_shards()


def _jax_engine(jbq, streams: list) -> list:
    """JAX's engine over logical ``bind_shards(4)``."""
    from repro.serve.queue import AsyncServingEngine, serve_stream
    from repro.serve.semcache import SemanticCache

    jbq.bind_shards(N_RANKS)
    return _serve(AsyncServingEngine(jbq, batch_size=BATCH, max_wait=MAX_WAIT,
                                     semcache=SemanticCache(eps=0.0)),
                  streams, serve_stream)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from test_torch_semcache import _port_mhq, _port_table, _state

    from repro_torch import convert
    from repro_torch.core.boomhq import BoomHQConfig
    from repro_torch.core.rewriter import RewriterConfig

    d = str(tmp_path_factory.mktemp("mesh_serve"))
    jbq, jheld = _jax_instance()
    table = _port_table(jbq.table)
    cfg = BoomHQConfig(n_clusters=8, use_de=False, rewriter=RewriterConfig(
        steps=10, refine_columns=False))
    state = _state(jbq)
    held = [_port_mhq(q) for q in jheld]
    streams = [_requests(held, s) for s in STREAMS]
    with open(f"{d}/inputs.pkl", "wb") as f:
        pickle.dump(dict(table=table, cfg=cfg, state=state, held=held,
                         streams=streams), f)
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    me = os.path.abspath(__file__)
    ranks = [subprocess.Popen([sys.executable, me, str(r), d], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(N_RANKS)]
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as the ranks run
        try:
            tbq = convert.boomhq(table, cfg, state).bind_tenants("tenant")
            one = _one_process(tbq, streams)
        finally:
            torch.set_num_threads(threads)
        jax_out = _jax_engine(jbq, [_requests(jheld, s) for s in STREAMS])
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for r, (p, err) in enumerate(zip(ranks, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    out = []
    for r in range(N_RANKS):
        with open(f"{d}/rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return dict(ranks=out, one_process=one, jax=jax_out, dir=d, env=env)


@pytest.fixture(scope="module")
def faulted(served):
    """The faulted world's four rank processes: the first rank's record,
    each process's exit code and the wall-clock instant it was seen to
    end."""
    d, me = served["dir"], os.path.abspath(__file__)
    logs = [open(f"{d}/fault{r}.log", "w") for r in range(N_RANKS)]
    ranks = [subprocess.Popen([sys.executable, me, "fault", str(r), d],
                              env=served["env"], stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(N_RANKS)]
    ended = [None] * N_RANKS
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while None in ended and time.monotonic() < deadline:
            for r, p in enumerate(ranks):
                if ended[r] is None and p.poll() is not None:
                    ended[r] = time.time()
            time.sleep(0.05)
    finally:
        for p in ranks:
            p.kill()
            p.wait()
        for f in logs:
            f.close()
    text = [open(f"{d}/fault{r}.log").read()[-3000:] for r in range(N_RANKS)]
    assert None not in ended, f"rank processes outlived {TIMEOUT_S} s: {text}"
    assert ranks[0].returncode == 0, text[0]
    with open(f"{d}/fault0.pkl", "rb") as f:
        first = pickle.load(f)
    return dict(first=first, codes=[p.returncode for p in ranks],
                ended=ended, logs=text)


# ---------------------------------------------------------------------------
# the claims
# ---------------------------------------------------------------------------

def _batches(front: dict) -> list:
    """The first rank's executed batches: each request's (ids, scores), None
    for a batch whose requests failed."""
    out = []
    for seqs in front["batch_seqs"]:
        reqs = [front["requests"][s] for s in seqs]
        out.append(None if any(r["status"] == "failed" for r in reqs)
                   else [r["result"] for r in reqs])
    return out


def _assert_same_batches(followed: list, front: dict, label: str) -> None:
    """Every follower's sessions equal the first rank's batches, in order,
    exactly."""
    want = _batches(front)
    got = [b for s in followed for b in s["results"]]
    assert len(got) == len(want), label
    for j, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, (label, j)
            continue
        assert g is not None and len(g) == len(w), (label, j)
        for (gi, gs), (wi, ws) in zip(g, w):
            np.testing.assert_array_equal(gi, wi, f"{label} batch {j}")
            np.testing.assert_array_equal(gs, ws, f"{label} batch {j}")


def _front_stream(front: dict) -> list:
    """The first rank's stream requests, (hit, ids, scores) by seq."""
    return [(r["hit"], *r["result"]) for _, r in
            sorted(front["requests"].items())]


def test_followers_equal_the_first_rank_batch_for_batch(served):
    """Every follower ran the first rank's executed batches of both streams,
    in the same order, with results equal bit for bit, through as many of
    the mesh's gathers; the batches are the fixed cuts (the first stream's
    12 misses in three, the second's 5 in two)."""
    front = served["ranks"][0]["stream"]
    assert [len(b) for b in front["batch_seqs"]] == [4, 4, 4, 4, 1]
    assert front["n_batches"] == 5
    for r in range(1, N_RANKS):
        followed = served["ranks"][r]["stream"]
        _assert_same_batches(followed["sessions"], front, f"rank {r}")
        # the batches met in the mesh's collectives, as often on every rank
        assert followed["gathers"] == front["gathers"] > 0


def test_first_rank_equals_the_one_process_engine(served):
    """The first rank's results equal the port's one-process engine over
    logical ``bind_shards(4)`` on the same streams: the same cache hits,
    ids equal, scores within 1e-5."""
    got = _front_stream(served["ranks"][0]["stream"])
    want = served["one_process"]
    assert [g[0] for g in got] == [w[0] for w in want]
    assert sum(g[0] for g in got) == 5  # the second stream's repeats
    for (_, gi, gs), (_, wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, **SCORE_TOL)


def test_first_rank_equals_jax_engine(served):
    """The first rank's results equal JAX's ``AsyncServingEngine`` with a
    ``SemanticCache`` over logical ``bind_shards(4)``: the same cache hits,
    scores within 1e-4, ids equal except on float ties."""
    from oracle import tie_tolerance

    got = _front_stream(served["ranks"][0]["stream"])
    want = served["jax"]
    assert len(got) == len(want)
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, gi, gs), (_, wi, ws) in zip(got, want):
        np.testing.assert_allclose(gs, ws, atol=1e-4, rtol=1e-5)
        for p in np.flatnonzero(gi != wi):
            assert abs(gs[p] - ws[p]) <= tie_tolerance(float(ws[p]))


def test_first_rank_planning_failure_reaches_every_rank(served):
    """A fault planted in the first rank's ``optimize_batch``: the batch
    fails on every rank with the same exception, ``submit`` re-raises it,
    and the next batch is served on every rank alike."""
    front = served["ranks"][0]["failure"]
    assert front["raised"] == PLANTED
    assert [r["status"] for _, r in sorted(front["requests"].items())] == \
        ["failed", "ok"]
    for r in range(1, N_RANKS):
        followed = served["ranks"][r]["failure"]
        assert followed["errors"] == {0: ("RuntimeError", PLANTED)}
        _assert_same_batches([followed], front, f"rank {r}")


def test_late_request_never_reaches_the_followers(served):
    """A request whose deadline passes between its batch's cut and its
    dispatch times out on the first rank; the followers run the batch
    without it."""
    front = served["ranks"][0]["deadline"]
    doomed, survivor = (front["requests"][s] for s in sorted(
        front["requests"]))
    assert doomed["status"] == "timed_out" and survivor["status"] == "ok"
    assert [len(b) for b in front["batch_seqs"]] == [1]
    for r in range(1, N_RANKS):
        followed = served["ranks"][r]["deadline"]
        assert [len(b) for b in followed["results"]] == [1]
        _assert_same_batches([followed], front, f"rank {r}")


def test_stop_without_flush_mid_batch_releases_every_rank(served):
    """``stop(flush=False)`` while a batch is in flight: its request is
    cancelled, ``stop`` returns once the batch has run and the stop message
    has gone out behind it, and every rank ran that batch alike (every rank
    process exited 0)."""
    front = served["ranks"][0]["stop"]
    assert front["cancelled"] and front["done_at_stop"] == 1
    for r in range(1, N_RANKS):
        followed = served["ranks"][r]["stop"]
        assert followed["errors"] == {}
        assert len(followed["results"]) == 1
        for (gi, gs), (wi, ws) in zip(followed["results"][0],
                                      front["ran"][0]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gs, ws)


def test_idle_gap_past_the_group_timeout(served):
    """A pause in traffic longer than the process group's timeout: the
    followers wait in the batch channel (its own timeout) and serve the
    next batch."""
    assert IDLE_GAP_S > IDLE_TIMEOUT_S
    front = served["ranks"][0]["idle"]
    assert [r["status"] for r in front["requests"].values()] == ["ok", "ok"]
    for r in range(1, N_RANKS):
        followed = served["ranks"][r]["idle"]
        assert followed["errors"] == {} and len(followed["results"]) == 2
        _assert_same_batches([followed], front, f"rank {r}")


def test_a_follower_failing_alone_ends_the_session_promptly(faulted):
    """A fault on rank 2 after the plan broadcast, with a 60 s process-group
    timeout: the first rank's ``submit`` raises within 10 s a
    ``MeshSessionError`` naming rank 2 (the planted message with it), the
    next request fails alike at once, ``stop`` returns at once, and every
    follower process ends with ``FAILED_EXIT`` long before the timeout."""
    from repro_torch.vectordb.distributed import FAILED_EXIT

    first = faulted["first"]
    rank, text = first["first"]
    assert rank == FAULTY and f"rank {FAULTY}" in text and \
        PLANTED_ALONE in text
    assert first["first_s"] < FAULT_NOTICE_S
    assert first["later"] is not None and first["later"][0] == FAULTY
    assert first["later_s"] < 1.0 and first["stop_s"] < 5.0
    assert faulted["codes"][1:] == [FAILED_EXIT] * (N_RANKS - 1), \
        faulted["logs"]
    for r in range(1, N_RANKS):
        assert faulted["ended"][r] - first["first_at"] < \
            FAULT_TIMEOUT_S / 3, (r, faulted["logs"][r])


# ---------------------------------------------------------------------------
# the channel's parts, in this process
# ---------------------------------------------------------------------------

class TwoArgError(Exception):
    """An exception that pickles but does not unpickle (its ``args`` are
    one message, its constructor takes two)."""

    def __init__(self, a, b):
        super().__init__(f"{a}/{b}")


def test_a_batch_message_rebuilds_the_queries_byte_for_byte():
    """A query through the channel's host form and a pickle round trip comes
    back with the same vectors, predicate fields (conjunctive and DNF) and
    scalars, byte for byte."""
    from repro_torch.core.query import MHQ
    from repro_torch.vectordb.distributed import (
        _query_from_host, _query_to_host,
    )
    from repro_torch.vectordb.predicates import Predicates, PredicateSet

    rng = np.random.default_rng(3)

    def vecs():
        return tuple(torch.as_tensor(rng.normal(size=(d,)).astype(np.float32))
                     for d in (8, 5))

    sent = [MHQ(vecs(), (0.3, 0.7), Predicates.from_conditions(
                3, {0: (0.1, 0.5)}, device="cpu"), k=7, recall_target=0.8,
                tenant_id=2),
            MHQ(vecs(), (1.0, 0.0), PredicateSet.from_clauses(
                3, [{0: (0.2, 0.4)}, {1: (-1.0, 2.0), 2: (0.0, 0.0)}],
                device="cpu"), k=5)]
    for q in sent:
        got = _query_from_host(pickle.loads(pickle.dumps(_query_to_host(q))),
                               "cpu")
        assert type(got.predicates) is type(q.predicates)
        for f in dataclasses.fields(q.predicates):
            a, b = (getattr(x.predicates, f.name) for x in (got, q))
            assert a.dtype == b.dtype and a.numpy().tobytes() == \
                b.numpy().tobytes()
        for a, b in zip(got.query_vectors, q.query_vectors):
            assert a.dtype == b.dtype and a.numpy().tobytes() == \
                b.numpy().tobytes()
        assert (got.weights, got.k, got.recall_target, got.tenant_id) == \
            (q.weights, q.k, q.recall_target, q.tenant_id)


def test_a_planning_failure_travels_as_itself_or_by_name():
    """What the plan broadcast carries for a first-rank failure: the
    exception itself when it survives a pickle round trip, else a
    ``RuntimeError`` naming its type and message; ``serve_follower`` is
    refused without a mesh of more than one rank."""
    from repro_torch.serve.queue import serve_follower
    from repro_torch.vectordb.distributed import portable_error

    exc = ValueError("no plan")
    assert portable_error(exc) is exc
    odd = portable_error(TwoArgError(1, 2))
    assert type(odd) is RuntimeError and str(odd) == "TwoArgError: 1/2"
    with pytest.raises(ValueError, match="first runs"):
        serve_follower(type("Unsharded", (), {"shard_mesh": None})())


if __name__ == "__main__":
    if sys.argv[1] == "fault":
        _fault_rank(int(sys.argv[2]), sys.argv[3])
    else:
        _rank(int(sys.argv[1]), sys.argv[2])
