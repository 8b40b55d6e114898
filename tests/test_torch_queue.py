"""Deadline-aware batch formation and the async serving engine against the
JAX package.

* One scripted arrival and clock script (seeded) drives both packages'
  ``BatchFormer``s under a fake clock: every poll's cut (sequence numbers
  in FIFO order) and expiries, every ``next_event``, each request's final
  status and ``done`` instant, and the snapshot stamped at each cut must
  be identical. The single-rule claims of ``tests/test_queue.py``
  (cut-on-full, cut-on-age, expiry before formation, the strict
  ``now > deadline`` rule, flush) are cases of the script.
* The port's ``AsyncServingEngine`` against a fake ``execute_batch``:
  a failing batch fails only its requests, ``stop(flush=False)`` strands
  no caller, a deadline passing between cut and dispatch times the request
  out (and exactly-at-deadline still serves), a zero budget never
  executes, and a stream keeps submission order with its report.
* The engine over a ``bind_shards(3)`` port ``BoomHQ`` with the exact
  sharded scan pinned serves the ground truth's scores.
"""
import asyncio
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

from repro.serve import queue as jqueue  # noqa: E402

from repro_torch.serve import queue as tqueue  # noqa: E402
from repro_torch.serve.queue import (  # noqa: E402
    FAILED, OK, TIMED_OUT, AsyncServingEngine, BatchFormer, serve_stream,
)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += dt
        return self.now


# ---------------------------------------------------------------------------
# BatchFormer: both packages on one script
# ---------------------------------------------------------------------------

# hand-written scripts: (batch_size, max_wait, ops); an op is
# ("submit", name, timeout) | ("advance", dt) | ("poll", flush) | ("next",)
SCRIPTS = {
    "cut_on_full_fifo": (4, 1.0, [("submit", f"q{i}", None) for i in range(5)]
                         + [("poll", False), ("poll", False), ("next",)]),
    "cut_on_age": (8, 0.5, [("submit", "a", None), ("advance", 0.2),
                            ("submit", "b", None), ("poll", False),
                            ("advance", 0.31), ("poll", False)]),
    "expired_never_executed": (2, 10.0, [
        ("submit", "doomed", 0.5), ("advance", 1.0), ("submit", "ok", None),
        ("poll", False), ("advance", 10.0), ("poll", False)]),
    "expiry_wins_over_formation": (2, 10.0, [
        ("submit", "a", 0.1), ("submit", "b", None), ("submit", "c", None),
        ("advance", 0.2), ("poll", False)]),
    "deadline_exactly_at_poll": (8, 0.5, [
        ("submit", "edge", 0.5), ("advance", 0.5), ("poll", False)]),
    "next_event_age_and_deadline": (8, 1.0, [
        ("next",), ("submit", "a", None), ("next",), ("submit", "b", 0.25),
        ("next",), ("advance", 2.0), ("poll", False), ("next",)]),
    "flush": (8, 100.0, [("submit", "a", None), ("submit", "b", None),
                         ("poll", False), ("poll", True)]),
}


def _random_script(seed: int):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(300):
        r = rng.random()
        if r < 0.45:
            tmo = None if rng.random() < 0.5 else float(
                rng.choice([0.0, 0.01, 0.05, 0.125, 0.5]))
            ops.append(("submit", f"r{i}", tmo))
        elif r < 0.7:
            ops.append(("advance", float(rng.choice([0.0, 0.01, 0.03,
                                                     0.0625, 0.2]))))
        elif r < 0.92:
            ops.append(("poll", bool(rng.random() < 0.1)))
        else:
            ops.append(("next",))
    return (int(rng.integers(1, 9)), float(rng.choice([0.0, 0.02, 0.05])),
            ops + [("poll", True)] * 40)


for _seed in range(4):
    SCRIPTS[f"random_{_seed}"] = _random_script(_seed)


def _run_script(mod, batch_size, max_wait, ops) -> tuple:
    """-> (event log, final (seq, status, done, snapshot) per request)."""
    clock = FakeClock()
    cuts = []
    former = mod.BatchFormer(batch_size=batch_size, max_wait=max_wait,
                             clock=clock,
                             snapshot_fn=lambda: cuts.append(clock.now)
                             or len(cuts))
    log, reqs = [], []
    for op in ops:
        if op[0] == "submit":
            reqs.append(former.submit(op[1], timeout=op[2]))
        elif op[0] == "advance":
            clock.advance(op[1])
        elif op[0] == "poll":
            batch, expired = former.poll(flush=op[1])
            log.append(("poll", clock.now,
                        None if batch is None else
                        [(r.seq, r.query, r.snapshot) for r in batch],
                        [r.seq for r in expired], len(former)))
        else:
            log.append(("next", clock.now, former.next_event()))
    final = [(r.seq, r.query, r.status, r.done, r.deadline, r.snapshot)
             for r in reqs]
    return log, final, cuts


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_batch_former_events_equal_jax(name):
    batch_size, max_wait, ops = SCRIPTS[name]
    want = _run_script(jqueue, batch_size, max_wait, ops)
    got = _run_script(tqueue, batch_size, max_wait, ops)
    assert got == want
    log, final, cuts = got
    polls = [e for e in log if e[0] == "poll"]
    # every cut is FIFO, at most batch_size, stamped with its own snapshot
    for _, _, batch, expired, _ in polls:
        if batch:
            seqs = [s for s, _, _ in batch]
            assert seqs == sorted(seqs) and len(seqs) <= batch_size
            assert len({snap for _, _, snap in batch}) == 1
    assert len(cuts) == sum(e[2] is not None for e in polls)
    # an expired request never enters a batch
    cut = {s for e in polls if e[2] for s, _, _ in e[2]}
    for seq, _, status, done, deadline, _ in final:
        if status == TIMED_OUT:
            assert seq not in cut and done > deadline
    if name == "cut_on_full_fifo":
        assert [s for s, _, _ in polls[0][2]] == [0, 1, 2, 3]
        assert polls[1][2] is None and final[4][2] == "pending"
    if name == "deadline_exactly_at_poll":
        assert polls[0][3] == [] and polls[0][2] is not None
    if name == "next_event_age_and_deadline":
        assert [e[2] for e in log if e[0] == "next"] == [None, 1.0, 0.25,
                                                         None]


# ---------------------------------------------------------------------------
# AsyncServingEngine against fake executors
# ---------------------------------------------------------------------------

def _fake_result(n: int = 1) -> list:
    return [(np.asarray([0]), np.asarray([0.0]))] * n


def test_async_engine_survives_execution_failure():
    state = {"calls": 0}

    class Flaky:
        def execute_batch(self, qs):
            state["calls"] += 1
            if state["calls"] == 1:
                raise RuntimeError("boom")
            return _fake_result(len(qs))

    async def main():
        eng = AsyncServingEngine(Flaky(), batch_size=1, max_wait=0.0)
        async with eng:
            with pytest.raises(RuntimeError, match="boom"):
                await eng.submit("q0")
            ok = await eng.submit("q1")
        return eng, ok

    eng, ok = asyncio.run(main())
    assert ok.status == OK and ok.result is not None
    served = sorted(eng._served, key=lambda r: r.seq)
    assert [r.status for r in served] == [FAILED, OK]
    assert eng.report().n_timed_out == 0


def test_async_engine_stop_noflush_fails_inflight():
    class Slow:
        def execute_batch(self, qs):
            time.sleep(0.4)
            return _fake_result(len(qs))

    async def main():
        eng = AsyncServingEngine(Slow(), batch_size=1, max_wait=0.0)
        await eng.start()
        task = asyncio.ensure_future(eng.submit("q"))
        await asyncio.sleep(0.1)  # formed and executing in the worker
        eng.former.batch_size = 99  # the next request never forms a batch
        queued = asyncio.ensure_future(eng.submit("q2"))
        await asyncio.sleep(0)
        await eng.stop(flush=False)
        for t in (task, queued):
            with pytest.raises(asyncio.CancelledError):
                await asyncio.wait_for(t, timeout=2.0)
        return eng

    eng = asyncio.run(main())
    assert sorted(r.status for r in eng._served) == [FAILED, FAILED]


class Recorder:
    def __init__(self):
        self.executed = []

    def execute_batch(self, qs):
        self.executed.extend(qs)
        return _fake_result(len(qs))


@pytest.mark.parametrize("case", ["between_cut_and_dispatch",
                                  "exactly_at_deadline", "all_expired"])
def test_deadline_rechecked_at_dispatch(case):
    clock = FakeClock()
    rec = Recorder()

    async def main():
        eng = AsyncServingEngine(rec, batch_size=2, max_wait=0.0,
                                 clock=clock)
        await eng.start()
        if case == "between_cut_and_dispatch":
            reqs = [eng.former.submit("doomed", timeout=0.5),
                    eng.former.submit("survivor", timeout=5.0)]
            batch, expired = eng.former.poll()
            assert expired == [] and len(batch) == 2
            clock.advance(1.0)  # the deadline passes after the cut
        elif case == "exactly_at_deadline":
            reqs = [eng.former.submit("edge", timeout=1.0)]
            batch, _ = eng.former.poll(flush=True)
            clock.advance(1.0)
        else:
            reqs = [eng.former.submit("dead", timeout=0.1)]
            batch, _ = eng.former.poll(flush=True)
            clock.advance(1.0)
        await eng._execute(batch)
        await eng.stop(flush=False)
        return eng, reqs

    eng, reqs = asyncio.run(main())
    rep = eng.report()
    if case == "between_cut_and_dispatch":
        doomed, survivor = reqs
        assert doomed.status == TIMED_OUT and doomed.result is None
        assert doomed.done == 1.0
        assert survivor.status == OK and rec.executed == ["survivor"]
        assert rep.n_timed_out == 1
    elif case == "exactly_at_deadline":
        assert reqs[0].status == OK and rec.executed == ["edge"]
    else:
        assert reqs[0].status == TIMED_OUT and rec.executed == []


def test_async_engine_timeout_disposition():
    rec = Recorder()

    async def main():
        eng = AsyncServingEngine(rec, batch_size=64, max_wait=0.2)
        async with eng:
            r = await eng.submit("never-executed-query", timeout=0.0)
        return eng, r

    eng, r = asyncio.run(main())
    assert r.status == TIMED_OUT and r.result is None and rec.executed == []
    rep = eng.report()
    assert rep.n_timed_out == 1 and rep.p50_ms is None


def test_serve_stream_keeps_order_and_reports():
    rec = Recorder()
    queries = [f"q{i}" for i in range(9)]

    async def main():
        eng = AsyncServingEngine(rec, batch_size=3, max_wait=0.01)
        return eng, await serve_stream(eng, queries,
                                       arrival_gaps=[0.001] * 8)

    eng, reqs = asyncio.run(main())
    assert [r.query for r in reqs] == queries
    assert all(r.status == OK for r in reqs)
    assert sorted(rec.executed) == sorted(queries)
    rep = eng.report(gt_ids={r.seq: np.asarray([0]) for r in reqs})
    assert rep.n_queries == 9 and rep.n_timed_out == 0 and rep.qps > 0
    assert rep.p99_ms >= rep.p50_ms and rep.mean_recall == 1.0
    assert rep.tenants[None]["n_ok"] == 9
    assert "p50" in rep.describe()


def test_async_engine_serves_a_sharded_stream():
    """The sharded case of ``tests/test_queue.py``: the engine over an
    unfitted port ``BoomHQ`` (900-row ``part``) bound to 3 logical shards
    with the exact sharded scan pinned (``CostModel(force=DENSE)``) —
    every request served in order with the ground truth's scores
    (``atol=1e-4``)."""
    from repro_torch.bench import datasets, queries
    from repro_torch.core.boomhq import BoomHQ, BoomHQConfig
    from repro_torch.core.rewriter import RewriterConfig
    from repro_torch.serve.batch import DENSE, CostModel
    from repro_torch.vectordb import flat

    table = datasets.make("part", rows=900, seed=4, device="cpu")
    bq = BoomHQ(table, BoomHQConfig(
        n_clusters=8, use_de=False, graph_degree=0,
        rewriter=RewriterConfig(steps=10, refine_columns=False)))
    bq.bind_shards(3).bind_cost_model(CostModel(force=DENSE))
    wl = queries.gen_workload(table, 8, n_vec_used=2, seed=11)

    async def main():
        eng = AsyncServingEngine(bq, batch_size=3, max_wait=0.01)
        return eng, await serve_stream(eng, wl)

    eng, reqs = asyncio.run(main())
    assert [r.query for r in reqs] == wl
    assert all(r.status == OK for r in reqs)
    assert bq._batched_executor().n_shards == 3
    for r in reqs:
        q = r.query
        _, gt_s = flat.ground_truth(table, list(q.query_vectors),
                                    list(q.weights), q.predicates, q.k)
        np.testing.assert_allclose(np.asarray(r.result[1]), gt_s.numpy(),
                                   atol=1e-4, rtol=1e-5)
    rep = eng.report()
    assert rep.n_queries == len(wl) and rep.n_timed_out == 0
    assert rep.qps > 0 and rep.p99_ms >= rep.p50_ms
