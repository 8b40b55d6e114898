"""Async deadline-aware MHQ serving: queue → batch formation → execution.

Port of ``repro.serve.queue``. ``ServingEngine`` chops a PRE-COLLECTED
query list into fixed batches; live traffic arrives one request at a time
and each request may carry a latency budget. This module is the front half
of the serving pipeline for that traffic:

  request queue  →  deadline-aware batch formation  →  batched execution

* ``BatchFormer`` is the synchronous policy core (injectable clock, so
  tests drive it under a fake clock): a batch CUTS when ``batch_size``
  requests are pending (cut-on-full) or when the oldest pending request has
  waited ``max_wait`` seconds (cut-on-age). A request whose deadline passes
  while it is queued expires — ``timed_out``, never executed. FIFO order
  holds within every batch.
* ``AsyncServingEngine`` is the asyncio front-end: concurrent ``submit()``
  callers share formed batches; one drainer task cuts batches and runs each
  through ``BoomHQ.execute_batch`` on ONE worker thread, so the event loop
  keeps accepting arrivals while a batch runs on the card. Over a tiered
  table a ``CompactionScheduler`` compacts on a second thread.
* Over a mesh of more than one rank (``BoomHQ.bind_shards(mesh=...)``)
  the mesh's first rank is the front end: it runs the engine (batch cuts,
  deadlines, tenant folding, the semantic cache, the report, and over a
  tiered table the ingest and the compactions that cut epochs) and sends
  every batch it executes to the other ranks, with its snapshot stamp and
  the ingest since the last batch; they run ``serve_follower``: the same
  batches, in the same order, through the same collectives, each on the
  snapshot its stamp names. A rank that fails alone ends the session on
  every rank at once (``distributed.BatchChannel``).

Dispositions and latency percentiles land in ``ServeReport``
(``n_timed_out``, ``p50_ms``/``p99_ms``).
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import functools
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.executor import recall_at_k
from repro_torch.core.query import MHQ
from repro_torch.serve.batch import ServeReport

PENDING = "pending"
OK = "ok"
TIMED_OUT = "timed_out"
FAILED = "failed"  # execution raised; the exception propagates to submit()

_DEFAULT = object()  # sentinel: "use the engine's default timeout"


@dataclasses.dataclass
class ServeRequest:
    """One enqueued query: arrival instant, optional ABSOLUTE deadline, and
    (once resolved) disposition and result."""

    query: MHQ
    seq: int
    arrival: float
    deadline: Optional[float] = None  # clock instant; None = no deadline
    status: str = PENDING  # PENDING | OK | TIMED_OUT | FAILED
    result: Optional[tuple] = None  # (ids, scores) when status == OK
    done: float = 0.0
    cache_hit: bool = False  # resolved by the semantic cache, no execution
    # tiered serving: the immutable snapshot stamped on the whole batch at
    # CUT time, so an epoch swap between formation and execution can never
    # mix states within a batch
    snapshot: Optional[object] = None

    @property
    def latency(self) -> float:
        """Queue wait + execution for OK; time-to-expiry for TIMED_OUT."""
        return self.done - self.arrival


class BatchFormer:
    """Deadline-aware batch formation over a FIFO request queue.

    Synchronous policy core with an injectable ``clock``: the async engine
    drives it with wall time, tests with a fake clock."""

    def __init__(self, *, batch_size: int = 32, max_wait: float = 0.05,
                 clock: Callable[[], float] = time.monotonic,
                 snapshot_fn: Optional[Callable[[], object]] = None):
        if batch_size < 1 or max_wait < 0.0:
            raise ValueError(f"batch_size {batch_size} < 1 or max_wait "
                             f"{max_wait} < 0")
        self.batch_size = batch_size
        self.max_wait = max_wait
        self.clock = clock
        # tiered serving: called ONCE per cut; the snapshot it returns is
        # stamped on every request of the formed batch
        self.snapshot_fn = snapshot_fn
        self._pending: list = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._pending)

    def admit(self, query: MHQ, *, timeout: Optional[float] = None,
              now: Optional[float] = None) -> ServeRequest:
        """Stamp (but do NOT enqueue) the next request — sequence number,
        arrival instant and absolute deadline. A front-end that resolves a
        request without a batch (a semantic-cache hit) uses this, so the
        request still holds its place in the serve order."""
        now = self.clock() if now is None else now
        r = ServeRequest(
            query=query, seq=self._seq, arrival=now,
            deadline=None if timeout is None else now + timeout)
        self._seq += 1
        return r

    def submit(self, query: MHQ, *, timeout: Optional[float] = None,
               now: Optional[float] = None) -> ServeRequest:
        """Enqueue one request; ``timeout`` (seconds from now) sets its
        absolute deadline."""
        r = self.admit(query, timeout=timeout, now=now)
        self._pending.append(r)
        return r

    def expire(self, now: Optional[float] = None) -> list:
        """Remove (and mark ``timed_out``) every pending request whose
        deadline has passed (strictly: ``now > deadline``)."""
        now = self.clock() if now is None else now
        dead = [r for r in self._pending
                if r.deadline is not None and now > r.deadline]
        if dead:
            gone = {r.seq for r in dead}
            self._pending = [r for r in self._pending if r.seq not in gone]
            for r in dead:
                r.status = TIMED_OUT
                r.done = now
        return dead

    def poll(self, now: Optional[float] = None, *, flush: bool = False
             ) -> tuple:
        """-> (batch | None, expired).

        Expiry runs first (expired requests never enter a batch); then a
        batch of the OLDEST ≤ ``batch_size`` requests cuts when the queue
        is full, the oldest request has waited ``max_wait``, or ``flush``
        forces the remainder out."""
        now = self.clock() if now is None else now
        expired = self.expire(now)
        batch = None
        if self._pending and (
                len(self._pending) >= self.batch_size
                or now - self._pending[0].arrival >= self.max_wait
                or flush):
            batch = self._pending[: self.batch_size]
            self._pending = self._pending[self.batch_size:]
            if self.snapshot_fn is not None:
                snap = self.snapshot_fn()  # snapshot-at-cut: one per batch
                for r in batch:
                    r.snapshot = snap
        return batch, expired

    def drain(self) -> list:
        """Remove and return every pending request (engine shutdown)."""
        out, self._pending = self._pending, []
        return out

    def next_event(self, now: Optional[float] = None) -> Optional[float]:
        """Earliest instant a poll could act — the oldest request's
        cut-on-age instant or the soonest deadline — or None when idle."""
        if not self._pending:
            return None
        t = self._pending[0].arrival + self.max_wait
        for r in self._pending:
            if r.deadline is not None:
                t = min(t, r.deadline)
        return t


class CompactionScheduler:
    """Background hot→cold compaction on its OWN single worker thread, so no
    batch waits in line behind a compaction (the two still share the
    interpreter lock and the card). At most one runs at a time;
    ``maybe_schedule()`` is cheap and safe from any thread (ingest calls it
    on every insert that fills the hot segment, the drainer between
    batches)."""

    def __init__(self, tiered):
        self.tiered = tiered
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._inflight: Optional[concurrent.futures.Future] = None
        self.n_scheduled = 0

    def start(self) -> None:
        """Submit one compaction whatever the table's own policy says (a
        follower compacts when the first rank's log says); compactions run
        one after another on the worker."""
        self._inflight = self._pool.submit(self.tiered.compact)
        self.n_scheduled += 1

    def maybe_schedule(self) -> bool:
        """Submit one compaction if the hot segment needs it and none is in
        flight. -> whether one was submitted."""
        if self._inflight is not None and not self._inflight.done():
            return False
        if not self.tiered.needs_compaction():
            return False
        self._inflight = self._pool.submit(self.tiered.compact)
        self.n_scheduled += 1
        return True

    def drain(self) -> None:
        """Wait out the in-flight compaction and stop the worker."""
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None
        self._pool.shutdown(wait=True)


class AsyncServingEngine:
    """Asyncio deployment front-end over a fitted ``BoomHQ``.

    ``submit()`` coroutines from any number of callers enqueue into one
    ``BatchFormer``; a single drainer task cuts batches and executes each
    through ``BoomHQ.execute_batch`` on one worker thread, so arrivals keep
    landing while a batch runs. Expired requests resolve ``timed_out`` and
    are never executed. With a ``semcache`` (``serve.semcache``), a fresh
    repeat resolves at submit and a miss populates after its batch, stamped
    with the batch snapshot's token.

    Over a mesh of more than one rank the engine runs on the mesh's first
    rank only (``ValueError`` elsewhere) and every other rank runs
    ``serve_follower`` for each start/stop session. ``start`` makes the
    session's ``distributed.BatchChannel`` (with the followers); the one
    worker thread sends each batch on it just before executing it, after
    late requests are removed, so the followers run exactly what this rank
    runs, in its order. ``stop`` sends the stop message behind the
    in-flight batch on that thread and waits for it without blocking the
    event loop, on every way out (flushed, ``flush=False`` mid-batch, or
    an exception in an ``async with`` body). The channel has its own
    timeout, so an idle pause longer than the process group's does not
    fail the followers. Over a tiered table the batch goes out with its
    cut-time snapshot's stamp and the ingest since the last message
    (``tiered.TieredTable.delta``); this rank's ``CompactionScheduler``
    cuts the epochs, and ``stop`` waits out its compaction before the
    stop message, which carries the final stamp. A batch that fails on
    every rank alike (a planning failure) fails its requests only; any
    other failure of a batch means some rank failed alone, so that batch
    and every later request fail with a ``distributed.MeshSessionError``
    naming the rank, and ``stop`` sends nothing more. ``batch_seqs``
    lists each executed batch's request sequence numbers, in execution
    order."""

    def __init__(self, boomhq, *, batch_size: int = 32,
                 max_wait: float = 0.05,
                 default_timeout: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 semcache=None):
        mesh = getattr(boomhq, "shard_mesh", None)
        self._mesh = mesh if mesh is not None and mesh.size() > 1 else None
        if self._mesh is not None:
            from repro_torch.vectordb.distributed import is_first_rank
            if not is_first_rank(self._mesh):
                raise ValueError(
                    "AsyncServingEngine serves on the mesh's first rank "
                    "(coordinate 0 on every dimension); every other rank "
                    "runs serve_follower(bq)")
        self._channel = None
        self._failure: Optional[BaseException] = None  # a session's end
        self.batch_seqs: list = []
        self.bq = boomhq
        self.former = BatchFormer(batch_size=batch_size, max_wait=max_wait,
                                  clock=clock)
        self.semcache = semcache
        self.default_timeout = default_timeout
        self.clock = clock
        self._futures: dict = {}
        self._event: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._served: list = []
        self._n_batches = 0
        self._t0: Optional[float] = None
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._compactor: Optional[CompactionScheduler] = None

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "AsyncServingEngine":
        if self._task is None:
            self._event = asyncio.Event()
            # ONE worker thread: batches execute strictly in formation
            # order, and a late stop() flush can never race the drainer
            # into two concurrent execute_batch calls
            if self._mesh is not None:
                from repro_torch.vectordb.distributed import BatchChannel

                self._channel = BatchChannel(self._mesh)  # with the followers
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, initializer=_bind_device,
                    initargs=(self.bq.table.device,))
            else:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1)
            if getattr(self.bq, "tiered", None) is not None:
                # snapshot-at-cut, and compaction on its own worker
                self.former.snapshot_fn = self.bq.tiered.snapshot
                self._compactor = CompactionScheduler(self.bq.tiered)
                self.bq._compactor = self._compactor
            self._task = asyncio.get_running_loop().create_task(self._drain())
        return self

    async def stop(self, *, flush: bool = True) -> None:
        """Serve (or expire) everything still queued, then stop the drainer
        and tear down the worker threads."""
        if self._task is None:
            return
        while flush and (len(self.former) or not self._all_resolved()):
            self._event.set()
            await asyncio.sleep(1e-3)
            batch, expired = self.former.poll(flush=True)
            self._resolve_expired(expired)
            if batch:
                await self._execute(batch)
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        self._task = None
        # flush=False: fail everything never formed into a batch (and any
        # straggler future) so no submit() caller is left hanging; the
        # in-flight batch's futures were failed by _execute's cancellation
        # branch
        for r in self.former.drain():
            r.status = FAILED
            r.done = self.clock()
            self._finish(r, exc=asyncio.CancelledError("engine stopped"))
        for seq in list(self._futures):
            fut = self._futures.pop(seq)
            if not fut.done():
                fut.set_exception(asyncio.CancelledError("engine stopped"))
        if self._channel is not None:
            if self._compactor is not None:
                # the last epoch cut lands before the stop that stamps it
                if self.bq._compactor is self._compactor:
                    self.bq._compactor = None
                await asyncio.get_running_loop().run_in_executor(
                    None, self._compactor.drain)
                self._compactor = None
            # the followers' stop goes out on the worker, behind the
            # in-flight batch and its collectives; awaited, not joined
            stop_fut = None if self._failure is not None else \
                self._pool.submit(_send_stop, self._channel, self.bq)
            self._pool.shutdown(wait=False)
            self._pool, self._channel = None, None
            if stop_fut is not None:
                await asyncio.wrap_future(stop_fut)
        else:
            # wait=False: do not block the event loop on a discarded batch
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        if self._compactor is not None:
            # let the in-flight compaction land (it owns published state)
            await asyncio.get_running_loop().run_in_executor(
                None, self._compactor.drain)
            if getattr(self.bq, "_compactor", None) is self._compactor:
                self.bq._compactor = None
            self._compactor = None

    async def __aenter__(self) -> "AsyncServingEngine":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def _all_resolved(self) -> bool:
        return not self._futures

    # -- request path ------------------------------------------------------

    def _cache_token(self) -> tuple:
        """The CURRENT freshness token: ``(epoch, n_rows)`` of the tiered
        snapshot (an epoch bump or any hot insert changes it), or
        ``(0, table.n_rows)`` untiered. One snapshot pointer read."""
        tiered = getattr(self.bq, "tiered", None)
        if tiered is not None:
            snap = tiered.snapshot()
            return (snap.epoch, snap.n_rows)
        return (0, self.bq.table.n_rows)

    async def submit(self, query: MHQ, *, timeout=_DEFAULT) -> ServeRequest:
        """Enqueue one query and await its disposition: the resolved
        ``ServeRequest`` (``status`` ``"ok"`` with ``result`` set, or
        ``"timed_out"`` with ``result`` None; a failed batch re-raises
        here). With a semantic cache, a fresh repeat resolves here —
        never queued, never executed, ``cache_hit`` set."""
        await self.start()
        if self._failure is not None:
            raise self._failure
        tmo = self.default_timeout if timeout is _DEFAULT else timeout
        # fold the tenant namespace BEFORE the cache key is computed, so
        # the implicit conjunct is part of the predicate signature
        if getattr(query, "tenant_id", None) is not None and \
                hasattr(self.bq, "resolve_tenant"):
            query = self.bq.resolve_tenant(query)
        if self.semcache is not None:
            cached = self.semcache.lookup(query, self._cache_token())
            if cached is not None:
                r = self.former.admit(query, timeout=tmo)
                if self._t0 is None:
                    self._t0 = r.arrival
                r.status = OK
                r.result = cached
                r.cache_hit = True
                r.done = self.clock()
                self._served.append(r)
                return r
        r = self.former.submit(query, timeout=tmo)
        if self._t0 is None:
            self._t0 = r.arrival
        fut = asyncio.get_running_loop().create_future()
        self._futures[r.seq] = fut
        self._event.set()
        await fut
        return r

    async def _drain(self) -> None:
        while True:
            if self._compactor is not None:
                self._compactor.maybe_schedule()
            batch, expired = self.former.poll()
            self._resolve_expired(expired)
            if batch:
                await self._execute(batch)
                continue  # the queue may already hold the next full batch
            nxt = self.former.next_event()
            try:
                wait = None if nxt is None \
                    else max(1e-4, nxt - self.clock())
                await asyncio.wait_for(self._event.wait(), wait)
            except asyncio.TimeoutError:
                pass
            self._event.clear()

    async def _execute(self, batch: list) -> None:
        # deadline enforcement does not stop at cut time: a request whose
        # deadline passed while its batch waited behind an in-flight one
        # resolves timed_out here (the same strict `now > deadline` rule
        # as BatchFormer.expire)
        now = self.clock()
        late = [r for r in batch
                if r.deadline is not None and now > r.deadline]
        if late:
            for r in late:
                r.status = TIMED_OUT
                r.done = now
                self._finish(r)
            batch = [r for r in batch if r.status == PENDING]
            if not batch:
                return
        if self._failure is not None:
            for r in batch:
                r.status = FAILED
                r.done = now
                self._finish(r, exc=self._failure)
            return
        loop = asyncio.get_running_loop()
        queries = [r.query for r in batch]
        self.batch_seqs.append([r.seq for r in batch])
        # the whole batch shares the snapshot stamped at cut time
        snap = batch[0].snapshot
        if self._channel is not None:
            run = functools.partial(_send_and_execute, self._channel,
                                    self.bq, queries, snap)
        else:
            run = functools.partial(_execute_on, self.bq, queries, snap)
        exec_fut = loop.run_in_executor(self._pool, run)
        try:
            results = await asyncio.shield(exec_fut)
        except asyncio.CancelledError:
            # stop(flush=False) cancelled the drainer mid-batch: fail the
            # in-flight batch's futures, swallow the worker's eventual
            # outcome, finish cancelling
            exec_fut.add_done_callback(
                lambda f: f.cancelled() or f.exception())
            now = self.clock()
            for r in batch:
                r.status = FAILED
                r.done = now
                self._finish(r, exc=asyncio.CancelledError("engine stopped"))
            raise
        except Exception as exc:  # noqa: BLE001 — a failed batch fails ITS
            # requests (submit() re-raises) and never kills the drainer,
            # which would strand every later future
            now = self.clock()
            self._n_batches += 1
            if _is_session_error(exc):
                self._failure = exc  # and every later request
            for r in batch:
                r.status = FAILED
                r.done = now
                self._finish(r, exc=exc)
            return
        now = self.clock()
        self._n_batches += 1
        token = None
        if self.semcache is not None:
            snap = batch[0].snapshot
            # the token of the state the batch executed under (its
            # cut-time snapshot), not the current one: an epoch swap
            # mid-flight leaves these entries born stale
            token = (snap.epoch, snap.n_rows) if snap is not None \
                else (0, self.bq.table.n_rows)
        for r, res in zip(batch, results):
            r.status = OK
            r.result = res
            r.done = now
            if token is not None:
                self.semcache.insert(r.query, token, res[0], res[1])
            self._finish(r)

    def _resolve_expired(self, expired: list) -> None:
        for r in expired:
            self._finish(r)

    def _finish(self, r: ServeRequest, *, exc: Optional[BaseException] = None
                ) -> None:
        self._served.append(r)
        fut = self._futures.pop(r.seq, None)
        if fut is not None and not fut.done():
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(r)

    # -- accounting --------------------------------------------------------

    def report(self, *, gt_ids: Optional[dict] = None) -> ServeReport:
        """Dispositions and latency over everything served so far.
        ``gt_ids``: optional ``{seq: ground-truth id array}`` for recall
        over the OK requests."""
        served = sorted(self._served, key=lambda r: r.seq)
        ok = [r for r in served if r.status == OK]
        lats = np.asarray([r.latency for r in ok], np.float64)
        t_end = max((r.done for r in served), default=0.0)
        seconds = max(t_end - (self._t0 or 0.0), 1e-9) if served else 0.0
        recalls = None
        if gt_ids is not None:
            recalls = [recall_at_k(r.result[0], gt_ids[r.seq])
                       for r in ok if r.seq in gt_ids]
        tiered = getattr(self.bq, "tiered", None)
        tenants: dict = {}
        for r in served:
            t = getattr(r.query, "tenant_id", None)
            d = tenants.setdefault(t, {
                "n_queries": 0, "n_ok": 0, "n_timed_out": 0,
                "n_cache_hits": 0, "recalls": []})
            d["n_queries"] += 1
            d["n_ok"] += r.status == OK
            d["n_timed_out"] += r.status == TIMED_OUT
            d["n_cache_hits"] += r.cache_hit
            if r.status == OK and gt_ids is not None and r.seq in gt_ids:
                d["recalls"].append(recall_at_k(r.result[0], gt_ids[r.seq]))
        for d in tenants.values():
            rs = d.pop("recalls")
            d["mean_recall"] = sum(rs) / len(rs) if rs else None
            d["qps"] = d["n_ok"] / seconds if served else 0.0
        return ServeReport(
            n_queries=len(served),
            n_batches=self._n_batches,
            seconds=seconds,
            qps=len(ok) / seconds if served else 0.0,
            mean_recall=float(np.mean(recalls)) if recalls else None,
            recalls=recalls,
            n_timed_out=sum(r.status == TIMED_OUT for r in served),
            p50_ms=float(np.percentile(lats, 50) * 1e3) if len(lats) else None,
            p99_ms=float(np.percentile(lats, 99) * 1e3) if len(lats) else None,
            n_inserted=0 if tiered is None else tiered.n_inserted,
            n_compactions=0 if tiered is None else tiered.n_compactions,
            epoch=0 if tiered is None else tiered.epoch,
            n_cache_hits=sum(r.cache_hit for r in served),
            tenants=tenants or None,
        )


def _bind_device(device) -> None:
    """The front end's worker thread runs on the table's card: a thread
    starts on the default device, and NCCL collectives run on the current
    one."""
    import torch

    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device.index)


def _is_session_error(exc: BaseException) -> bool:
    from repro_torch.vectordb.distributed import MeshSessionError
    return isinstance(exc, MeshSessionError)


def _execute_on(bq, queries: list, snapshot) -> list:
    """``bq.execute_batch`` on the batch's cut-time snapshot, if it has
    one."""
    if snapshot is None:
        return bq.execute_batch(queries)
    return bq.execute_batch(queries, snapshot=snapshot)


def _send_and_execute(channel, bq, queries: list, snapshot=None) -> list:
    """On the front end's worker thread: the batch to the followers (over a
    tiered table with ``snapshot``'s stamp and the ingest since the last
    message), then the batch here, so broadcast order is execution order.
    A failure that every rank shares propagates as it is; any other ends
    the session (``BatchChannel.session_error``)."""
    from repro_torch.vectordb.distributed import is_shared

    try:
        if channel.failed():  # a follower reported: send nothing more
            raise RuntimeError("a follower reported a failure")
        channel.send_batch(queries, None if snapshot is None
                           else bq.tiered.delta(snapshot))
        return _execute_on(bq, queries, snapshot)
    except Exception as exc:  # noqa: BLE001 — classified, then re-raised
        if is_shared(exc):
            raise
        raise channel.session_error(exc) from exc


def _send_stop(channel, bq) -> None:
    """The session's last message, over a tiered table with the final
    stamp (the compactions have landed) and the ingest since the last."""
    tiered = getattr(bq, "tiered", None)
    channel.send_stop(None if tiered is None
                      else tiered.delta(tiered.snapshot()))


@dataclasses.dataclass
class FollowerServed:
    """What ``serve_follower`` ran in one session: each batch's results in
    execution order (``None`` where the batch raised, on every rank alike),
    the exceptions by batch index, and over a tiered table the stamp of
    the snapshot each batch ran on and the session's final snapshot."""

    results: list = dataclasses.field(default_factory=list)
    errors: dict = dataclasses.field(default_factory=dict)
    stamps: list = dataclasses.field(default_factory=list)
    final: Optional[object] = None

    @property
    def n_batches(self) -> int:
        return len(self.results)


def serve_follower(boomhq) -> FollowerServed:
    """Serve one front-end session on a rank of a mesh of more than one rank
    other than the first, while the first runs ``AsyncServingEngine``:
    receive each batch the front end executes and run it through
    ``boomhq.execute_batch`` (every rank meets the same collectives in the
    same order), until the front end stops. Cache hits, deadlines and
    batch cuts stay on the first rank: a follower sees executed batches
    only. One call per ``start``/``stop`` session of the front end; it
    makes the session's ``distributed.BatchChannel`` with it.

    Over a tiered table the follower replays the first rank's ingest
    (``TieredTable.follow``): each message's rows go into its hot segment
    at their global ids, each compaction the first rank started runs on
    this rank's own ``CompactionScheduler``, and each batch runs on the
    snapshot its stamp names, once this rank's compactions have reached
    that epoch (``snapshot_for``). The stop carries the final stamp: the
    session ends once this rank's compaction in flight has landed there.

    A batch that raises on every rank alike (marked shared: a first-rank
    planning failure, a snapshot mismatch) is recorded and the loop goes
    on. Any other failure here is this rank's alone and has left the
    others out of step: it is reported and this process ends
    (``distributed.FAILED_EXIT``), as it does as soon as another rank
    reports one (the channel's watchdog), so no rank waits out a timeout.
    -> ``FollowerServed``."""
    from repro_torch.vectordb.distributed import (
        BATCH, BatchChannel, is_first_rank, is_shared,
    )

    mesh = getattr(boomhq, "shard_mesh", None)
    if mesh is None or mesh.size() == 1 or is_first_rank(mesh):
        raise ValueError("serve_follower runs on a rank of a mesh of more "
                         "than one rank other than the first; the first "
                         "runs AsyncServingEngine")
    channel = BatchChannel(mesh)
    device = boomhq.table.device
    tiered = getattr(boomhq, "tiered", None)
    compactor = None
    out = FollowerServed()
    with channel.watchdog():
        try:
            if tiered is not None:
                tiered.hold()
                compactor = CompactionScheduler(tiered)
            while True:
                kind, queries, tier = channel.receive(device)
                if kind != BATCH:
                    break
                snap = None
                if tier is not None:
                    tiered.follow(tier, compactor.start)
                    snap = tiered.snapshot_for(tier["stamp"])
                    out.stamps.append(snap.stamp)
                try:
                    out.results.append(_execute_on(boomhq, queries, snap))
                except Exception as exc:  # noqa: BLE001 — a failure every
                    # rank shares fails that batch only
                    if not is_shared(exc):
                        raise
                    out.errors[len(out.results)] = exc
                    out.results.append(None)
            if tier is not None:
                out.final = tiered.end_follow(tier, compactor.start)
            if compactor is not None:
                compactor.drain()
        except Exception as exc:  # noqa: BLE001 — this rank failed alone
            channel.fail(exc)
    return out


async def serve_stream(engine: AsyncServingEngine, queries: list, *,
                       arrival_gaps: Optional[list] = None,
                       timeout=_DEFAULT) -> list:
    """Submit a query stream with the given inter-arrival gaps (seconds;
    None = all at once) and await every disposition. -> the resolved
    requests in submission order (the open-loop submitter for Poisson
    traffic)."""
    async with engine:
        tasks = []
        for i, q in enumerate(queries):
            if arrival_gaps is not None and i > 0:
                await asyncio.sleep(arrival_gaps[i - 1])
            tasks.append(asyncio.ensure_future(
                engine.submit(q, timeout=timeout)))
        return list(await asyncio.gather(*tasks))
