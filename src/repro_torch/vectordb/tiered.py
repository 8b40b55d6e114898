"""Tiered hot/cold table: LSM-style streaming ingest over the IVF tier.

Port of ``repro.vectordb.tiered``:

* a small writable **hot segment** — flat, bounded capacity, append-only,
  held in host (numpy) buffers. Queries score it candidate-locally through
  the fused gather-score kernel and filter the predicate exactly, so hot
  rows never cost recall; the scan is O(capacity) per batch whatever the
  table's size.
* sealed **cold state** — the ``Table`` with its per-column IVF indexes,
  histograms and (optional) proximity graphs, searched through the
  plan-driven paths.

Row ids are GLOBAL: cold rows keep ``[0, n_cold)`` and hot rows are numbered
``id_offset + local_slot``, where ``id_offset`` is the cold row count when
their hot generation opened. Compaction appends a generation's rows to the
cold table at exactly those positions, so ids are stable across the
hot→cold transition.

Concurrency — the **epoch-swap protocol**:

* All mutable state (``_hot``/``_sealing``/``_cold``/``_epoch``) lives
  behind one condition lock and is never read by serving code. Queries
  call ``snapshot()`` once when a batch forms and execute the whole batch
  against that immutable ``TieredSnapshot``.
* Inserts append in place into the active generation's buffers, only ever
  at rows at or beyond every published snapshot's ``count``, which the
  candidate mask excludes, so in-flight queries are isolated without a
  copy.
* When the active generation fills it is **sealed** (a frozen view
  published beside a fresh empty generation) and **compaction** — usually
  on a background thread (``serve.queue.CompactionScheduler``) — folds the
  sealed rows into the cold table and indexes, then publishes the new cold
  state by swapping the snapshot and bumping the **epoch**. Batches formed
  before the swap keep their snapshot.
* Only ingest blocks (backpressure): an insert that outruns both
  generations waits for the in-flight compaction or runs one inline.

Every thread that drives the card here uses the current (default) stream,
so the publish orders after every kernel that built the new cold state.

Over a mesh of more than one rank (``BoomHQ.bind_shards(mesh=...)``) the
first rank owns ingest and every epoch cut; the others replay them:

* the first rank's table keeps a **log** (``lead``) of each compaction's
  start (its rows ``[a, b)``, sequence number and re-cluster decision) and
  each publish, each at the row count when it happened. A snapshot records
  the log's length when it was published, so ``stamp`` and ``log_pos`` of
  a snapshot name one instant of the ingest. ``delta(snap)`` is what a
  follower lacks up to that instant: the log since the last delta and the
  rows inserted since, read back as host arrays;
* a follower (``hold`` .. ``end_follow``) writes those rows at their global
  ids through ``insert`` and, at each compaction start, seals exactly the
  rows named (a partial generation too) and compacts them on its own
  thread; a publish waits until the first rank's log has published that
  epoch, so a follower never runs ahead of the batch it serves
  (``snapshot_for(stamp)`` waits for the stamp's epoch and raises if it
  cannot reach it);
* ``row_multiple``: a compaction that would leave a cold row count the
  mesh's shards do not divide raises before it seals anything, and the
  rows stay hot.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.vectordb import graph as graphmod
from repro_torch.vectordb import histogram, ivf
from repro_torch.vectordb.table import Table

DEFAULT_HOT_CAPACITY = 1024


# host->device materializations of hot views, for the per-insert transfer
# accounting (one "transfer" = one column buffer moved); see hot_view_transfers
_transfer_lock = threading.Lock()
_hot_view_transfers = 0


def hot_view_transfers() -> int:
    """Cumulative count of hot-view column buffers copied host->device.

    Publishing a view is free — the device copies are built lazily on the
    first reader — so the delta across an insert-only window (no query
    snapshot read) must be 0."""
    with _transfer_lock:
        return _hot_view_transfers


class HotView:
    """Immutable logical view of one hot generation at a published instant.

    Construction captures REFERENCES to the generation's full-capacity host
    buffers plus ``count``/``id_offset``. The device tensors are built
    lazily on the first ``vectors``/``scalars`` read (double-checked under
    the view's lock) and cached per view, so insert-only windows publish
    versions at zero transfer cost.

    Only rows ``< count`` are valid, and they are never rewritten: appends
    only ever write rows at or beyond every published view's ``count``.
    That invariant is what makes the lazy read sound — on the CPU the
    tensors alias the live buffers (``torch.from_numpy``); on the card the
    copy is synchronous from pageable memory, so it has finished reading
    the buffer before it returns — and the candidate mask excludes every
    row the copy may have caught mid-append."""

    __slots__ = ("np_vectors", "np_scalars", "count", "id_offset", "device",
                 "_device_tensors", "_lock")

    def __init__(self, np_vectors: tuple, np_scalars: np.ndarray,
                 count: int, id_offset: int, device: torch.device):
        self.np_vectors = tuple(np_vectors)  # per-column (capacity, d_i) f32
        self.np_scalars = np_scalars  # (capacity, M) f32
        self.count = count  # valid rows
        self.id_offset = id_offset  # global row id of local slot 0
        self.device = torch.device(device)
        self._device_tensors = None
        self._lock = threading.Lock()

    def _materialize(self):
        if self._device_tensors is None:
            with self._lock:
                if self._device_tensors is None:
                    global _hot_view_transfers
                    dev = (tuple(torch.from_numpy(b).to(self.device)
                                 for b in self.np_vectors),
                           torch.from_numpy(self.np_scalars).to(self.device))
                    with _transfer_lock:
                        _hot_view_transfers += len(self.np_vectors) + 1
                    self._device_tensors = dev
        return self._device_tensors

    @property
    def vectors(self) -> tuple:
        return self._materialize()[0]

    @property
    def scalars(self) -> torch.Tensor:
        return self._materialize()[1]

    @property
    def capacity(self) -> int:
        return int(self.np_scalars.shape[0])


@dataclasses.dataclass(frozen=True)
class ColdState:
    """One sealed cold epoch: table + per-column IVF + histograms, plus the
    optional per-column proximity graphs (``None`` without a graph tier),
    sealed and extended exactly like the IVF state."""

    table: Table
    indexes: tuple
    hists: histogram.Histograms
    graphs: tuple | None = None


@dataclasses.dataclass(frozen=True)
class TieredSnapshot:
    """The consistent ``(epoch, hot_views, cold)`` unit every batch executes
    against. Immutable — a swap publishes a NEW snapshot."""

    epoch: int
    cold: ColdState
    hot_views: tuple  # 0..2 HotView (active [+ sealing during compaction])
    # the first rank's ingest log length at this publish (TieredTable.lead)
    log_pos: int = 0

    @property
    def n_hot(self) -> int:
        return sum(v.count for v in self.hot_views)

    @property
    def n_rows(self) -> int:
        """Logical row count (cold + every hot view)."""
        return self.cold.table.n_rows + self.n_hot

    @property
    def stamp(self) -> tuple:
        """``(epoch, cold rows, rows)``: what every rank of a mesh must
        serve a batch on. The hot views follow from it and the ingest log:
        a generation starts where the cold rows end."""
        return (self.epoch, self.cold.table.n_rows, self.n_rows)


def cold_digest(cold: ColdState) -> int:
    """A 63-bit digest of a cold epoch's layouts: each IVF index's
    ``sorted_rows`` and ``offsets``, the histograms' prefix counts and each
    graph's ``neighbors``. Ranks that recomputed the same compactions hold
    equal digests."""
    h = hashlib.sha256()
    parts = [x for idx in cold.indexes for x in (idx.sorted_rows,
                                                 idx.offsets)]
    parts.append(cold.hists.prefix)
    parts += [g.neighbors for g in cold.graphs or ()]
    for x in parts:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little") >> 1


class _HotBuffer:
    """Mutable append-only host-side backing of one hot generation."""

    def __init__(self, schema, capacity: int, id_offset: int,
                 device: torch.device):
        self.vectors = [np.zeros((capacity, vc.dim), np.float32)
                        for vc in schema.vector_cols]
        self.scalars = np.zeros((capacity, schema.n_scalar), np.float32)
        self.count = 0
        self.id_offset = id_offset
        self.capacity = capacity
        self.device = device

    def write(self, vecs: list, scal: np.ndarray, pos: int, take: int) -> None:
        lo = self.count
        for buf, v in zip(self.vectors, vecs):
            buf[lo: lo + take] = v[pos: pos + take]
        self.scalars[lo: lo + take] = scal[pos: pos + take]
        self.count += take

    def view(self) -> HotView:
        # a host-side token over the live buffers: rows >= count are stale
        # or appended after this publish, and masked out by every consumer
        return HotView(np_vectors=tuple(self.vectors),
                       np_scalars=self.scalars, count=self.count,
                       id_offset=self.id_offset, device=self.device)


class TieredTable:
    """Writable hot segment in front of sealed cold IVF state.

    Owns ALL mutable tiering state. Serving code reads through
    ``snapshot()``; ingest goes through ``insert()``, compaction through
    ``compact()`` — both safe from any thread.
    """

    def __init__(self, table: Table, indexes, hists, *,
                 hot_capacity: int = DEFAULT_HOT_CAPACITY,
                 rebuild_every: int = 0,
                 finetune_cb: Optional[Callable] = None,
                 graphs=None):
        if hot_capacity < 1:
            raise ValueError(f"hot_capacity {hot_capacity} < 1")
        self.schema = table.schema
        self.device = table.device
        self.hot_capacity = hot_capacity
        # every Nth compaction re-clusters each column (a full k-means
        # build) instead of the nearest-centroid extend; 0 = never
        self.rebuild_every = rebuild_every
        # finetune_cb(new_cold, first_new, n_new) runs on the compacting
        # thread before the publish
        self.finetune_cb = finetune_cb
        self._cond = threading.Condition()
        self._cold = ColdState(
            table, tuple(indexes), hists,
            tuple(graphs) if graphs is not None else None)
        self._hot = _HotBuffer(table.schema, hot_capacity,
                               id_offset=table.n_rows, device=self.device)
        self._sealing: Optional[HotView] = None
        self._compacting = False
        self._epoch = 0
        self._compactions = 0
        self._inserted = 0
        self._rows_since_finetune = 0
        # over a mesh: the cold row count must stay a multiple of this
        self.row_multiple = 1
        # the first rank's ingest log (lead): entries, the absolute index
        # of entries[0], and the (log index, row count) sent so far
        self._log: Optional[list] = None
        self._log_base = 0
        self._sent = (0, table.n_rows)
        # a follower's session (hold .. end_follow): the highest epoch it
        # may publish, the last compaction a log entry started, and a
        # failure of its own compaction
        self._gate: Optional[int] = None
        self._follow_seq = 0
        self._failure: Optional[BaseException] = None
        self._snap = self._build_snapshot()

    # -- the one sanctioned read path --------------------------------------

    def snapshot(self) -> TieredSnapshot:
        """The current published snapshot — ONE atomic pointer read. Take it
        once at batch formation and use it for the whole batch."""
        return self._snap

    # -- bookkeeping (host-side, locked) ------------------------------------

    def _build_snapshot(self) -> TieredSnapshot:
        views = []
        if self._sealing is not None and self._sealing.count > 0:
            views.append(self._sealing)
        if self._hot.count > 0:
            views.append(self._hot.view())
        log_pos = 0 if self._log is None else self._log_base + len(self._log)
        return TieredSnapshot(epoch=self._epoch, cold=self._cold,
                              hot_views=tuple(views), log_pos=log_pos)

    def _publish_locked(self) -> None:
        self._snap = self._build_snapshot()

    def _seal_locked(self) -> None:
        """Freeze the (full) active generation and open a fresh one whose
        id space starts right behind it."""
        assert self._sealing is None
        self._sealing = self._hot.view()
        self._hot = _HotBuffer(
            self.schema, self.hot_capacity,
            id_offset=self._sealing.id_offset + self._sealing.count,
            device=self.device)
        self._publish_locked()

    # -- ingest -------------------------------------------------------------

    def insert(self, vectors: list, scalars) -> dict:
        """Append rows to the hot segment; global ids are assigned in
        arrival order. Never blocks serving — only the ingest caller waits
        (or compacts inline) when both generations are full."""
        vecs = [np.asarray(v, np.float32) for v in vectors]
        scal = np.asarray(scalars, np.float32)
        m = int(scal.shape[0])
        pos = 0
        while pos < m:
            run_inline = False
            with self._cond:
                free = self._hot.capacity - self._hot.count
                if free > 0:
                    take = min(free, m - pos)
                    self._hot.write(vecs, scal, pos, take)
                    pos += take
                    self._publish_locked()
                    if pos == m:
                        break
                    continue
                # active generation full and rows remain: make room
                if self._compacting or self._follow_pending_locked():
                    # backpressure: the in-flight compaction publishes soon
                    self._cond.wait(timeout=30.0)
                    continue
                if self._sealing is None:
                    self._seal_locked()
                    continue
                if self._gate is not None:  # a follower compacts by the log
                    raise RuntimeError(
                        f"a follower's rows outran its compactions: sealed "
                        f"rows [{self._sealing.id_offset}, "
                        f"{self._sealing.id_offset + self._sealing.count}) "
                        f"have no compaction started"
                        + ("" if self._failure is None else
                           f" (its compaction failed: {self._failure!r})"))
                run_inline = True  # sealed segment pending, no worker
            if run_inline:
                self.compact()
        with self._cond:
            self._inserted += m
            self._rows_since_finetune += m
            return {"inserted": m, "hot_fill": self._hot.count,
                    "hot_capacity": self.hot_capacity,
                    "needs_compaction": self._needs_compaction_locked(),
                    "epoch": self._epoch}

    def _needs_compaction_locked(self) -> bool:
        return self._sealing is not None or \
            self._hot.count >= self.hot_capacity

    def needs_compaction(self) -> bool:
        with self._cond:
            return self._needs_compaction_locked() and not self._compacting

    # -- compaction ---------------------------------------------------------

    def compact(self) -> dict:
        """Fold the sealed hot generation into the cold state and publish
        under a new epoch. The heavy work (append, cluster assignment,
        histogram re-bin, graph extension, the owner's callback) runs
        OUTSIDE the lock; in-flight batches keep their snapshot. A
        compaction that would leave a cold row count ``row_multiple`` does
        not divide raises ``ValueError`` before it seals anything."""
        t_start = time.perf_counter()
        with self._cond:
            if self._compacting:
                return {"compacted": 0, "epoch": self._epoch}
            if self._sealing is None and self._hot.count == 0:
                return {"compacted": 0, "epoch": self._epoch}
            rows = self._hot.count if self._sealing is None \
                else self._sealing.count
            after = self._cold.table.n_rows + rows
            if after % self.row_multiple:
                raise ValueError(
                    f"compacting {rows} hot rows would leave {after} cold "
                    f"rows, which {self.row_multiple} mesh shards do not "
                    f"divide; the rows stay hot")
            # the rebuild_every decision is a function of WHICH compaction
            # this is: its sequence number is taken under the lock at seal
            # time, so a concurrent compaction can neither skip nor double
            # the re-cluster
            seq = self._compactions + 1
            rebuild = self.rebuild_every > 0 and seq % self.rebuild_every == 0
            first = self._cold.table.n_rows
            self._log_locked("compact", first, after, seq, rebuild)
            if self._sealing is None:
                self._seal_locked()
            frozen = self._sealing
            cold = self._cold
            self._compacting = True
        try:
            n = frozen.count
            first_new = cold.table.n_rows
            if first_new != frozen.id_offset:  # global ids must stay stable
                raise RuntimeError(f"sealed rows start at {frozen.id_offset}"
                                   f", the cold table holds {first_new}")
            table = cold.table.append([b[:n] for b in frozen.np_vectors],
                                      frozen.np_scalars[:n])
            if rebuild:  # sealing step: full re-cluster of every column
                indexes = tuple(
                    ivf.build(v, idx.n_clusters, seed=i, metric=idx.metric)
                    for i, (idx, v) in enumerate(
                        zip(cold.indexes, table.vectors)))
            else:  # steady state: nearest-centroid incremental insert
                indexes = tuple(ivf.extend(idx, v[first_new:], first_new)
                                for idx, v in zip(cold.indexes,
                                                  table.vectors))
            hists = histogram.update(cold.hists, table.scalars[first_new:])
            # new rows get forward edges against the full post-append
            # column plus reverse-edge splices (incremental even on a
            # rebuild compaction, as in the reference)
            graphs = None if cold.graphs is None else tuple(
                graphmod.extend(g, v, first_new)
                for g, v in zip(cold.graphs, table.vectors))
            new_cold = ColdState(table, indexes, hists, graphs)
            if self.finetune_cb is not None:
                self.finetune_cb(new_cold, first_new, n)
                with self._cond:
                    self._rows_since_finetune = max(
                        0, self._rows_since_finetune - n)
        except BaseException as exc:
            with self._cond:  # leave the sealed segment intact for a retry
                self._compacting = False
                if self._gate is not None:
                    self._failure = exc
                self._cond.notify_all()
            raise
        with self._cond:
            # a follower publishes an epoch once the first rank's log has
            while self._gate is not None and self._gate <= self._epoch:
                self._cond.wait()
            self._cold = new_cold
            self._sealing = None
            self._epoch += 1
            self._compactions += 1
            self._compacting = False
            self._log_locked("publish", self._epoch)
            self._publish_locked()
            self._cond.notify_all()
            epoch = self._epoch
        return {"compacted": n, "epoch": epoch, "rebuild": rebuild,
                "seconds": time.perf_counter() - t_start}

    # -- the first rank's ingest log (a mesh of more than one rank) ---------

    def lead(self) -> None:
        """Keep the ingest log from here on: this table's rows and epoch
        cuts are the ones every other rank of the mesh replays."""
        with self._cond:
            if self._log is None:
                self._log, self._log_base = [], 0
                self._sent = (0, self._snap.n_rows)

    def _log_locked(self, kind: str, *body) -> None:
        if self._log is not None:
            self._log.append((kind, self._snap.n_rows) + body)
            # the same snapshot, its log position past the entry, so the
            # next batch cut carries it (a compaction start seals nothing
            # when its generation was sealed full)
            self._snap = dataclasses.replace(
                self._snap, log_pos=self._log_base + len(self._log))

    def delta(self, snap: TieredSnapshot) -> dict:
        """What a follower lacks to serve on ``snap`` (a snapshot this
        table published since ``lead``, no older than the last one passed
        here): its stamp, the log entries up to its publish and the rows
        inserted up to its row count since the last delta, as host arrays
        (hot rows from their buffers, rows compacted since from the cold
        table). Entries logged after ``snap`` ride on a later delta."""
        with self._cond:
            pos, lo = self._sent
            hi = snap.n_rows
            if self._log is None or snap.log_pos < pos or hi < lo:
                raise ValueError(f"snapshot {snap.stamp} at log position "
                                 f"{snap.log_pos} is older than the last "
                                 f"sent ({pos}, {lo}) or not led here")
            events = self._log[pos - self._log_base:
                               snap.log_pos - self._log_base]
            del self._log[: snap.log_pos - self._log_base]
            self._log_base = snap.log_pos
            self._sent = (snap.log_pos, hi)
            latest = self._snap
        vecs, scal = read_rows(latest, lo, hi)
        return dict(stamp=snap.stamp, events=events, lo=lo, vectors=vecs,
                    scalars=scal)

    # -- a follower: the first rank's ingest, replayed -----------------------

    def _follow_pending_locked(self) -> bool:
        """A follower's compaction that a log entry started has not
        published yet (its thread may not have begun)."""
        return self._gate is not None and \
            self._follow_seq > self._compactions and self._failure is None

    def hold(self) -> None:
        """Start a follower's session: from here on this table seals,
        compacts and publishes only as the first rank's log says
        (``follow``)."""
        with self._cond:
            self._gate = self._epoch
            self._follow_seq = self._compactions
            self._failure = None

    def follow(self, delta: dict, start_compaction: Callable) -> None:
        """Apply one ``delta`` of the first rank: its rows at their global
        ids through ``insert``, each logged event at the row count where it
        happened. At a compaction start the rows ``[a, b)`` it names are
        sealed here (a partial generation too) and
        ``start_compaction()`` runs ``compact`` on the follower's own
        thread; a publish lets that epoch publish here."""
        lo, vecs, scal = delta["lo"], delta["vectors"], delta["scalars"]
        with self._cond:
            have = self._snap.n_rows
        if have != lo:
            raise RuntimeError(f"a follower holding {have} rows was sent "
                               f"rows from {lo}")
        done = lo

        def write_to(pos):
            nonlocal done
            if pos > done:
                self.insert([v[done - lo: pos - lo] for v in vecs],
                            scal[done - lo: pos - lo])
                done = pos

        for kind, pos, *body in delta["events"]:
            write_to(pos)
            if kind == "publish":
                with self._cond:
                    self._gate = max(self._gate, body[0])
                    self._cond.notify_all()
                continue
            a, b, seq, rebuild = body
            with self._cond:
                if seq <= self._follow_seq:
                    continue  # the first rank's retry of a failed start
                if rebuild != (self.rebuild_every > 0
                               and seq % self.rebuild_every == 0):
                    raise RuntimeError(f"compaction {seq}'s re-cluster "
                                       f"decision differs from the first "
                                       f"rank's ({rebuild})")
                while self._sealing is not None and \
                        self._follow_pending_locked():
                    self._cond.wait()
                if self._failure is not None:
                    raise RuntimeError("a follower's compaction failed") \
                        from self._failure
                if self._sealing is None and self._hot.id_offset == a \
                        and self._hot.count == b - a:
                    self._seal_locked()
                got = None if self._sealing is None else (
                    self._sealing.id_offset,
                    self._sealing.id_offset + self._sealing.count)
                if got != (a, b):
                    raise RuntimeError(f"compaction {seq} of rows [{a}, {b})"
                                       f" finds {got} sealed on a follower")
                self._follow_seq = seq
            start_compaction()
        write_to(lo + int(scal.shape[0]))

    def snapshot_for(self, stamp: tuple) -> TieredSnapshot:
        """The snapshot a follower serves a batch stamped ``stamp`` on,
        once its own compaction has reached the stamp's epoch (the log has
        let none beyond it publish). Raises when this table cannot reach
        the stamp: a compaction of its own failed, or its rows differ."""
        epoch = stamp[0]
        with self._cond:
            while self._epoch < epoch and self._follow_pending_locked():
                self._cond.wait()
            snap, failure = self._snap, self._failure
        if failure is not None:
            raise RuntimeError(f"a follower cannot reach the stamp {stamp}: "
                               f"its compaction failed") from failure
        if snap.stamp != tuple(stamp):
            raise RuntimeError(f"a follower holds {snap.stamp} where the "
                               f"first rank stamped {tuple(stamp)}")
        return snap

    def end_follow(self, delta: dict, start_compaction: Callable
                   ) -> TieredSnapshot:
        """The follower's session ends on the first rank's final stamp:
        apply the last ``delta``, wait out the compaction in flight, and
        return the snapshot at that stamp."""
        self.follow(delta, start_compaction)
        snap = self.snapshot_for(delta["stamp"])
        with self._cond:
            self._gate = None
            self._cond.notify_all()
        return snap

    # -- accounting ---------------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._cond:
            return self._epoch

    @property
    def n_compactions(self) -> int:
        with self._cond:
            return self._compactions

    @property
    def n_inserted(self) -> int:
        with self._cond:
            return self._inserted

    def encoder_staleness(self) -> float:
        """Fraction of logical rows the data encoder has never seen — the
        drift the owner's finetune policy reads."""
        with self._cond:
            snap = self._snap
            return self._rows_since_finetune / max(1, snap.n_rows)

    def logical_table(self) -> Table:
        """Materialize the concatenated logical table (cold ‖ hot views) —
        for oracles, ground truth and offline use, NOT the serving path."""
        snap = self.snapshot()
        t = snap.cold.table
        if not snap.hot_views:
            return t
        vecs = [v.cpu().numpy() for v in t.vectors]
        scal = t.scalars.cpu().numpy()
        for view in snap.hot_views:
            vecs = [np.concatenate([a, b[: view.count]])
                    for a, b in zip(vecs, view.np_vectors)]
            scal = np.concatenate([scal, view.np_scalars[: view.count]])
        return Table.from_numpy(t.schema, vecs, scal, device=t.device)


def read_rows(snap: TieredSnapshot, lo: int, hi: int) -> tuple:
    """Rows ``[lo, hi)`` of a snapshot (cold rows, then its hot views) as
    host arrays: -> (per-column (hi - lo, d_i) f32, (hi - lo, M) f32)."""
    t = snap.cold.table
    nc = t.n_rows
    parts = []
    if lo < nc:
        top = min(hi, nc)
        parts.append(([v[lo: top].cpu().numpy() for v in t.vectors],
                      t.scalars[lo: top].cpu().numpy()))
    for view in snap.hot_views:
        a = max(lo, view.id_offset) - view.id_offset
        b = min(hi, view.id_offset + view.count) - view.id_offset
        if a < b:
            parts.append(([x[a: b] for x in view.np_vectors],
                          view.np_scalars[a: b]))
    vecs = [np.concatenate([p[0][i] for p in parts]
                           or [np.zeros((0, vc.dim), np.float32)])
            for i, vc in enumerate(t.schema.vector_cols)]
    scal = np.concatenate([p[1] for p in parts]
                          or [np.zeros((0, t.schema.n_scalar), np.float32)])
    if scal.shape[0] != hi - lo:
        raise ValueError(f"rows [{lo}, {hi}) are not all in the snapshot "
                         f"{snap.stamp}")
    return vecs, scal


# ---------------------------------------------------------------------------
# hot-segment scoring + merge (the query-side half)
# ---------------------------------------------------------------------------

def _hot_topk(view_args, qs, weights, pred_b, *, k: int, metric: str):
    """Exact filtered top-k over one hot view for a padded query batch.

    Candidate slots are the full static capacity with the slots at or past
    ``count`` set to -1, scored by the fused gather-score kernel from the
    view's own buffer. Local slot ids map to global ids by the view's
    offset."""
    from repro_torch.kernels.gather_score import gather_score_topk

    vectors, scalars, count, id_offset = view_args
    cap = scalars.shape[0]
    b = weights.shape[0]
    slots = torch.arange(cap, dtype=torch.int32, device=scalars.device)
    cand = torch.where(slots < count, slots, torch.full_like(slots, -1))
    cand = cand.expand(b, cap).contiguous()
    ids, scores, n_qual = gather_score_topk(
        cand, vectors, qs, weights, scalars, pred_b, k=k, metric=metric)
    ids = torch.where(ids >= 0, ids + id_offset, torch.full_like(ids, -1))
    return ids.to(torch.int32), scores, n_qual


def merge_hot_batch(cold_ids, cold_scores, views, qs, weights, pred_b, *,
                    k: int, metric: str):
    """Fold every hot view's exact candidates into the cold results through
    the dedup merge (``merge_topk_unique``): the hot segment is one more
    candidate source. Hot and cold id spaces are disjoint by construction,
    so ties break by smaller global id as in the sharded merge.

    ``views``: tuple of ``view_args`` tuples (vectors, scalars, count,
    id_offset). -> (ids (B, k) int32, scores (B, k))."""
    from repro_torch.kernels.gather_score import merge_topk_unique

    all_ids, all_scores = [cold_ids.to(torch.int32)], [cold_scores]
    for va in views:
        ids, scores, _ = _hot_topk(va, qs, weights, pred_b, k=k,
                                   metric=metric)
        all_ids.append(ids)
        all_scores.append(scores)
    return merge_topk_unique(torch.cat(all_ids, dim=1),
                             torch.cat(all_scores, dim=1), k)


def view_args(view: HotView) -> tuple:
    """HotView -> the (vectors, scalars, count, id_offset) tuple
    ``merge_hot_batch`` consumes (materializes the view)."""
    return (view.vectors, view.scalars, int(view.count),
            int(view.id_offset))
