"""Semantic result cache: repeated and near-duplicate MHQs short-circuit
the engine at submit time.

Port of ``repro.serve.semcache``. The cache sits in FRONT of the batch
former: a hit returns a previously computed ``(ids, scores)`` at zero scan
cost; a miss executes normally and populates. A hit needs every clause:

* **the same canonical predicate signature** — the DNF normalized
  (inactive bounds forced to ±inf, invalid and empty clauses dropped,
  clauses sorted), so clause order, padding bucket and inactive-column
  garbage do not split it while any semantic difference does. The bytes
  are the JAX package's for the same predicate;
* **the same tenant** — part of the key, never of the fuzzy match (the
  engine also folds the tenant conjunct into the predicate before lookup);
* **a compatible k bucket** — computed for the same padded top-k bucket
  with ``entry.k >= q.k``, so ``ids[:q.k]`` is the query's top-k;
* **query vectors within ε of the entry's** — per vector column,
  ``||q_i - c_i||_2 <= eps``; ``eps=0`` caches exact repeats only, with
  bit-for-bit replay;
* **a fresh token** — every entry carries the freshness token of the state
  it was computed under: ``(TieredSnapshot.epoch, n_rows)`` tiered,
  ``(0, table.n_rows)`` otherwise. A hit requires equality with the
  CURRENT token, so an epoch bump or any hot insert flushes implicitly;
  stale entries drop on first touch (``stale_drops``).

Storage is a bounded per-tenant LRU, so one tenant can never evict
another's working set. All methods are thread-safe.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core.executor import K_BUCKET_FLOOR, next_bucket
from repro_torch.core.query import MHQ
from repro_torch.vectordb.predicates import PredicateLike, as_set

DEFAULT_CAPACITY_PER_TENANT = 256


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def predicate_signature(pred: PredicateLike) -> bytes:
    """Canonical byte signature of a DNF predicate: two predicates share
    one iff their normalized clause SETS coincide (see module doc)."""
    ps = as_set(pred)
    active = _np(ps.active).astype(bool)
    lo = _np(ps.lo).astype(np.float32)  # astype copies
    hi = _np(ps.hi).astype(np.float32)
    valid = _np(ps.clause_valid).astype(bool)
    lo[~active] = -np.inf
    hi[~active] = np.inf
    clauses = []
    for c in range(active.shape[0]):
        if not valid[c]:
            continue
        if np.any(active[c] & (lo[c] > hi[c])):
            continue  # empty clause: contributes nothing to the union
        clauses.append(active[c].tobytes() + lo[c].tobytes() + hi[c].tobytes())
    if not clauses:
        return b"false"
    return b"|".join(sorted(clauses))


def query_signature(q: MHQ) -> bytes:
    """Exact-match part of the cache key: predicate signature + weights +
    recall target (plans, and so approximate results, may differ across
    recall targets)."""
    w = np.asarray(q.weights, np.float32).tobytes()
    rt = np.float32(q.recall_target).tobytes()
    return predicate_signature(q.predicates) + b"#" + w + rt


def k_bucket(k: int) -> int:
    return next_bucket(k, K_BUCKET_FLOOR)


@dataclasses.dataclass
class CacheEntry:
    centroids: tuple  # per vector column, (d_i,) np.float32
    k: int  # the k the result was computed for
    ids: np.ndarray  # (k,) int — cached result rows
    scores: np.ndarray  # (k,) f32 — cached result scores
    token: tuple  # (epoch, n_rows) freshness stamp


class SemanticCache:
    """Bounded per-tenant semantic result cache (see module doc).

    ``eps`` is a float (both metrics) or a ``{"dot": e, "l2": e}`` mapping.
    ``lookup``/``insert`` take the CURRENT freshness token, which the
    engine derives from the serving snapshot."""

    def __init__(self, *, capacity_per_tenant: int = DEFAULT_CAPACITY_PER_TENANT,
                 eps: float | dict = 0.0, metric: str = "dot"):
        if capacity_per_tenant < 1:
            raise ValueError(f"capacity_per_tenant {capacity_per_tenant} < 1")
        self.capacity_per_tenant = capacity_per_tenant
        self._eps = eps
        self.metric = metric
        self._lock = threading.Lock()
        # tenant -> OrderedDict[entry_id, CacheEntry]  (LRU order)
        self._tenants: dict = {}
        # (tenant, sig, k_bucket) -> [entry_id, ...]
        self._index: dict = {}
        self._next_id = 0
        self.hits = 0
        self.misses = 0
        self.stale_drops = 0
        self.evictions = 0
        self.tenant_hits: dict = {}

    @property
    def eps(self) -> float:
        e = self._eps
        return float(e[self.metric]) if isinstance(e, dict) else float(e)

    # -- internals (call with lock held) ------------------------------------

    def _drop_locked(self, tenant, eid: int) -> None:
        lru = self._tenants.get(tenant)
        if lru is None or eid not in lru:
            return
        del lru[eid]
        for key, eids in list(self._index.items()):
            if key[0] == tenant and eid in eids:
                eids.remove(eid)
                if not eids:
                    del self._index[key]

    def _within_eps_locked(self, entry: CacheEntry, q: MHQ) -> bool:
        eps = self.eps
        for qv, c in zip(q.query_vectors, entry.centroids):
            if float(np.linalg.norm(_np(qv).astype(np.float32) - c)) > eps:
                return False
        return True

    # -- public API ----------------------------------------------------------

    def lookup(self, q: MHQ, token: tuple) -> Optional[tuple]:
        """Cached ``(ids, scores)`` (length ``q.k``) on a hit, else None.
        Entries stamped with another token than ``token`` are stale,
        dropped on touch, and never served."""
        tenant = q.tenant_id
        key = (tenant, query_signature(q), k_bucket(q.k))
        with self._lock:
            for eid in list(self._index.get(key, ())):
                entry = self._tenants[tenant][eid]
                if entry.token != token:
                    self._drop_locked(tenant, eid)
                    self.stale_drops += 1
                    continue
                if entry.k < q.k or not self._within_eps_locked(entry, q):
                    continue
                self._tenants[tenant].move_to_end(eid)
                self.hits += 1
                self.tenant_hits[tenant] = self.tenant_hits.get(tenant, 0) + 1
                return (entry.ids[: q.k].copy(), entry.scores[: q.k].copy())
            self.misses += 1
            return None

    def insert(self, q: MHQ, token: tuple, ids, scores) -> None:
        """Populate after a miss executed, stamped with the token of the
        state it was computed under (the batch's snapshot, not the current
        one: the table may have moved while the batch ran)."""
        tenant = q.tenant_id
        entry = CacheEntry(
            centroids=tuple(_np(v).astype(np.float32)
                            for v in q.query_vectors),
            k=int(q.k), ids=_np(ids).copy(),
            scores=_np(scores).astype(np.float32), token=tuple(token))
        key = (tenant, query_signature(q), k_bucket(q.k))
        with self._lock:
            lru = self._tenants.setdefault(tenant, OrderedDict())
            # a storm of concurrent misses for one (near-)identical query
            # replaces its entry in place instead of appending duplicates
            # that would evict distinct working-set entries
            for eid in self._index.get(key, ()):
                old = lru.get(eid)
                if old is not None and self._within_eps_locked(old, q):
                    lru[eid] = entry
                    lru.move_to_end(eid)
                    return
            eid = self._next_id
            self._next_id += 1
            lru[eid] = entry
            self._index.setdefault(key, []).append(eid)
            while len(lru) > self.capacity_per_tenant:
                self._drop_locked(tenant, next(iter(lru)))
                self.evictions += 1

    def invalidate_tenant(self, tenant) -> int:
        """Drop every entry of one tenant; -> the count dropped."""
        with self._lock:
            self.tenant_hits.pop(tenant, None)
            lru = self._tenants.pop(tenant, None)
            if not lru:
                return 0
            self._index = {k: v for k, v in self._index.items()
                           if k[0] != tenant}
            return len(lru)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._tenants.values())

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "stale_drops": self.stale_drops,
                "evictions": self.evictions,
                "entries": sum(len(v) for v in self._tenants.values()),
                "tenant_hits": dict(self.tenant_hits),
            }
