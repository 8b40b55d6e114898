"""Fixed-degree proximity graph index (Vamana-style) + beam-search entry.

Port of ``repro.vectordb.graph``: the third index strategy next to ``flat``
and ``ivf``. A degree-``R`` navigable graph is built offline from the
table, and searched by the fixed-trip-count predicate-aware beam walk of
``kernels.beam_search``.

Build, as in the JAX package:

  1. blocked exact kNN — each row's top-``4R`` candidates by one GEMM per
     chunk of rows;
  2. α-occlusion prune of the candidates down to ``R/2`` forward edges;
  3. reverse-edge fill of the free slots;
  4. entry points (medoid + strided rows) and a reachability repair that
     splices edges into rows the entries cannot reach.

The GEMM parts (1, 2, the medoid and the repair's donor search) run on the
vectors' device; the reverse fill and the repair's breadth-first flood
are host numpy, as in the JAX package. The kNN selection keeps ties in row
order among the chosen candidates; which of several candidates tied at
the cut is chosen may differ from ``lax.top_k``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.shapes import GRAPH_ENTRY_POINTS, NEG
from repro_torch.vectordb.predicates import PredicateLike, stack

# Legalized out-degrees: every adjacency launched at serving time has one
# of these static widths.
DEGREE_GRID = (8, 16, 32)
DEFAULT_DEGREE = 16
# α > 1 keeps a candidate unless it is α-times closer to a kept neighbor
# than to the node — the Vamana densification that keeps long-range edges.
DEFAULT_ALPHA = 1.2
# candidate pool width for the prune, as a multiple of the degree
BUILD_CANDIDATE_MULT = 4
_KNN_CHUNK = 1024
_PRUNE_CHUNK = 512
_DONORS = 64  # donor candidates per unreached row in the repair


@dataclasses.dataclass
class GraphIndex:
    neighbors: torch.Tensor  # (n, R) int32 adjacency, -1 = free slot
    entry_points: torch.Tensor  # (E,) int32 — medoid + strided seeds
    metric: str

    @property
    def degree(self) -> int:
        return int(self.neighbors.shape[1])

    @property
    def n_rows(self) -> int:
        return int(self.neighbors.shape[0])


def legal_degree(degree: int) -> int:
    """Smallest grid degree >= the request (largest grid entry if none)."""
    for d in DEGREE_GRID:
        if d >= degree:
            return d
    return DEGREE_GRID[-1]


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _topk_row_order(x: torch.Tensor, k: int):
    """Top-k along the last axis (``torch.topk``'s selection, not a full
    sort), the chosen entries ordered by (-value, index)."""
    vals, idx = torch.topk(x, k, dim=-1)
    o1 = torch.argsort(idx, dim=-1, stable=True)
    o2 = torch.argsort(-vals.gather(-1, o1), dim=-1, stable=True)
    order = o1.gather(-1, o2)
    return vals.gather(-1, order), idx.gather(-1, order)


def _sims(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """(|a|, |b|) similarities; l2 is the expanded -‖a - b‖²."""
    g = a @ b.T
    if metric == "l2":
        g = (2.0 * g - torch.sum(b * b, dim=1)[None, :]
             - torch.sum(a * a, dim=1)[:, None])
    return g


def _chunk_topk(vectors, chunk, row0: int, *, c: int, metric: str):
    """Exact top-c neighbors of ``chunk`` rows (table rows row0..) against
    the whole column, self-similarity masked out."""
    sims = _sims(chunk, vectors, metric)
    ar = torch.arange(chunk.shape[0], device=chunk.device)
    sims[ar, row0 + ar] = NEG
    top_s, top_i = _topk_row_order(sims, c)
    return torch.where(top_s > NEG / 2, top_i,
                       torch.full_like(top_i, -1)).to(torch.int32), top_s


def _prune_chunk(cand_ids, cand_sims, cand_vecs, alpha, *, r: int,
                 metric: str):
    """α-occlusion prune of (B, C) similarity-ordered candidate lists down
    to degree r. Candidate t is occluded when some already-kept l has
    sim(t, l) beating the α-adjusted sim(node, t). The walk over t is
    sequential (each decision reads the kept set), batched over B."""
    g = torch.einsum("bcd,bed->bce", cand_vecs, cand_vecs)
    if metric == "l2":
        nrm = torch.sum(cand_vecs * cand_vecs, dim=-1)  # (B, C)
        pair = 2.0 * g - nrm[:, :, None] - nrm[:, None, :]
        thresh = cand_sims / (alpha * alpha)
    else:
        pair = g
        thresh = torch.where(cand_sims >= 0.0, cand_sims * alpha,
                             cand_sims / alpha)
    b, c = cand_ids.shape
    sel = torch.zeros((b, c), dtype=torch.bool, device=cand_ids.device)
    cnt = torch.zeros((b,), dtype=torch.int64, device=cand_ids.device)
    for t in range(c):
        occ = torch.any(sel & (pair[:, t, :] > thresh[:, t:t + 1]), dim=1)
        take = (cand_ids[:, t] >= 0) & ~occ & (cnt < r)
        sel[:, t] = take
        cnt += take
    pos = torch.cumsum(sel.to(torch.int64), dim=1) - 1
    out = torch.full((b, r + 1), -1, dtype=torch.int32,
                     device=cand_ids.device)
    out.scatter_(1, torch.where(sel, pos, torch.full_like(pos, r)),
                 torch.where(sel, cand_ids, torch.full_like(cand_ids, -1)))
    return out[:, :r]


def _reverse_fill(neigh: np.ndarray, src_rows: np.ndarray | None = None):
    """Mirror forward edges (i→j) into j's free adjacency slots, in place.

    Edges sort by destination; each destination accepts reverse edges up
    to its free degree in source order. ``src_rows`` restricts the
    mirrored edges to those sources (the extend path). A mirrored edge may
    duplicate a forward edge; the walk's visited set drops the second."""
    n, r = neigh.shape
    deg = (neigh >= 0).sum(1)
    if src_rows is None:
        src = np.repeat(np.arange(n, dtype=np.int32), r)
        dst = neigh.reshape(-1)
    else:
        src = np.repeat(np.asarray(src_rows, np.int32), r)
        dst = neigh[src_rows].reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    order = np.argsort(dst, kind="stable")
    dsts, srcs = dst[order], src[order]
    rank = np.arange(dsts.size) - np.searchsorted(dsts, dsts, side="left")
    keep = rank < (r - deg[dsts])
    neigh[dsts[keep], deg[dsts[keep]] + rank[keep]] = srcs[keep]


def _entry_points(vectors: torch.Tensor, metric: str,
                  n_entry: int = GRAPH_ENTRY_POINTS) -> np.ndarray:
    """Medoid (the row most similar to the column mean) + strided seeds."""
    n = int(vectors.shape[0])
    mu = torch.mean(vectors, dim=0)
    g = _sims(vectors, mu[None, :], metric)[:, 0]
    pts = ((np.arange(n_entry, dtype=np.int64) * n) // n_entry).astype(
        np.int32)
    pts[0] = int(torch.argmax(g))
    return pts


def build(vectors: torch.Tensor, degree: int = DEFAULT_DEGREE, *,
          alpha: float = DEFAULT_ALPHA, metric: str = "dot") -> GraphIndex:
    """Offline graph build from a sealed column, on the column's device
    (module doc). ``degree`` legalizes onto ``DEGREE_GRID``."""
    r = legal_degree(degree)
    n = int(vectors.shape[0])
    dev = vectors.device
    c = min(BUILD_CANDIDATE_MULT * r, max(1, n - 1))
    # forward edges fill HALF the degree; the rest is left to the reverse
    # fill, without which the kNN digraph collapses into islands
    r_fwd = max(1, r // 2)
    neigh = np.full((n, r), -1, np.int32)
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
    for lo in range(0, n, _KNN_CHUNK):
        hi = min(lo + _KNN_CHUNK, n)
        ids, sims = _chunk_topk(vectors, vectors[lo:hi], lo, c=c,
                                metric=metric)
        for plo in range(0, hi - lo, _PRUNE_CHUNK):
            phi = min(plo + _PRUNE_CHUNK, hi - lo)
            cand_vecs = vectors[torch.clamp(ids[plo:phi], 0, n - 1).long()]
            neigh[lo + plo:lo + phi, :r_fwd] = _prune_chunk(
                ids[plo:phi], sims[plo:phi], cand_vecs, alpha_t, r=r_fwd,
                metric=metric).cpu().numpy()
    _reverse_fill(neigh)
    entries = _entry_points(vectors, metric)
    _repair_reachability(neigh, vectors, entries, metric)
    return GraphIndex(neighbors=torch.as_tensor(neigh, device=dev),
                      entry_points=torch.as_tensor(entries, device=dev),
                      metric=metric)


def _donor_search(vec: torch.Tensor, un: np.ndarray, rs: np.ndarray,
                  metric: str, chunk: int = 1024):
    """For each unreached row: its best similarity to any reachable row and
    its ``_DONORS`` most similar reachable rows (positions into ``rs``,
    best first), by blocked GEMMs on the vectors' device.
    -> (best (|un|,) numpy, donors (|un|, ≤_DONORS) numpy)."""
    dev = vec.device
    vr = vec[torch.as_tensor(rs, device=dev).long()]
    nd = min(_DONORS, len(rs))
    best, donors = [], []
    for lo in range(0, len(un), chunk):
        vu = vec[torch.as_tensor(un[lo:lo + chunk], device=dev).long()]
        top_s, top_i = _topk_row_order(_sims(vu, vr, metric), nd)
        best.append(top_s[:, 0].cpu().numpy())
        donors.append(top_i.cpu().numpy())
    return np.concatenate(best), np.concatenate(donors)


def _repair_reachability(neigh: np.ndarray, vec: torch.Tensor,
                         entries: np.ndarray, metric: str,
                         links_per_round: int = 32,
                         max_rounds: int = 64) -> None:
    """Make every row reachable from the entry points, in place.

    Directed BFS from the entries; for the nearest unreached rows splice
    one edge reachable→unreached (evicting the donor's most redundantly
    referenced slot), re-flood, repeat. Each spliced edge floods the
    target's whole local component on the next BFS, so rounds track the
    number of islands, not rows."""
    n, r = neigh.shape
    seed = np.zeros(n, bool)
    seed[np.asarray(entries)] = True

    def flood():
        reach = seed.copy()
        frontier = np.where(reach)[0]
        while frontier.size:
            nxt = neigh[frontier].reshape(-1)
            nxt = np.unique(nxt[nxt >= 0])
            nxt = nxt[~reach[nxt]]
            reach[nxt] = True
            frontier = nxt
        return reach

    forced = np.zeros((n, r), bool)  # spliced edges are never evicted
    indeg = np.bincount(neigh[neigh >= 0], minlength=n)
    stall = 0
    prev_un = n + 1
    for _ in range(max_rounds):
        # full re-flood every round: an eviction can disconnect rows
        # counted reachable in an earlier round
        reach = flood()
        un = np.where(~reach)[0]
        if un.size == 0:
            return
        stall = stall + 1 if un.size >= prev_un else 0
        if stall >= 3:
            return
        prev_un = un.size
        rs = np.where(reach)[0]
        best_sim, donors = _donor_search(vec, un, rs, metric)
        take = np.argsort(-best_sim, kind="stable")[
            :max(links_per_round, n // 256)]
        for t in take:
            u = int(un[t])
            # donors in similarity order — fall past any donor whose every
            # slot already holds a forced splice
            for d in donors[t]:
                v = int(rs[d])
                free = np.where(neigh[v] < 0)[0]
                if free.size:
                    slot = int(free[0])
                else:
                    # evict the edge whose target is most redundantly
                    # referenced elsewhere
                    cand = np.where(~forced[v])[0]
                    if cand.size == 0:
                        continue
                    slot = int(cand[int(np.argmax(indeg[neigh[v, cand]]))])
                    indeg[neigh[v, slot]] -= 1
                neigh[v, slot] = u
                forced[v, slot] = True
                indeg[u] += 1
                break


def extend(index: GraphIndex, vectors: torch.Tensor,
           first_new_row: int) -> GraphIndex:
    """Append rows ``vectors[first_new_row:]`` (``vectors`` is the FULL
    post-append column): exact top-R forward edges for the new rows, a
    reverse fill of their edges into free slots, then the reachability
    repair."""
    n = int(vectors.shape[0])
    r = index.degree
    if first_new_row != index.n_rows:
        raise ValueError(f"first_new_row={first_new_row}, graph has "
                         f"{index.n_rows} rows")
    c = min(r, max(1, n - 1))
    lists = []
    for lo in range(first_new_row, n, _KNN_CHUNK):
        hi = min(lo + _KNN_CHUNK, n)
        ids, _ = _chunk_topk(vectors, vectors[lo:hi], lo, c=c,
                             metric=index.metric)
        lists.append(ids.cpu().numpy())
    new = np.full((n - first_new_row, r), -1, np.int32)
    if lists:
        got = np.concatenate(lists)
        new[:, :got.shape[1]] = got
    neigh = np.concatenate([index.neighbors.cpu().numpy(), new])
    _reverse_fill(neigh, np.arange(first_new_row, n, dtype=np.int32))
    _repair_reachability(neigh, vectors, index.entry_points.cpu().numpy(),
                         index.metric)
    return GraphIndex(neighbors=torch.as_tensor(neigh, device=vectors.device),
                      entry_points=index.entry_points, metric=index.metric)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def search_local_batch(index: GraphIndex, vectors: torch.Tensor,
                       scalars: torch.Tensor, pred_b: PredicateLike,
                       q_b: torch.Tensor, *, beam_width: int, n_hops: int,
                       k: int):
    """Candidate-local batched graph search, the contract of
    ``ivf.search_local_batch``: (ids (B, k), scores (B, k), n_scored (B,),
    n_qualified (B,)), ties by smaller row id, -1/NEG empty slots.
    ``n_scored`` counts visited rows (the walk's scan budget)."""
    from repro_torch.kernels.beam_search import beam_search_topk

    return beam_search_topk(
        index.neighbors, index.entry_points, vectors, scalars, pred_b, q_b,
        k=k, beam_width=beam_width, n_hops=n_hops, metric=index.metric)


def search(index: GraphIndex, vectors: torch.Tensor, scalars: torch.Tensor,
           pred: PredicateLike, q: torch.Tensor, *, beam_width: int,
           n_hops: int, k: int):
    """Single-query wrapper mirroring ``ivf.search``:
    (ids (k,), scores (k,), n_scored (), n_qualified ())."""
    ids, scores, n_scored, n_qual = search_local_batch(
        index, vectors, scalars, stack([pred]), q[None], k=k,
        beam_width=beam_width, n_hops=n_hops)
    return ids[0], scores[0], n_scored[0], n_qual[0]
