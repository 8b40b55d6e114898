"""Fused candidate-local gather+score: the executor hot path past the
dense-GEMM crossover.

Port of ``repro.kernels.gather_score``. Given a ``(B, S)`` int32 candidate
matrix (-1 = padding, duplicates allowed), the kernel gathers each slot's
rows of every weighted vector column and the scalar row, scores
Σ_i w_i·sim(q_i, v_i) (l2 keeps the -‖v‖²-‖q‖² terms so score values match
``table.similarity``), applies the DNF mask and keeps a per-block top-k of
distinct row ids. ``merge_topk_unique`` merges the blocks here in torch,
as the JAX package merges outside its Pallas kernel: dedup by id, then
(-score, id) order, so ties break by the smaller row id.

``gather_score_topk`` is the entry point. A CPU tensor takes the plain
version (``ref.gather_score_ref``); a CUDA tensor launches the CUDA kernel
(``csrc/gather_score.cu``) or raises — there is no fallback.
``LAUNCHES`` counts the kernel launches per variant; a thread inside
``counted_as(counts)`` counts its launches into ``counts`` instead (the
tiered table's compaction thread keeps its warm-up launches apart this
way).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from repro_torch.kernels.shapes import (
    GATHER_BLOCK_S, ID_SENTINEL, MAX_SCALARS, MAX_TOPK, MAX_VEC_COLS, NEG,
)

# kernel launches per variant ("fp32": kernel 1, "int8": kernel 2); a run
# resets it with reset_launches() and reads it afterwards. Two host threads
# launch (serving and compaction), so every increment takes the lock.
LAUNCHES = {"fp32": 0, "int8": 0}
# launches made inside ``counted_as(PREWARM_LAUNCHES)``: the serving passes
# compaction runs on its own thread before an epoch publish
PREWARM_LAUNCHES = {"fp32": 0, "int8": 0}
_count_lock = threading.Lock()
_scope = threading.local()


def reset_launches() -> None:
    with _count_lock:
        for counts in (LAUNCHES, PREWARM_LAUNCHES):
            for key in counts:
                counts[key] = 0


@contextlib.contextmanager
def counted_as(counts: dict):
    """Count the calling thread's launches into ``counts`` (a dict with the
    keys of ``LAUNCHES``) instead of ``LAUNCHES`` while the block runs."""
    prev = getattr(_scope, "counts", None)
    _scope.counts = counts
    try:
        yield counts
    finally:
        _scope.counts = prev


def _count_launch(variant: str) -> None:
    with _count_lock:
        counts = getattr(_scope, "counts", None)
        (LAUNCHES if counts is None else counts)[variant] += 1


def _pred_fields(pred, b: int, m: int, device):
    """Dense (B, C, M) lo/hi/active + (B, C) clause_valid f32 fields from a
    batched predicate; ``None`` gives one always-passing clause."""
    if pred is None:
        return (torch.full((b, 1, m), -float("inf"), device=device),
                torch.full((b, 1, m), float("inf"), device=device),
                torch.zeros((b, 1, m), device=device),
                torch.ones((b, 1), device=device))
    from repro_torch.vectordb.predicates import as_set

    ps = as_set(pred)
    return (ps.lo.to(torch.float32), ps.hi.to(torch.float32),
            ps.active.to(torch.float32), ps.clause_valid.to(torch.float32))


def merge_topk_unique(ids: torch.Tensor, scores: torch.Tensor, k: int):
    """(B, P) candidate pools -> (B, k) top-k with duplicate row ids
    suppressed and ties broken by smaller row id.

    Padded slots carry id -1 / score NEG. Duplicate ids score identically
    (same row, same arithmetic), so keeping the first occurrence is exact.
    """
    ids = ids.to(torch.int32)
    order = torch.argsort(ids, dim=1, stable=True)
    sc = ids.gather(1, order)
    first = torch.cat([torch.ones_like(sc[:, :1], dtype=torch.bool),
                       sc[:, 1:] != sc[:, :-1]], dim=1)
    keep = torch.zeros_like(first).scatter(1, order, first) & (ids >= 0)
    s2 = torch.where(keep, scores, torch.full_like(scores, NEG))
    key = torch.where(ids >= 0, ids, torch.full_like(ids, ID_SENTINEL))
    # lexsort by (-score, id): stable sort on the secondary key first
    o1 = torch.argsort(key, dim=1, stable=True)
    o2 = torch.argsort(-s2.gather(1, o1), dim=1, stable=True)
    sel = o1.gather(1, o2)[:, :k]
    top = s2.gather(1, sel)
    out_ids = torch.where(top > NEG / 2, ids.gather(1, sel),
                          torch.full_like(sel, -1, dtype=torch.int32))
    return out_ids.to(torch.int32), top


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signature declared (built on the
    first launch, never at import)."""
    from repro_torch.kernels import build

    lib = build.load("gather_score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gather_score_launch.argtypes = [
        i, i, p, i, i, i, i, p, p, p, p, p, p, i, p, p, p, p, i, i, i, i,
        p, p, p, p]
    lib.gather_score_launch.restype = i
    return lib


# the most dynamic shared memory a launch may ask (gather_score_launch
# refuses more; past 32 KB the launcher opts the kernel in to it)
QUERY_SMEM_MAX = 48 * 1024


def query_smem_bytes(dims) -> int:
    """Dynamic shared memory of one launch: every column's query as f32,
    each padded to 16 bytes (``qoff`` in ``csrc/gather_score.cu``)."""
    return max(sum((d + 3) // 4 * 4 for d in dims), 4) * 4


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gather_score_blocks(cand, vectors, qs, weights, scalars, lo, hi, active,
                        clause_valid, scales=None, *, k: int, block_s: int,
                        metric: str = "dot", apply_pred: bool = True):
    """Launch the CUDA kernel on the current stream.
    -> (block_scores (B, nb, k) f32, block_ids (B, nb, k) i32,
    block_qual (B, nb) i32); ``S`` must be a multiple of ``block_s``."""
    dev = cand.device
    if dev.type != "cuda":
        raise ValueError(f"gather_score_blocks needs CUDA tensors, got {dev}")
    b, s_tot = cand.shape
    n, m = scalars.shape
    n_vec = len(vectors)
    c = lo.shape[1]
    int8 = scales is not None
    if s_tot % block_s or not 1 <= block_s <= GATHER_BLOCK_S:
        raise ValueError(f"S={s_tot} is not a multiple of block_s={block_s} "
                         f"in [1, {GATHER_BLOCK_S}]")
    if not 0 <= n_vec <= MAX_VEC_COLS or len(qs) != n_vec:
        raise ValueError(f"{n_vec} vector columns, kernel takes at most "
                         f"{MAX_VEC_COLS} with one query each")
    if m > MAX_SCALARS or c > 4 or k < 1:
        raise ValueError(f"M={m} > {MAX_SCALARS}, C={c} > 4 or k={k} < 1")
    if metric not in ("dot", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    _check(cand, "cand", torch.int32, (b, s_tot), dev)
    _check(scalars, "scalars", torch.float32, (n, m), dev)
    _check(weights, "weights", torch.float32, (b, n_vec), dev)
    for name, f in (("lo", lo), ("hi", hi), ("active", active)):
        _check(f, name, torch.float32, (b, c, m), dev)
    _check(clause_valid, "clause_valid", torch.float32, (b, c), dev)
    elem = torch.int8 if int8 else torch.float32
    dims = []
    for i, (v, q) in enumerate(zip(vectors, qs)):
        _check(v, f"vectors[{i}]", elem, (n, v.shape[1]), dev)
        _check(q, f"qs[{i}]", torch.float32, (b, v.shape[1]), dev)
        dims.append(int(v.shape[1]))
        if int8:
            _check(scales[i], f"scales[{i}]", torch.float32, (n,), dev)
    if query_smem_bytes(dims) > QUERY_SMEM_MAX:
        raise ValueError(f"query widths {dims} exceed the kernel's shared "
                         f"memory")
    nb = s_tot // block_s
    out_s = torch.empty((b, nb, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, nb, k), dtype=torch.int32, device=dev)
    out_q = torch.empty((b, nb), dtype=torch.int32, device=dev)
    ptrs = ctypes.c_void_p * n_vec
    vec_p = ptrs(*[v.data_ptr() for v in vectors])
    scale_p = ptrs(*([s.data_ptr() for s in scales] if int8
                     else [None] * n_vec))
    q_p = ptrs(*[q.data_ptr() for q in qs])
    dims_c = (ctypes.c_int * n_vec)(*dims)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().gather_score_launch(
        int(int8), int(metric == "l2"), cand.data_ptr(), b, s_tot, n, n_vec,
        vec_p, scale_p, q_p, dims_c, weights.data_ptr(), scalars.data_ptr(),
        m, lo.data_ptr(), hi.data_ptr(), active.data_ptr(),
        clause_valid.data_ptr(), c, int(apply_pred), block_s, k,
        out_s.data_ptr(), out_i.data_ptr(), out_q.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gather_score kernel launch failed: CUDA error "
                           f"{rc}")
    _count_launch("int8" if int8 else "fp32")
    return out_s, out_i, out_q


# ---------------------------------------------------------------------------
# public entry — kernel for CUDA tensors, plain version for CPU tensors
# ---------------------------------------------------------------------------

def gather_score_topk(cand, vectors, qs, weights, scalars, pred=None, *,
                      k: int, metric: str = "dot",
                      block_s: int = GATHER_BLOCK_S, scales=None):
    """Fused candidate-local filtered top-k for a query batch.

    cand:    (B, S) int32 candidate row ids, -1 = padded/empty slot.
    vectors: tuple of (n, d_i) table columns; qs: tuple of (B, d_i) queries;
    weights: (B, n_vec) per-column weights; scalars: (n, M).
    pred:    batched predicate (leading axis B) or None to skip masking.
    scales:  tuple of (n,) f32 per-row dequant scales — ``vectors`` are
             then the int8 replicas (the quantized tier; the DNF mask still
             reads the exact fp32 scalars).

    -> (ids (B, k) int32, scores (B, k), n_qualified (B,)). Empty slots
    carry id -1 / score NEG; ties break by smaller row id."""
    b = cand.shape[0]
    apply_pred = pred is not None
    lo, hi, act, cval = _pred_fields(pred, b, scalars.shape[1], cand.device)
    if cand.device.type == "cpu":
        from repro_torch.kernels.ref import gather_score_ref

        return gather_score_ref(cand, vectors, qs, weights, scalars,
                                lo, hi, act, cval, k=k, metric=metric,
                                apply_pred=apply_pred, scales=scales)
    return kernel_route(cand, vectors, qs, weights, scalars, lo, hi, act,
                        cval, k=k, metric=metric, block_s=block_s,
                        scales=scales, apply_pred=apply_pred)


def kernel_route(cand, vectors, qs, weights, scalars, lo, hi, act, cval, *,
                 k: int, metric: str, block_s: int, scales, apply_pred: bool,
                 blocks=gather_score_blocks):
    """``gather_score_topk``'s CUDA route past the predicate fields: pad
    the slots to whole blocks, launch ``blocks`` (the kernel; the static
    checks pass a plain stand-in to run this host code on the CPU), merge
    the blocks."""
    b, s_tot = cand.shape
    # the block/padding rule of the JAX entry point
    bs = min(block_s, _next_pow2(max(s_tot, k, 8)))
    pad = (-s_tot) % bs
    if s_tot + pad < k:  # the merge pool (nb·k) must hold at least k slots
        pad += ((k - (s_tot + pad)) + bs - 1) // bs * bs
    cand = cand.to(torch.int32)
    if pad:
        cand = torch.cat([cand, torch.full((b, pad), -1, dtype=torch.int32,
                                           device=cand.device)], dim=1)
    out_s, out_i, out_q = blocks(
        cand.contiguous(), tuple(v.contiguous() for v in vectors),
        tuple(q.to(torch.float32).contiguous() for q in qs),
        weights.to(torch.float32).contiguous(), scalars.contiguous(),
        lo.contiguous(), hi.contiguous(), act.contiguous(), cval.contiguous(),
        None if scales is None else tuple(s.to(torch.float32).contiguous()
                                          for s in scales),
        k=k, block_s=bs, metric=metric, apply_pred=apply_pred)
    nb = cand.shape[1] // bs
    ids, scores = merge_topk_unique(out_i.reshape(b, nb * k),
                                    out_s.reshape(b, nb * k), k)
    return ids, scores, out_q.sum(dim=1)


# α of the two-stage quantized scan: the int8 pass keeps α·k candidates for
# the exact fp32 rerank (capped at MAX_TOPK).
RERANK_MULT = 4


def gather_score_topk_int8(cand, vectors, vectors_i8, scales, qs, weights,
                           scalars, pred=None, *, k: int,
                           metric: str = "dot",
                           rerank_mult: int = RERANK_MULT,
                           block_s: int = GATHER_BLOCK_S):
    """Two-stage quantized candidate-local top-k: the int8 stage keeps the
    top ``max(k, min(rerank_mult·k, MAX_TOPK))`` predicate-qualified
    candidates, then the fp32 stage reranks exactly those rows, so returned
    scores are exact fp32. ``n_qualified`` counts the original candidate
    list's qualifying slots (stage-1 semantics)."""
    kq = max(k, min(rerank_mult * k, MAX_TOPK))
    ids_q, _, n_qual = gather_score_topk(
        cand, vectors_i8, qs, weights, scalars, pred, k=kq, metric=metric,
        block_s=block_s, scales=scales)
    ids, scores, _ = gather_score_topk(
        ids_q, vectors, qs, weights, scalars, None, k=k, metric=metric,
        block_s=block_s)
    return ids, scores, n_qual


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p
