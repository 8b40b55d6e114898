"""Full-table filtered scans: block kernel dispatch and the cross-block merge.

Port of ``repro.kernels.ops``. A CPU tensor takes the plain version
(``ref.masked_topk_ref`` / ``ref.int8_topk_ref``, an exact top-k); a CUDA
tensor launches the scan kernel (``csrc/masked_topk.cu``) or raises — there
is no fallback. The JAX wrapper pads the whole table to a block multiple on
every call; here the kernel bounds-checks the last block instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.int8_scan import int8_topk_blocks
from repro_torch.kernels.masked_topk import masked_topk_blocks
from repro_torch.kernels.shapes import NEG, SCAN_BLOCK_ROWS
from repro_torch.vectordb.flat import topk_stable


def _merge(block_s, block_i, k: int):
    """Cross-block merge of per-block top-k pools: a stable descending
    selection (equal scores keep the lower pool position, i.e. the lower
    block and then the lower id, as ``lax.top_k`` does). -> (scores (k,),
    ids (k,), valid (k,) bool); invalid slots carry score NEG / id -1."""
    top_s, pos = topk_stable(block_s.reshape(-1), k)
    ids = block_i.reshape(-1)[pos]
    valid = (top_s > NEG / 2) & (ids >= 0)
    return (torch.where(valid, top_s, torch.full_like(top_s, NEG)),
            torch.where(valid, ids, torch.full_like(ids, -1)), valid)


def _fields(q, lo, hi, active):
    return (q.to(torch.float32).contiguous(),
            lo.to(torch.float32).contiguous(),
            hi.to(torch.float32).contiguous(),
            active.to(torch.float32).contiguous())


def _plain(scores, ids):
    return scores, ids, ids >= 0


def masked_topk(q, vectors, scalars, lo, hi, active, *, k: int,
                block_rows: int = SCAN_BLOCK_ROWS, metric: str = "dot"):
    """Fused filtered top-k over the whole table under a conjunctive (M,)
    range predicate. -> (scores (k,), ids (k,), valid (k,))."""
    n = vectors.shape[0]
    if vectors.device.type == "cpu":
        from repro_torch.kernels.ref import masked_topk_ref

        return _plain(*masked_topk_ref(q, vectors, scalars, lo, hi, active, n,
                                       k=k, metric=metric))
    q, lo, hi, active = _fields(q, lo, hi, active)
    bs, bi = masked_topk_blocks(
        q, vectors.contiguous(), scalars.contiguous(), lo, hi, active, n,
        k=k, block_rows=min(block_rows, max(8, n)), metric=metric)
    return _merge(bs, bi, k)


def int8_masked_topk(q, vec_i8, scales, scalars, lo, hi, active, *, k: int,
                     block_rows: int = SCAN_BLOCK_ROWS):
    """Quantized fused filtered top-k (dot metric).
    -> (scores (k,), ids (k,), valid (k,))."""
    n = vec_i8.shape[0]
    if vec_i8.device.type == "cpu":
        from repro_torch.kernels.ref import int8_topk_ref

        return _plain(*int8_topk_ref(q, vec_i8, scales, scalars, lo, hi,
                                     active, n, k=k))
    q, lo, hi, active = _fields(q, lo, hi, active)
    bs, bi = int8_topk_blocks(
        q, vec_i8.contiguous(), scales.to(torch.float32).contiguous(),
        scalars.contiguous(), lo, hi, active, n, k=k,
        block_rows=min(block_rows, max(8, n)))
    return _merge(bs, bi, k)
