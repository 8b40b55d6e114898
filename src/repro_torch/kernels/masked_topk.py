"""Full-table filtered scan kernel: score ⊙ conjunctive mask → block top-k.

Port of ``repro.kernels.masked_topk``. ``masked_topk_blocks`` launches the
CUDA kernel of ``csrc/masked_topk.cu`` on fp32 rows (dot or l2); the same
source's int8 instantiation is launched by ``int8_scan.int8_topk_blocks``.
``ops.masked_topk`` / ``ops.int8_masked_topk`` merge the blocks. Unlike the
JAX wrapper, the table is never padded to a block multiple: the kernel
masks the rows past ``n_rows`` itself. Only CUDA tensors are taken here —
the CPU path of the entry points is ``ref.masked_topk_ref``.
``LAUNCHES`` counts the kernel launches per variant.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.shapes import MAX_SCALARS, SCAN_BLOCK_ROWS

# kernel launches per variant ("fp32": masked_topk, "int8": int8_scan); a
# run resets it with reset_launches() and reads it afterwards
LAUNCHES = {"fp32": 0, "int8": 0}

MAX_SLOTS = 1024  # the kernel's sort width: block_rows and k at most this
# the query the kernel stages in shared memory (kMaxQueryFloats floats in
# csrc/masked_topk.cu): 32 KB, under the default 48 KB
MAX_QUERY_SMEM = 32 * 1024
MAX_DIM = MAX_QUERY_SMEM // 4  # widest row the kernel stages the query for


def query_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one launch: the query as f32
    (``masked_topk_launch``'s ``smem``)."""
    return 4 * d


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signature declared (built on the
    first launch, never at import)."""
    from repro_torch.kernels import build

    lib = build.load("masked_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_topk_launch.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i,
                                       i, i, p, p, p]
    lib.masked_topk_launch.restype = i
    return lib


def launch_blocks(q, vectors, scales, scalars, lo, hi, active, n_rows: int,
                  *, k: int, block_rows: int, metric: str):
    """Launch the scan kernel on the current stream. ``scales`` None: fp32
    rows; else ``vectors`` are int8 rows with (n,) f32 dequant scales (dot
    metric only). -> (block_scores (nb, k) f32, block_ids (nb, k) i32),
    nb = ceil(n / block_rows) over the n rows of ``vectors``."""
    from repro_torch.kernels.gather_score import _check

    dev = vectors.device
    if dev.type != "cuda":
        raise ValueError(f"the scan kernel needs CUDA tensors, got {dev}")
    n, d = vectors.shape
    m = scalars.shape[1]
    int8 = scales is not None
    if not 1 <= block_rows <= MAX_SLOTS or not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"block_rows={block_rows} and k={k} must lie in "
                         f"[1, {MAX_SLOTS}]")
    if m > MAX_SCALARS or d < 1 or query_smem_bytes(d) > MAX_QUERY_SMEM:
        raise ValueError(f"M={m} > {MAX_SCALARS} or d={d} outside "
                         f"[1, {MAX_DIM}]")
    if metric not in ("dot", "l2") or (int8 and metric != "dot"):
        raise ValueError(f"metric {metric!r} is not taken for "
                         f"{'int8' if int8 else 'fp32'} rows")
    if not 1 <= n_rows <= n:
        raise ValueError(f"n_rows={n_rows} outside [1, {n}]")
    _check(vectors, "vectors", torch.int8 if int8 else torch.float32, (n, d),
           dev)
    _check(q, "q", torch.float32, (d,), dev)
    _check(scalars, "scalars", torch.float32, (n, m), dev)
    for name, f in (("lo", lo), ("hi", hi), ("active", active)):
        _check(f, name, torch.float32, (m,), dev)
    if int8:
        _check(scales, "scales", torch.float32, (n,), dev)
    nb = -(-n // block_rows)
    out_s = torch.empty((nb, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nb, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().masked_topk_launch(
        int(int8), int(metric == "l2"), q.data_ptr(), vectors.data_ptr(),
        scales.data_ptr() if int8 else None, scalars.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), active.data_ptr(), n_rows, nb, d, m,
        block_rows, k, out_s.data_ptr(), out_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"masked_topk kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["int8" if int8 else "fp32"] += 1
    return out_s, out_i


def masked_topk_blocks(q, vectors, scalars, lo, hi, active, n_rows: int, *,
                       k: int, block_rows: int = SCAN_BLOCK_ROWS,
                       metric: str = "dot"):
    """fp32 rows: -> (block_scores (nb, k), block_ids (nb, k)); each block's
    pairs by score descending, then id ascending; (NEG, -1) empty slots."""
    return launch_blocks(q, vectors, None, scalars, lo, hi, active, n_rows,
                         k=k, block_rows=block_rows, metric=metric)
