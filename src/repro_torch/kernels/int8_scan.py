"""int8-quantized filtered scan.

Port of ``repro.kernels.int8_scan``. ``quantize_rows`` is the per-row
absmax quantizer (plain tensor code on the JAX side too);
``int8_topk_blocks`` launches the ``int8_t`` instantiation of
``csrc/masked_topk.cu`` on CUDA tensors: each row scores
``scale · (q · v_int8)`` (dot metric only), then the conjunctive mask and
the block top-k run as in ``masked_topk``. Its launches count under
``masked_topk.LAUNCHES["int8"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.masked_topk import launch_blocks
from repro_torch.kernels.shapes import SCAN_BLOCK_ROWS


def quantize_rows(vectors: torch.Tensor):
    """(n, d) f32 -> ((n, d) int8, (n,) f32 per-row scale)."""
    scale = torch.clamp(vectors.abs().amax(dim=1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(vectors / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def int8_topk_blocks(q, vec_i8, scales, scalars, lo, hi, active,
                     n_rows: int, *, k: int,
                     block_rows: int = SCAN_BLOCK_ROWS):
    """-> (block_scores (nb, k), block_ids (nb, k)), as
    ``masked_topk.masked_topk_blocks`` on the dequantized rows."""
    return launch_blocks(q, vec_i8, scales, scalars, lo, hi, active, n_rows,
                         k=k, block_rows=block_rows, metric="dot")
