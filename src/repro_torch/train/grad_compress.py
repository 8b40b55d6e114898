"""Error-feedback gradient compression for data parallelism.

Port of ``repro.train.grad_compress``. Each gradient tensor is compressed
to int8 with a per-tensor scale before the reduction across ranks, and the
quantization error rides in an f32 residual added to the next step's
gradient (error feedback, as in 1-bit Adam / EF-SGD), which keeps SGD
unbiased in the long run.

  * ``compress``/``decompress`` — the quantizer itself.
  * ``compress_tree``/``decompress_tree`` — over a dict of gradients.
  * ``ef_allreduce`` — quantize, ``dist.all_reduce`` the dequantized f32
    over ``group`` (a sum in f32, so no int8 overflow across many ranks),
    then divide by the group's size: the reference's ``psum`` over a mesh
    axis, and its mean.

A tree is a dict (nested or flat) of tensors; the quantized tree holds a
``(q, scale)`` tuple at each leaf.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def compress(x: torch.Tensor) -> tuple:
    """Per-tensor absmax int8 quantization. Returns (q, scale)."""
    x = x.float()
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: dict, residual: dict) -> tuple:
    """Quantize grads + residual; return (quantized tree, new residual)."""
    def one(g, r):
        val = g.float() + r
        q, s = compress(val)
        return (q, s), val - decompress(q, s)

    pairs = _map(one, grads, residual)
    return (_map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs))


def decompress_tree(qtree: dict, dtype=torch.float32) -> dict:
    return _map(lambda leaf: decompress(*leaf, dtype=dtype), qtree)


def ef_allreduce(grads: dict, residual: dict, group=None, *,
                 mean: bool = True) -> tuple:
    """Error-feedback compressed all-reduce over ``group`` (the default
    group unless given). -> (the reduced f32 tree, the new residual)."""
    qtree, new_res = compress_tree(grads, residual)
    size = dist.get_world_size(group)

    def reduce(leaf):
        summed = decompress(*leaf)
        dist.all_reduce(summed, group=group)
        return summed / size if mean else summed

    return _map(reduce, qtree), new_res


def init_residual(grads: dict) -> dict:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)
