"""Microbatched pipeline parallelism over a mesh axis (GPipe-style).

Port of ``repro.distributed.pipeline``. The production mesh has no
dedicated pipeline axis; PP is an option for meshes that have one. Stages
lie along ``axis``; the schedule is the reference's fill-drain loop, run
by every rank of the axis on its own stage (``local_map`` standing for the
reference's ``shard_map``): at tick t stage 0 injects microbatch t, every
stage applies its block to what it holds while the tick is in its window
(t - stage in [0, M)), the last stage keeps its finished microbatch, and
each stage hands its output to stage (stage + 1) mod S
(``dist.batch_isend_irecv``, the reference's ``ppermute``). The outputs
end on every stage through an ``all_reduce`` over the axis of the last
stage's (the reference's ``psum`` of a masked copy). Bubble fraction =
(S-1)/(M+S-1) for S stages and M microbatches (``bubble()``).

The hand-off sends CUDA tensors directly where the axis's process group
can (NCCL); ``gloo`` has no GPU send or receive, so over ``gloo`` (ranks
sharing one card) each tick's activations go through the host: copied to
the host, sent, received and copied back. ``fn.handoff`` names the path
the last call took (``"device"`` or ``"host"``). The reference runs the
stage on every tick, masking the inactive ones; the port skips a stage's
product outside its window, which changes no output.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.common.mesh import mesh_line


def bubble(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _shift(y: torch.Tensor, prev: int, nxt: int, group, host: bool
           ) -> torch.Tensor:
    """Send ``y`` to global rank ``nxt`` and receive the same shape from
    ``prev``, through the host where ``host``."""
    src = y.cpu() if host else y.contiguous()
    buf = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, nxt, group),
        dist.P2POp(dist.irecv, buf, prev, group)])
    for r in reqs:
        r.wait()
    return buf.to(y.device) if host else buf


def pipeline_apply(mesh, axis: str, stage_fn, n_microbatches: int):
    """Build ``fn(stage_params, x)`` running a stage-partitioned pipeline.

    ``stage_params``: a dict of DTensors on ``mesh``, each with a leading
    stage dim sharded over ``axis`` (``Shard(0)``); ``x``:
    (n_microbatches, mb, ...), the same on every rank (a plain tensor or a
    replicated DTensor), the microbatches entering stage 0.
    ``stage_fn(params, mb) -> mb`` is one stage's block. Returns the LAST
    stage's outputs (n_microbatches, mb, ...), a replicated DTensor.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    d = mesh.mesh_dim_names.index(axis)
    group = mesh.get_group(axis)

    def local(names, x, *leaves):
        params = {k: v[0] for k, v in zip(names, leaves)}
        stage = mesh.get_coordinate()[d]
        line = mesh_line(mesh, d)
        nxt, prev = line[(stage + 1) % n_stages], line[(stage - 1) % n_stages]
        host = x.is_cuda and dist.get_backend(group) != "nccl"
        fn.handoff = "host" if host else "device"
        inflight = torch.zeros_like(x[0])
        outs = torch.zeros_like(x)
        for t in range(n_microbatches + n_stages - 1):
            active = 0 <= t - stage < n_microbatches
            cur = x[min(t, n_microbatches - 1)] if stage == 0 else inflight
            y = stage_fn(params, cur) if active else torch.zeros_like(cur)
            if stage == n_stages - 1 and active:
                outs[t - (n_stages - 1)] = y
            inflight = _shift(y, prev, nxt, group, host)
        if stage != n_stages - 1:
            outs.zero_()
        dist.all_reduce(outs, group=group)
        return outs

    def fn(stage_params: dict, x):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        names = list(stage_params)
        leaves = [stage_params[k] for k in names]
        whole = [Replicate()] * mesh.ndim
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, whole, run_check=False)
        staged = [Shard(0) if i == d else Replicate()
                  for i in range(mesh.ndim)]
        return local_map(
            lambda x_, *ls: local(names, x_, *ls), out_placements=whole,
            in_placements=(whole, *([staged] * len(leaves))),
            device_mesh=mesh, redistribute_inputs=True)(x, *leaves)

    fn.handoff = None
    return fn
