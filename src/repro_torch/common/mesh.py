"""Shards of a ``torch.distributed`` ``DeviceMesh``: which shard a rank
holds over the mesh's data dimensions, which rows of a table that is, and
the gather of every shard's part in shard order, and a differentiable sum
over a group. Shared by the sharded vector search
(``repro_torch.vectordb.distributed``), the expert-parallel MoE
(``repro_torch.models.moe_sharded``) and the mesh LM
(``repro_torch.models.sharding``).
"""
from __future__ import annotations

import torch


def _axes(data_axes) -> tuple:
    return data_axes if isinstance(data_axes, tuple) else (data_axes,)


def mesh_shard(mesh, data_axes=("data",)) -> tuple:
    """(shard count, this rank's shard) of a ``DeviceMesh`` over its data
    dimensions: the product of their sizes, and the rank's row-major
    coordinate over them (the order of the reference's tiled
    ``all_gather`` over several axes)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a mesh is a torch.distributed DeviceMesh, not "
                        f"{type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    missing = [a for a in _axes(data_axes) if a not in names]
    if missing:
        raise ValueError(f"the mesh's dimensions {names} lack {missing}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    count, shard = 1, 0
    for a in _axes(data_axes):
        d = names.index(a)
        count *= mesh.size(d)
        shard = shard * mesh.size(d) + coord[d]
    return count, shard


def shard_rows(n: int, mesh, data_axes=("data",)) -> tuple:
    """Rows ``[row0, row1)`` of an ``n``-row table that this rank holds:
    shard ``r`` of S holds ``[r·n/S, (r+1)·n/S)``. As in the reference,
    ``n`` must divide over the shards."""
    count, shard = mesh_shard(mesh, data_axes)
    if n % count:
        raise ValueError(f"table rows {n} not divisible over {count} mesh "
                         f"shards")
    per = n // count
    return shard * per, (shard + 1) * per


def mesh_line(mesh, d: int) -> list:
    """Global ranks along mesh dimension ``d`` through this rank, in
    coordinate order."""
    idx = list(mesh.get_coordinate())
    idx[d] = slice(None)
    return mesh.mesh[tuple(idx)].tolist()


def gather_shards(x: torch.Tensor, mesh, data_axes=("data",), *,
                  dim: int = 0) -> torch.Tensor:
    """Every shard's ``x`` concatenated along ``dim`` in shard order: one
    ``all_gather`` along each data dimension, the last first, each
    gathered part placed by its rank's coordinate."""
    import torch.distributed as dist

    x = x.contiguous()
    names = mesh.mesh_dim_names
    for a in reversed(_axes(data_axes)):
        d = names.index(a)
        group = mesh.get_group(d)
        parts = [torch.empty_like(x) for _ in range(mesh.size(d))]
        dist.all_gather(parts, x, group=group)
        x = torch.cat([parts[dist.get_group_rank(group, g)]
                       for g in mesh_line(mesh, d)], dim=dim)
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        import torch.distributed as dist

        ctx.group = group
        y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(y: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``y`` over a process group, differentiable: its backward
    sums the gradient over the group too (``psum``'s transpose). Over one
    rank, ``y`` itself."""
    import torch.distributed as dist

    if dist.get_world_size(group) == 1:
        return y
    return _PSum.apply(y, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((x.shape[0] * dist.get_world_size(group),
                           *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return scatter_rows(g, ctx.group), None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // dist.get_world_size(group),
                           *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g, ctx.group), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ranks' ``x`` concatenated along dim 0 in group-rank
    order (``all_gather``), differentiable: the backward sums the
    gradient over the group and scatters its rows back (``scatter_rows``,
    the reference's ``all_gather`` transpose)."""
    return _GatherRows.apply(x, group)


def scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's ranks' ``x``, this rank's share of its rows
    in group-rank order (``reduce_scatter``), differentiable: the backward
    gathers the gradient (``gather_rows``)."""
    return _ScatterRows.apply(x, group)
