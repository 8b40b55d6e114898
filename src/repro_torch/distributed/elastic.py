"""Elastic scaling: reshard a checkpointed train state onto a new mesh.

Port of ``repro.distributed.elastic``. Checkpoints are stored
mesh-agnostic (``checkpoint/ckpt.py`` saves whole arrays), so a scale-up,
scale-down or axis reshape is a restore with new placements
(``ckpt.restore(..., shardings=)``). ``replan`` recomputes each
parameter's spec for the new mesh, checks that every sharded dimension
divides its axes' size there, and reports which axes changed.

The check and the report are the reference's, over the reference's
leaves: the layers of one stack (``blocks.{i}.<path>`` for every i) are
one leaf of shape (layers, ...), visited in the order JAX flattens the
parameter tree (sorted keys), so the first leaf that does not divide
raises the reference's ``ValueError`` text.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as shd


@dataclasses.dataclass
class ReshardReport:
    old_mesh: tuple
    new_mesh: tuple
    n_params: int
    changed_axes: list


def _ref_leaves(cfg: ModelConfig, params, fsdp: bool) -> list:
    """(reference path, reference shape, reference spec) for each of the
    reference's leaves, in JAX's flatten order."""
    specs = shd.param_specs(cfg, params, fsdp=fsdp)
    leaves: dict = {}
    for name, t in shd._named(params).items():
        path = shd.ref_path(name)
        if path in leaves:
            leaves[path][0] += 1
            continue
        stacked = path != name.replace(".", "/")
        leaves[path] = [1, tuple(t.shape), specs[name], stacked]
    out = []
    for path in sorted(leaves, key=lambda p: tuple(p.split("/"))):
        n, shape, spec, stacked = leaves[path]
        if stacked:
            shape, spec = (n, *shape), ((None, *spec) if spec else ())
        out.append((path, shape, spec))
    return out


def replan(cfg: ModelConfig, params_shape, old_mesh, new_mesh, *,
           fsdp: bool = False) -> tuple:
    """-> ({parameter name: (new_mesh, placements)}, report). Raises
    ``ValueError`` if a sharded dim no longer divides the new mesh's axis
    size. ``params_shape``: an ``lm.LM`` (meta will do) or its tensors by
    name; the meshes are ``DeviceMesh``es."""
    sizes = dict(zip(new_mesh.mesh_dim_names, new_mesh.shape))
    leaves = _ref_leaves(cfg, params_shape, fsdp)
    for _, shape, spec in leaves:
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            size = 1
            for a in axes:
                size *= sizes[a]
            if shape[dim] % size != 0:
                raise ValueError(
                    f"elastic reshard: dim {dim} of {shape} not divisible "
                    f"by new axis {axes}={size}")
    changed = []
    if tuple(old_mesh.shape) != tuple(new_mesh.shape):
        changed = [(a, o, n) for a, o, n in zip(
            new_mesh.mesh_dim_names, old_mesh.shape, new_mesh.shape)
            if o != n]
    spec = shd.param_specs(cfg, params_shape, fsdp=fsdp)
    placed = {name: (new_mesh, shd.placements(s, new_mesh))
              for name, s in spec.items()}
    report = ReshardReport(old_mesh=tuple(old_mesh.shape),
                           new_mesh=tuple(new_mesh.shape),
                           n_params=len(leaves), changed_axes=changed)
    return placed, report
