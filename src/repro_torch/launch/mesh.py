"""Production mesh construction on ``torch.distributed``.

Port of ``repro.launch.mesh``. FUNCTIONS (not module-level constants), so
importing this module touches no device and no process group. Each builds
a ``DeviceMesh`` with ``init_device_mesh`` over the current process
group, whose world size must equal the mesh's size. Single pod: 16×16 =
256 ranks ``("data", "model")``. Multi-pod: 2×16×16 = 512 ranks
``("pod", "data", "model")``; the ``pod`` axis composes with ``data`` for
data parallelism.

``fake_world(size)`` starts torch's fake process group (a
``FakeStore``: every collective returns at once, nothing is sent) in this
process as rank 0 of ``size``: the dry-run builds the production mesh on
it in one process. A process holds one default process group, so a
process that already has a real one cannot start the fake world: run the
dry-run in a child process there.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _make_mesh(shape, axes, device_type: str | None = None):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or "cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The 16×16 ``(data, model)`` mesh, or 2×16×16 ``(pod, data, model)``
    with ``multi_pod``; ``device_type`` is ``"cuda"`` unless given."""
    shape, axes = PRODUCTION[multi_pod]
    return _make_mesh(shape, axes, device_type)


def data_axes(mesh) -> tuple:
    """Every mesh axis that carries batch/data parallelism (all but
    ``model``)."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: str | None = None):
    """A small ``(data, model)`` mesh (tests over ``gloo`` ranks, or the
    fake world)."""
    return _make_mesh((n_data, n_model), ("data", "model"), device_type)


@contextlib.contextmanager
def fake_world(size: int, *, rank: int = 0):
    """Torch's fake process group of ``size`` ranks as this process's
    default group inside the block, this process its rank ``rank``;
    destroyed on exit. A process group already here raises
    ``RuntimeError``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "this process already has a process group; the fake world "
            "needs a process of its own (run the dry-run in a child "
            "process)")
    dist.init_process_group("fake", rank=rank, world_size=size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()
