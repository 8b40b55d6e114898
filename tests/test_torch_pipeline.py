"""The port's GPipe pipeline and elastic replan against the JAX package's.

The module fixture draws a four-layer ``stablelm`` smoke model with the
port (seed 0), then runs this file as programs: a JAX process with eight
forced host devices runs the reference's ``pipeline_apply`` on a
four-device ``("stage",)`` mesh (one smoke block a stage, the stacked
block parameters sharded over the stages, eight microbatches of one
row; its ``shard_map`` with ``check_vma=False``: with the check on,
this jax refuses its loop carry, ROADMAP Queue 3) and the reference's
``replan``; four port ranks (``gloo``, a
``file://`` store in the test's tmp dir) run ``pipeline_apply`` over a
``("stage",)`` ``DeviceMesh``, the stacked parameters as DTensors sharded
over it.

* ``bubble`` equals the reference's;
* every rank's pipeline output equals the four blocks applied in turn in
  one process and the reference's pipeline output (atol/rtol 1e-5), its
  hand-off went through the device path (CPU tensors over ``gloo``);
* ``replan`` of the ``qwen3-14b`` smoke model from (4, 2) to (2, 4)
  (eight ranks of torch's fake process group) reports what the
  reference reports, its placements follow ``param_specs``, and a mesh
  whose model axis (3) does not divide raises the reference's
  ``ValueError`` text.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_pipeline.py``
(~30 s).
"""
import dataclasses
import datetime
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

N_STAGES, N_MB, MB, S = 4, 8, 1, 16
TOL = dict(atol=1e-5, rtol=1e-5)
TIMEOUT_S = 240
BAD_MESH = (1, 3)


def _cfg(configs):
    return dataclasses.replace(configs.get_config("stablelm-1.6b",
                                                  smoke=True),
                               n_layers=N_STAGES)


def _x(d_model: int) -> np.ndarray:
    return np.random.default_rng(3).normal(
        size=(N_MB, MB, S, d_model)).astype(np.float32)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax_reference(d: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro import configs
    from repro.common import compat
    from repro.distributed import elastic
    from repro.distributed.pipeline import bubble, pipeline_apply
    from repro.models import lm

    # the reference's fill-drain loop fails this jax's varying-axes check
    # of the fori_loop carry (ROADMAP Queue 3): run it with the check off,
    # as its sharded MoE runs
    sm = compat.shard_map
    compat.shard_map = lambda f, **kw: sm(f, **{"check_vma": False, **kw})
    cfg = _cfg(configs)
    blocks = jax.tree.map(jnp.asarray,
                          _nest(dict(np.load(f"{d}/blocks.npz"))))
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (MB, S))

    def stage_fn(p, x):
        return lm._attn_block_apply(p, cfg, x, positions, moe=False)[0]

    mesh = Mesh(np.array(jax.devices()[:N_STAGES]), ("stage",))
    with mesh:
        out = jax.jit(pipeline_apply(mesh, "stage", stage_fn, N_MB))(
            blocks, jnp.asarray(_x(cfg.d_model)))
    arrs = {"out": np.asarray(out),
            "bubble": np.asarray([bubble(s, m) for s in (1, 2, 4, 8)
                                  for m in (1, 4, 8, 32)])}
    qcfg = configs.get_config("qwen3-14b", smoke=True)
    shape = jax.eval_shape(lambda: lm.init(jax.random.PRNGKey(0), qcfg))
    old = jax.make_mesh((4, 2), ("data", "model"))
    new = jax.make_mesh((2, 4), ("data", "model"))
    _, rep = elastic.replan(qcfg, shape, old, new)
    arrs["report"] = np.asarray([*rep.old_mesh, *rep.new_mesh, rep.n_params])
    arrs["changed"] = np.asarray([[o, n] for _, o, n in rep.changed_axes])
    arrs["changed_axes"] = np.asarray([a for a, _, _ in rep.changed_axes])
    bad = types.SimpleNamespace(axis_names=("data", "model"),
                                axis_sizes=BAD_MESH,
                                devices=np.empty(BAD_MESH))
    try:
        elastic.replan(qcfg, shape, old, bad)
        arrs["error"] = np.asarray("")
    except ValueError as e:
        arrs["error"] = np.asarray(str(e))
    np.savez(f"{d}/jax.npz", **arrs)


def _rank(r: int, d: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch import configs
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.models import lm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=r,
                            world_size=N_STAGES,
                            timeout=datetime.timedelta(seconds=120))
    try:
        cfg = _cfg(configs)
        mesh = init_device_mesh("cpu", (N_STAGES,),
                                mesh_dim_names=("stage",))
        flat = dict(np.load(f"{d}/blocks.npz"))
        staged = {k: distribute_tensor(torch.tensor(v), mesh, [Shard(0)],
                                       src_data_rank=None)
                  for k, v in flat.items()}
        positions = torch.arange(S, dtype=torch.int32).expand(MB, S)

        def stage_fn(p, x):
            return lm._block_prefill(_nest(p), cfg, x, positions, None)[0]

        fn = pipeline_apply(mesh, "stage", stage_fn, N_MB)
        with torch.no_grad():
            out = fn(staged, torch.tensor(_x(cfg.d_model)))
        np.savez(f"{d}/rank{r}.npz", out=out.to_local().numpy(),
                 handoff=np.asarray(fn.handoff))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch import configs, convert
    from repro_torch.models import lm

    d = str(tmp_path_factory.mktemp("pipeline"))
    cfg = _cfg(configs)
    model = lm.LM(cfg, seed=0, device="cpu")
    tree = convert.lm_tree(model)
    np.savez(f"{d}/blocks.npz", **_flat(tree["blocks"]))
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    me = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, me, "jax", d], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    procs += [subprocess.Popen([sys.executable, me, "rank", str(r), d],
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for r in range(N_STAGES)]
    x = torch.tensor(_x(cfg.d_model))
    positions = torch.arange(S, dtype=torch.int32).expand(MB, S)
    with torch.no_grad():
        seq = []
        for m in range(N_MB):
            y = x[m]
            for block in model.blocks:
                y = lm._block_prefill(lm.param_tree(block), cfg, y,
                                      positions, None)[0]
            seq.append(y)
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=TIMEOUT_S)[1])
    finally:
        for p in procs:
            p.kill()
    for name, p, err in zip(["jax"] + [f"rank {r}" for r in
                                       range(N_STAGES)], procs, errs):
        assert p.returncode == 0, f"{name}: {err[-3000:]}"
    return dict(jax=dict(np.load(f"{d}/jax.npz")),
                ranks=[dict(np.load(f"{d}/rank{r}.npz"))
                       for r in range(N_STAGES)],
                seq=torch.stack(seq).numpy())


def test_bubble_equals_the_reference(runs):
    from repro_torch.distributed.pipeline import bubble

    got = [bubble(s, m) for s in (1, 2, 4, 8) for m in (1, 4, 8, 32)]
    np.testing.assert_allclose(got, runs["jax"]["bubble"], rtol=0, atol=0)
    assert bubble(4, 8) == pytest.approx(3 / 11)


def test_pipeline_equals_sequential_blocks_and_the_reference(runs):
    for r, got in enumerate(runs["ranks"]):
        np.testing.assert_allclose(got["out"], runs["seq"], **TOL,
                                   err_msg=f"rank {r} vs sequential")
        np.testing.assert_allclose(got["out"], runs["jax"]["out"], **TOL,
                                   err_msg=f"rank {r} vs reference")
        assert str(got["handoff"]) == "device"


def test_replan_reports_and_refuses_as_the_reference(runs):
    from repro_torch import configs
    from repro_torch.distributed import elastic
    from repro_torch.launch import input_specs
    from repro_torch.launch.mesh import _make_mesh, fake_world
    from repro_torch.models import sharding

    ref = runs["jax"]
    cfg = configs.get_config("qwen3-14b", smoke=True)
    model = input_specs.abstract_model(cfg)
    with fake_world(8):
        old = _make_mesh((4, 2), ("data", "model"), "cpu")
        new = _make_mesh((2, 4), ("data", "model"), "cpu")
        placed, rep = elastic.replan(cfg, model, old, new)
        assert [*rep.old_mesh, *rep.new_mesh, rep.n_params] == \
            ref["report"].tolist()
        assert [[o, n] for _, o, n in rep.changed_axes] == \
            ref["changed"].tolist()
        assert [a for a, _, _ in rep.changed_axes] == \
            ref["changed_axes"].tolist()
        specs = sharding.param_specs(cfg, model)
        assert set(placed) == set(specs)
        for name, (mesh, pl) in placed.items():
            assert mesh is new
            assert pl == sharding.placements(specs[name], new)
        bad = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                    shape=BAD_MESH)
        with pytest.raises(ValueError) as e:
            elastic.replan(cfg, model, old, bad)
    assert str(ref["error"]) and str(e.value) == str(ref["error"])


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_reference(sys.argv[2])
    else:
        _rank(int(sys.argv[2]), sys.argv[3])
