"""The port's training step on a (data 2, model 2) mesh of four ``gloo``
ranks against the same step in one process and the JAX package's jitted
step on a (2, 2) mesh of four forced host devices.

The module fixture draws each case's parameters with JAX's
``init_state`` in this process, then runs this file as programs, at the
same time: a JAX process (four forced host devices) jits the
reference's step with ``param_specs``/``opt_state_specs``/
``batch_specs`` shardings on ``make_debug_mesh(2, 2)`` (under
``with_act_axes`` for the sharded MoE), and four port ranks (``gloo``, a
``file://`` store in the test's tmp dir, one thread each) carry the same
parameters over (``convert.lm_params``), place them with
``train.step.shard_state`` and run ``make_train_step(batch_axes=
("data",))`` under ``with_act_axes`` on the same ``SyntheticLM`` batches.
Cases: ``stablelm`` smoke with AdamW f32 moments (one microbatch) and
with the int8 first moment (two microbatches), B=8; ``deepseek-v3`` smoke
(MLA, MTP) with ``moe_impl="sharded"``, B=2, so each data shard holds one
row and the sharded MoE's per-shard capacity groups are the one-process
MoE's per-row groups; ``mamba2`` and ``zamba2`` smoke with AdamW f32
moments, B=4 (the SSD scan, its convs and gated norm run per rank over
their heads, ``models/mamba2._by_rank``). Remat is off in every case (it
recomputes the same forward; ``test_torch_train_step.py`` holds it).

* two steps' losses and metrics, and the parameters after them, equal the
  one-process port step and the reference's, within atol/rtol 1e-4 (the
  sharded MoE's ``moe_drop_frac`` is data shard 0's share, the reference's
  quirk, and is held to the reference only; an
  Adam element whose gradient is at the float noise floor may move by up
  to the learning rate in either, as in ``test_torch_train_step.py``; an
  int8 moment's code by one quantum);
* ``_moe_dispatch`` reached ``moe_sharded.moe_apply_sharded`` (counted by
  wrapping it in the ranks) once per MoE block and microbatch pass;
* the int8 case saves a checkpoint after its first step on (2, 2)
  (gathered, written by the first rank), restores it onto a (4, 1) mesh
  of the same ranks through ``elastic.replan`` and
  ``ckpt.restore(shardings=)``, and its second step there equals the
  second step without the restore.

Run alone (~140 s): ``PYTHONPATH=src python -m pytest -q
tests/test_torch_mesh_train.py``.
"""
import dataclasses
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

N_DATA, N_MODEL = 2, 2
N_RANKS = N_DATA * N_MODEL
S, STEPS = 32, 2
CASES = {
    "stablelm-adamw-f32": ("stablelm-1.6b", 8, dict(
        optimizer="adamw", state_dtype="float32", microbatches=1), {}),
    "stablelm-adamw-int8-mb2": ("stablelm-1.6b", 8, dict(
        optimizer="adamw", state_dtype="int8", microbatches=2), {}),
    "deepseek-sharded": ("deepseek-v3-671b", 2, dict(
        optimizer="adamw", state_dtype="float32", microbatches=1),
        {"moe_impl": "sharded"}),
    "mamba2-adamw-f32": ("mamba2-370m", 4, dict(
        optimizer="adamw", state_dtype="float32", microbatches=1), {}),
    "zamba2-adamw-f32": ("zamba2-2.7b", 4, dict(
        optimizer="adamw", state_dtype="float32", microbatches=1), {}),
}
RESTORED = "stablelm-adamw-int8-mb2"
PLAN = dict(lr=1e-3, warmup=2, total_steps=10, remat=False)
TOL = dict(rtol=1e-4, atol=1e-4)
FLIP_SHARE = 1e-3
TIMEOUT_S = 400


def _cfg(configs, case: str):
    arch, _, _, over = CASES[case]
    return dataclasses.replace(configs.get_config(arch, smoke=True), **over)


def _plan(step_mod, case: str):
    return step_mod.TrainPlan(**CASES[case][2], **PLAN)


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _batches(cfg, b: int, adapt, pipeline=None):
    """The ``SyntheticLM`` batches of both steps (the port's pipeline, or
    the reference's, which gives the same tokens)."""
    if pipeline is None:
        from repro_torch.data import pipeline
    src = pipeline.SyntheticLM(pipeline.BatchSpec(b, S, cfg.vocab), seed=0)
    return [adapt(cfg, src.batch_at(i)) for i in range(STEPS)]


def _jax_reference(d: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs
    from repro.data import pipeline
    from repro.launch import train as jtrain
    from repro.launch.mesh import make_debug_mesh
    from repro.models import sharding
    from repro.train import step as jstep

    mesh = make_debug_mesh(N_DATA, N_MODEL)

    def ns(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    arrs = {}
    for case, (_, b, _, _) in CASES.items():
        cfg, plan = _cfg(configs, case), _plan(jstep, case)
        init = dict(np.load(f"{d}/init_{case}.npz"))
        params = jax.tree.map(jnp.asarray, _nest(init))
        opt = jstep.init_state(jax.random.PRNGKey(0), cfg, plan)[1]
        pspec = sharding.param_specs(cfg, params, fsdp=plan.fsdp)
        ospec = sharding.opt_state_specs(pspec, opt)
        step = sharding.with_act_axes(
            jstep.make_train_step(cfg, plan, batch_axes=("data",),
                                  grad_specs=pspec), "data", mesh=mesh)
        batches = _batches(cfg, b, lambda c, raw: jtrain._adapt_batch(c, raw),
                           pipeline)
        bspec = sharding.batch_specs(cfg, batches[0], ("data",))
        with mesh:
            fn = jax.jit(step, in_shardings=(ns(pspec), ns(ospec),
                                             ns(bspec)),
                         out_shardings=(ns(pspec), ns(ospec),
                                        NamedSharding(mesh, P())))
            for i, batch in enumerate(batches):
                params, opt, m = fn(params, opt, batch)
                for k, v in m.items():
                    arrs[f"{case}/m{i}/{k}"] = np.asarray(v)
        for k, v in _flat(jax.tree.map(np.asarray, params)).items():
            arrs[f"{case}/p/{k}"] = v
    np.savez(f"{d}/jax.npz", **arrs)


def _rank(r: int, d: str) -> None:
    import time

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs, convert
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import elastic
    from repro_torch.launch import train as ttrain
    from repro_torch.models import moe_sharded, sharding
    from repro_torch.train import step as tstep

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=r,
                            world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=300))
    calls = [0]
    inner = moe_sharded.moe_apply_sharded

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    moe_sharded.moe_apply_sharded = counted
    try:
        mesh = init_device_mesh("cpu", (N_DATA, N_MODEL),
                                mesh_dim_names=("data", "model"))
        arrs = {}
        for case, (_, b, _, _) in CASES.items():
            cfg, plan = _cfg(configs, case), _plan(tstep, case)
            init = _nest(dict(np.load(f"{d}/init_{case}.npz")))
            model, opt = tstep.shard_state(
                convert.lm_params(init, cfg, device="cpu"), plan, mesh)
            fn = sharding.with_act_axes(
                tstep.make_train_step(cfg, plan, batch_axes=("data",)),
                "data", mesh=mesh)
            batches = _batches(
                cfg, b, lambda c, raw: ttrain._adapt_batch(c, raw, "cpu"))
            calls[0] = 0
            t0 = time.perf_counter()
            for i, batch in enumerate(batches):
                if case == RESTORED and i == 1:
                    ckpt.save(f"{d}/ckpt", 1, {
                        "params": dict(model.named_parameters()),
                        "opt": opt})
                placed = sharding.place_tree(
                    batch, sharding.batch_specs(cfg, batch), mesh)
                opt, m = fn(model, opt, placed)
                for k, v in m.items():
                    arrs[f"{case}/m{i}/{k}"] = v.full_tensor().numpy()
            arrs[f"{case}/moe_calls"] = np.asarray(calls[0])
            print(f"{case}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
            for k, v in model.named_parameters():
                arrs[f"{case}/p/{k}"] = v.full_tensor().detach().numpy()
        # the int8 case's second step again, from its checkpoint on (4, 1)
        case = RESTORED
        cfg, plan = _cfg(configs, case), _plan(tstep, case)
        wide = init_device_mesh("cpu", (N_RANKS, 1),
                                mesh_dim_names=("data", "model"))
        model, opt = tstep.shard_state(
            convert.lm_params(_nest(dict(np.load(f"{d}/init_{case}.npz"))),
                              cfg, device="cpu"), plan, wide)
        placed, report = elastic.replan(cfg, model, mesh, wide)
        ospec = sharding.opt_state_specs(
            sharding.param_specs(cfg, model), opt)
        like = {"params": dict(model.named_parameters()), "opt": opt}
        shardings = {"params": placed, "opt": _placed(ospec, wide)}
        _, back, _ = ckpt.restore(f"{d}/ckpt", like=like,
                                  shardings=shardings)
        with torch.no_grad():
            for k, v in model.named_parameters():
                v.copy_(back["params"][k])
        fn = sharding.with_act_axes(
            tstep.make_train_step(cfg, plan, batch_axes=("data",)), "data",
            mesh=wide)
        batch = _batches(cfg, CASES[case][1],
                         lambda c, raw: ttrain._adapt_batch(c, raw, "cpu"))[1]
        _, m = fn(model, back["opt"], sharding.place_tree(
            batch, sharding.batch_specs(cfg, batch), wide))
        for k, v in m.items():
            arrs[f"restored/m1/{k}"] = v.full_tensor().numpy()
        for k, v in model.named_parameters():
            arrs[f"restored/p/{k}"] = v.full_tensor().detach().numpy()
        arrs["restored/report"] = np.asarray(
            [*report.old_mesh, *report.new_mesh, report.n_params])
        arrs["restored/changed"] = np.asarray(
            [[o, n] for _, o, n in report.changed_axes])
        if r == 0:
            np.savez(f"{d}/port.npz", **arrs)
    finally:
        dist.destroy_process_group()


def _placed(specs, mesh):
    from repro_torch.models import sharding

    if isinstance(specs, dict):
        return {k: _placed(v, mesh) for k, v in specs.items()}
    return (mesh, sharding.placements(specs, mesh))


def _one_process(d: str) -> dict:
    """The same two steps of each case in this process, no mesh."""
    from repro_torch import configs, convert
    from repro_torch.launch import train as ttrain
    from repro_torch.train import step as tstep

    out = {}
    for case, (_, b, _, _) in CASES.items():
        cfg, plan = _cfg(configs, case), _plan(tstep, case)
        model = convert.lm_params(_nest(dict(np.load(f"{d}/init_{case}.npz"))),
                                  cfg, device="cpu")
        ocfg, oinit, _ = tstep._opt(plan)
        opt = oinit(dict(model.named_parameters()), ocfg)
        fn = tstep.make_train_step(cfg, plan)
        for i, batch in enumerate(_batches(
                cfg, b, lambda c, raw: ttrain._adapt_batch(c, raw, "cpu"))):
            opt, m = fn(model, opt, batch)
            for k, v in m.items():
                out[f"{case}/m{i}/{k}"] = v.numpy()
        for k, v in model.named_parameters():
            out[f"{case}/p/{k}"] = v.detach().numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro import configs as jconfigs
    from repro.train import step as jstep

    d = str(tmp_path_factory.mktemp("mesh_train"))
    for case in CASES:
        cfg, plan = _cfg(jconfigs, case), _plan(jstep, case)
        params, _ = jstep.init_state(jax.random.PRNGKey(0), cfg, plan)
        np.savez(f"{d}/init_{case}.npz",
                 **_flat(jax.tree.map(np.asarray, params)))
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N_RANKS}"
    env["JAX_PLATFORMS"] = "cpu"
    me = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, me, "jax", d], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    procs += [subprocess.Popen([sys.executable, me, "rank", str(r), d],
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for r in range(N_RANKS)]
    one = _one_process(d)
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=TIMEOUT_S)[1])
    finally:
        for p in procs:
            p.kill()
    for name, p, err in zip(["jax"] + [f"rank {r}" for r in range(N_RANKS)],
                            procs, errs):
        assert p.returncode == 0, f"{name}: {err[-3000:]}"
    return dict(jax=dict(np.load(f"{d}/jax.npz")),
                port=dict(np.load(f"{d}/port.npz")), one=one)


def _lm_leaf(ref: dict, case: str, name: str) -> np.ndarray:
    """The reference's leaf behind the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] in ("blocks", "dense_blocks", "moe_blocks") and \
            parts[1].isdigit():
        return ref[f"{case}/p/" + "/".join([parts[0], *parts[2:]])][
            int(parts[1])]
    return ref[f"{case}/p/" + "/".join(parts)]


def _held(got, want, label: str) -> None:
    """Within TOL; up to FLIP_SHARE of the elements within the peak
    learning rate instead (Adam's noise-floor elements)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    off = ~np.isclose(got, want, **TOL)
    if off.any() and off.mean() <= FLIP_SHARE:
        assert np.abs(got - want)[off].max() <= PLAN["lr"], label
        return
    np.testing.assert_allclose(got, want, err_msg=label, **TOL)


def _names(runs, case: str) -> list:
    return sorted(k[len(case) + 3:] for k in runs["one"]
                  if k.startswith(f"{case}/p/"))


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_equals_one_process(runs, case):
    port, one = runs["port"], runs["one"]
    for i in range(STEPS):
        keys = [k for k in one if k.startswith(f"{case}/m{i}/")]
        assert keys and set(keys) <= set(port), case
        for k in keys:
            if k.endswith("moe_drop_frac") and "sharded" in case:
                continue  # data shard 0's on a mesh (ROADMAP Queue 3)
            np.testing.assert_allclose(port[k], one[k], err_msg=k, **TOL)
    for name in _names(runs, case):
        _held(port[f"{case}/p/{name}"], one[f"{case}/p/{name}"],
              f"{case} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_equals_the_reference_on_a_mesh(runs, case):
    port, ref = runs["port"], runs["jax"]
    for i in range(STEPS):
        keys = [k for k in ref if k.startswith(f"{case}/m{i}/")]
        assert keys, case
        for k in keys:
            np.testing.assert_allclose(port[k], ref[k], err_msg=k, **TOL)
    for name in _names(runs, case):
        _held(port[f"{case}/p/{name}"], _lm_leaf(ref, case, name),
              f"{case} {name}")


def test_moe_dispatch_reached_the_sharded_moe(runs):
    from repro_torch import configs

    cfg = _cfg(configs, "deepseek-sharded")
    n_moe = cfg.n_layers - cfg.first_k_dense
    mb = CASES["deepseek-sharded"][2]["microbatches"]
    assert int(runs["port"]["deepseek-sharded/moe_calls"]) == \
        STEPS * mb * n_moe > 0
    assert int(runs["port"]["stablelm-adamw-f32/moe_calls"]) == 0


def test_restore_onto_another_mesh_continues_the_run(runs):
    port = runs["port"]
    assert port["restored/report"].tolist()[:4] == [N_DATA, N_MODEL,
                                                    N_RANKS, 1]
    assert port["restored/changed"].tolist() == [[N_DATA, N_RANKS],
                                                 [N_MODEL, 1]]
    for k in [k for k in port if k.startswith(f"{RESTORED}/m1/")]:
        np.testing.assert_allclose(port["restored/m1/" + k.split("/")[-1]],
                                   port[k], err_msg=k, **TOL)
    for name in _names(runs, RESTORED):
        _held(port[f"restored/p/{name}"], port[f"{RESTORED}/p/{name}"],
              f"restored {name}")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_reference(sys.argv[2])
    else:
        _rank(int(sys.argv[2]), sys.argv[3])
