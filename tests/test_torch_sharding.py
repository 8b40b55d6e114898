"""The port's partition specs against the JAX package's.

* ``param_specs`` of every arch at full size (the port's model built on
  the meta device, the reference's tree from ``jax.eval_shape``), with
  FSDP on and off and ``moe_shard_ffn_dim`` on and off: the port's
  ``<stack>.{i}.<path>`` spec is the reference's stacked ``<stack>/<path>``
  spec without its leading layer dim, every other leaf's equal; the meta
  parameters' shapes and dtypes are the reference's (a stacked leaf's
  without the layer dim).
* ``opt_state_specs`` of AdamW (f32 and int8 moments) and Adafactor on
  every smoke config, leaf for leaf in the same way.
* ``launch.input_specs`` of every (arch × shape): the same leaves, shapes
  and dtypes as the reference's, and ``batch_specs`` / ``cache_specs``
  (with and without the batch sharded) equal.
* ``placements`` on a 2×2×2 ``(pod, data, model)`` mesh of torch's fake
  process group, and ``constrain_batch`` the identity outside an
  activation context or on a plain tensor.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_sharding.py``
(~20 s).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common import pytree  # noqa: E402
from repro.launch import input_specs as jinput  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import input_specs  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = configs.ARCHS


def _ref(spec) -> tuple:
    return tuple(spec)


def _stacked(name: str) -> bool:
    parts = name.split(".")
    return parts[0] in sharding.STACKS and parts[1].isdigit()


def _want(ref_spec, name: str) -> tuple:
    r = _ref(ref_spec)
    return r[1:] if _stacked(name) and r else r


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference_at_full_size(arch):
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    shape = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    ref_shapes = dict(pytree.tree_paths(shape))
    model = input_specs.abstract_model(tcfg)
    names = dict(model.named_parameters())
    assert {sharding.ref_path(n) for n in names} == set(ref_shapes)
    for name, t in names.items():
        r = ref_shapes[sharding.ref_path(name)]
        want = tuple(r.shape[1:]) if _stacked(name) else tuple(r.shape)
        assert tuple(t.shape) == want, name
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), name
        assert t.is_meta
    for fsdp in (False, True):
        for ffn in (False, True):
            ref = dict(pytree.tree_paths(jshd.param_specs(
                jcfg, shape, fsdp=fsdp, moe_shard_ffn_dim=ffn)))
            got = sharding.param_specs(tcfg, model, fsdp=fsdp,
                                       moe_shard_ffn_dim=ffn)
            assert set(got) == set(names)
            for name, spec in got.items():
                assert spec == _want(ref[sharding.ref_path(name)], name), (
                    name, fsdp, ffn)


OPTS = {"adamw-f32": dict(optimizer="adamw", state_dtype="float32"),
        "adamw-int8": dict(optimizer="adamw", state_dtype="int8"),
        "adafactor": dict(optimizer="adafactor")}


@pytest.mark.parametrize("opt", list(OPTS))
def test_opt_state_specs_equal_the_reference_on_the_smoke_configs(opt):
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch, smoke=True)
        tcfg = configs.get_config(arch, smoke=True)
        jplan, tplan = jstep.TrainPlan(**OPTS[opt]), \
            tstep.TrainPlan(**OPTS[opt])
        params, jopt = jax.eval_shape(
            lambda: jstep.init_state(jax.random.PRNGKey(0), jcfg, jplan))
        ref = dict(pytree.tree_paths(jshd.opt_state_specs(
            jshd.param_specs(jcfg, params), jopt)))
        model, topt = tstep.init_state(tcfg, tplan, device="meta")
        got = _flat(sharding.opt_state_specs(
            sharding.param_specs(tcfg, model), topt))
        seen = set()
        for path, spec in got.items():
            kind, *rest = path.split("/")
            if kind == "step":
                assert spec == () == _ref(ref["step"])
                continue
            name, tail = rest[0], rest[1:]
            rpath = "/".join([kind, sharding.ref_path(name), *tail])
            seen.add(rpath)
            assert spec == _want(ref[rpath], name), (arch, opt, path)
        assert seen | {"step"} == set(ref), (arch, opt)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_batch_and_cache_specs_equal_the_reference(arch):
    jcfg = jconfigs.get_config(arch)
    for shape in SHAPES:
        ref = dict(pytree.tree_paths(jinput.input_specs(arch, shape)))
        got_tree = input_specs.input_specs(arch, shape)
        got = _flat(got_tree)
        assert set(got) == set(ref), shape
        for k, r in ref.items():
            assert tuple(got[k].shape) == tuple(r.shape), (shape, k)
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(r.dtype), (shape, k)
            assert got[k].is_meta
        jtree = jinput.input_specs(arch, shape)
        if "batch" in got_tree:
            for axes in (("data",), ("pod", "data")):
                want = {k: _ref(v) for k, v in jshd.batch_specs(
                    jcfg, jtree["batch"], axes).items()}
                assert sharding.batch_specs(jcfg, got_tree["batch"],
                                            axes) == want
        else:
            for sb in (True, False):
                want = {k: _ref(v) for k, v in pytree.tree_paths(
                    jshd.cache_specs(jcfg, jtree["cache"],
                                     shard_batch=sb))}
                assert _flat(sharding.cache_specs(
                    jcfg, got_tree["cache"], shard_batch=sb)) == want
    for seq in (False, True):
        assert sharding.activation_spec(("pod", "data"), seq_shard=seq) == \
            _ref(jshd.activation_spec(("pod", "data"), seq_shard=seq))


def test_placements_and_constrain_batch():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import _make_mesh, fake_world

    x = torch.arange(12.0).reshape(3, 4)
    assert sharding.constrain_batch(x) is x
    with sharding.act_axes("data"):
        assert sharding.act_ctx() == {"batch": "data", "model": "model",
                                      "mesh": None}
        assert sharding.constrain_batch(x) is x
    assert sharding.act_ctx() is None
    with sharding.act_axes(None):
        assert sharding.act_ctx() is None
    with fake_world(8):
        mesh = _make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        assert sharding.placements((("pod", "data"), None, "model"),
                                   mesh) == [Shard(0), Shard(0), Shard(2)]
        assert sharding.placements((), mesh) == [Replicate()] * 3
        assert sharding.placements((None, "data"), mesh) == \
            [Replicate(), Shard(1), Replicate()]
        with pytest.raises(ValueError, match="not a dimension"):
            sharding.placements(("expert",), mesh)


def test_meta_model_and_state_draw_nothing():
    cfg = dataclasses.replace(configs.get_config("mamba2-370m", smoke=True))
    model, opt = tstep.init_state(cfg, tstep.TrainPlan(state_dtype="int8"),
                                  device="meta")
    assert all(p.is_meta for p in model.parameters())
    leaves = list(_flat(opt).values())
    assert leaves and all(t.is_meta for t in leaves)
    assert np.prod(model.blocks[0].mamba.in_z.shape) > 0
