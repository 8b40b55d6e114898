"""The port's expert-parallel MoE over four ``gloo`` ranks against JAX's
``moe_apply_sharded`` on four forced host devices.

The module fixture runs this file as programs: a JAX process with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` runs the reference
under a (data 2, model 2) mesh (and its one-process ``moe_apply``), then
four port ranks (``gloo``, a ``file://`` store in the test's tmp dir, one
thread each) on a ``(data, model)`` ``DeviceMesh`` each take their share
of the same parameters (``moe_sharded.mesh_share``) and their data shard
of the same input. At
``capacity_factor`` 8 nothing drops; at 1.25 the second data shard repeats
a few tokens, so the two shards drop different shares:

* every rank's y equals the reference's rows of its data shard, and the
  aux (load balance and z-loss over all tokens, ``moe_drop_frac``) the
  reference's, within atol and rtol 1e-4;
* the two model ranks of a data shard return the same y, every rank the
  same aux;
* ``moe_drop_frac`` is data shard 0's, which differs from shard 1's at
  1.25 (the reference's quirk, ROADMAP Queue 3);
* at 8 the sharded y equals one-process ``moe_apply`` of both packages;
* ``shard_params`` slices a whole layer into shares that reassemble it;
* ``moe.moe_apply`` on DTensors (the GShard MoE per rank, the serving
  layout: experts over ``model``, their FFN dim over ``data``) equals the
  reference's one-process ``moe_apply`` at capacity factor 8, y and aux:
  on one token a row, where the dispatched tokens move over ``data``, and
  on rows of four groups of four tokens, where the expert weights do.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_moe_sharded.py``.
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
B, S = 4, 16
CASES = {"cf8": 8.0, "cf1.25": 1.25}
TIMEOUT_S = 240
TOL = dict(atol=1e-4, rtol=1e-4)
AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")
# the GShard MoE on DTensors: (input's tokens a row, moe_group_tokens)
GSHARD = {"one-token": (1, 0), "grouped": (S, 4)}


def _cfg(configs, cf: float):
    return dataclasses.replace(configs.get_config("deepseek-v3-671b",
                                                  smoke=True),
                               capacity_factor=cf)


def _x(d_model: int, skewed: bool) -> np.ndarray:
    """(B, S, d) from one seed; ``skewed``: the second data shard's rows
    are four distinct tokens, so its queues overflow."""
    x = np.random.default_rng(0).normal(size=(B, S, d_model)).astype(
        np.float32)
    if skewed:
        half = B // N_DATA
        x[half:] = x[half:, :4].repeat(S // 4, axis=1)
    return x


def _flat(p: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _jax_reference(d: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.launch.mesh import make_debug_mesh
    from repro.models import moe, sharding
    from repro.models.moe_sharded import moe_apply_sharded

    mesh = make_debug_mesh(N_DATA, N_MODEL)
    base = _cfg(configs, 1.0)
    p = moe.moe_init(jax.random.PRNGKey(0), base)
    arrs = {f"p/{k}": v for k, v in _flat(p).items()}
    for case, cf in CASES.items():
        cfg = _cfg(configs, cf)
        x = jnp.asarray(_x(cfg.d_model, skewed=cf < 8))
        with mesh, sharding.act_axes("data", "model", mesh):
            y, aux = jax.jit(lambda p, x, cfg=cfg: moe_apply_sharded(
                p, cfg, x, batch_axes="data", mesh=mesh))(p, x)
        y1, aux1 = moe.moe_apply(p, cfg, x)
        if case == "cf8":
            for name, (s, g) in GSHARD.items():
                yg, auxg = moe.moe_apply(
                    p, dataclasses.replace(cfg, moe_group_tokens=g),
                    x[:, :s])
                arrs[f"gshard/{name}/y"] = np.asarray(yg)
                for k in AUX:
                    arrs[f"gshard/{name}/{k}"] = np.asarray(auxg[k])
        arrs[f"{case}/y"] = np.asarray(y)
        arrs[f"{case}/y_one"] = np.asarray(y1)
        for k in AUX:
            arrs[f"{case}/{k}"] = np.asarray(aux[k])
            arrs[f"{case}/one_{k}"] = np.asarray(aux1[k])
    np.savez(f"{d}/jax.npz", **arrs)


def _rank(r: int, d: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.models import moe as tmoe
    from repro_torch.models import moe_sharded as ms
    from repro_torch.models import sharding
    from repro_torch.common.mesh import mesh_shard, shard_rows

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=r,
                            world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (N_DATA, N_MODEL),
                                mesh_dim_names=("data", "model"))
        ref = np.load(f"{d}/jax.npz")
        p = _nest({k[2:]: torch.tensor(ref[k]) for k in ref.files
                   if k.startswith("p/")})
        arrs = {}
        r0, r1 = shard_rows(B, mesh)
        for case, cf in CASES.items():
            cfg = _cfg(configs, cf)
            x = torch.tensor(_x(cfg.d_model, skewed=cf < 8))[r0:r1]
            y, aux = ms.moe_apply_sharded(ms.mesh_share(p, cfg, mesh), cfg,
                                          x, mesh)
            arrs[f"{case}/y"] = y.numpy()
            for k in AUX:
                arrs[f"{case}/{k}"] = aux[k].numpy()
        # the GShard MoE per rank on DTensors, in the serving layout
        cfg = _cfg(configs, CASES["cf8"])
        placed = _nest({k: sharding.place(v, sharding.spec_for_path(
            "moe/" + k, v.ndim, "data", moe_shard_ffn_dim=True), mesh)
            for k, v in _flat_t(p).items()})
        x = torch.tensor(_x(cfg.d_model, skewed=False))
        for name, (s, g) in GSHARD.items():
            y, aux = tmoe.moe_apply(
                placed, dataclasses.replace(cfg, moe_group_tokens=g),
                sharding.place(x[:, :s].contiguous(), ("data", None, None),
                               mesh))
            arrs[f"gshard/{name}/y"] = y.full_tensor().numpy()
            for k in AUX:
                arrs[f"gshard/{name}/{k}"] = aux[k].full_tensor().numpy()
        arrs["place"] = np.array([mesh_shard(mesh)[1],
                                  mesh_shard(mesh, ("model",))[1]])
        np.savez(f"{d}/rank{r}.npz", **arrs)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("moe_sharded"))
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N_RANKS}"
    env["JAX_PLATFORMS"] = "cpu"
    me = os.path.abspath(__file__)
    out = subprocess.run([sys.executable, me, "jax", d], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, f"JAX reference: {out.stderr[-3000:]}"
    ranks = [subprocess.Popen([sys.executable, me, "rank", str(r), d],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(N_RANKS)]
    errs = []
    try:
        for p in ranks:
            errs.append(p.communicate(timeout=TIMEOUT_S)[1])
    finally:
        for p in ranks:
            p.kill()
    for r, (p, err) in enumerate(zip(ranks, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return dict(jax=dict(np.load(f"{d}/jax.npz")),
                ranks=[dict(np.load(f"{d}/rank{r}.npz"))
                       for r in range(N_RANKS)])


def _flat_t(p: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update(_flat_t(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _rows(rank: dict) -> slice:
    bl = B // N_DATA
    return slice(int(rank["place"][0]) * bl, (int(rank["place"][0]) + 1) * bl)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_match_jax_sharded(runs, case):
    ref = runs["jax"]
    for r, got in enumerate(runs["ranks"]):
        assert tuple(got["place"]) == divmod(r, N_MODEL)
        np.testing.assert_allclose(got[f"{case}/y"],
                                   ref[f"{case}/y"][_rows(got)], **TOL,
                                   err_msg=f"rank {r} y")
        for k in AUX:
            np.testing.assert_allclose(got[f"{case}/{k}"], ref[f"{case}/{k}"],
                                       **TOL, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_ranks_agree(runs, case):
    ranks = runs["ranks"]
    for d in range(N_DATA):
        a, b = ranks[d * N_MODEL], ranks[d * N_MODEL + 1]
        np.testing.assert_array_equal(a[f"{case}/y"], b[f"{case}/y"])
    for got in ranks[1:]:
        for k in AUX:
            np.testing.assert_array_equal(got[f"{case}/{k}"],
                                          ranks[0][f"{case}/{k}"])


def test_drop_frac_is_data_shard_0s(runs):
    """At 1.25 the shards drop different shares; the reference's value,
    and every rank's, is shard 0's."""
    from repro_torch import configs
    from repro_torch.models import moe as tmoe

    cfg = _cfg(configs, CASES["cf1.25"])
    ref = runs["jax"]
    x = torch.tensor(_x(cfg.d_model, skewed=True))
    router = torch.tensor(ref["p/router"])
    bl = B // N_DATA
    t = bl * S
    cap_ = max(4, tmoe.group_capacity(t, cfg))
    drops = []
    for d in range(N_DATA):
        xt = x[d * bl:(d + 1) * bl].reshape(t, -1)
        _, top_i, _ = tmoe.router_topk(xt @ router, cfg.n_experts_per_tok)
        _, keep = tmoe.expert_positions(top_i, cfg.n_experts, cap_)
        drops.append(1.0 - keep.float().mean().item())
    assert drops[1] > drops[0] + 0.1, drops
    assert float(ref["cf1.25/moe_drop_frac"]) == pytest.approx(drops[0],
                                                               abs=1e-6)
    for got in runs["ranks"]:
        assert float(got["cf1.25/moe_drop_frac"]) == pytest.approx(
            drops[0], abs=1e-6)


def test_no_drops_equal_one_process_moe_apply(runs):
    from repro_torch import configs
    from repro_torch.models import moe as tmoe

    ref = runs["jax"]
    cfg = _cfg(configs, CASES["cf8"])
    p = _nest({k[2:]: torch.tensor(ref[k]) for k in ref
               if k.startswith("p/")})
    y, aux = tmoe.moe_apply(p, cfg, torch.tensor(_x(cfg.d_model, False)))
    np.testing.assert_allclose(y.numpy(), ref["cf8/y_one"], **TOL)
    assert float(aux["moe_drop_frac"]) == float(ref["cf8/moe_drop_frac"]) \
        == 0.0
    for got in runs["ranks"]:
        np.testing.assert_allclose(got["cf8/y"], y.numpy()[_rows(got)],
                                   **TOL)
    for k in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(ref[f"cf8/{k}"], aux[k].numpy(), **TOL,
                                   err_msg=k)


def test_shard_params_reassemble_the_layer(runs):
    from repro_torch import configs
    from repro_torch.models import moe_sharded as ms

    ref = runs["jax"]
    cfg = _cfg(configs, 1.0)
    p = _nest({k[2:]: torch.tensor(ref[k]) for k in ref
               if k.startswith("p/")})
    shares = [[ms.shard_params(p, cfg, data_shard=d, n_data=N_DATA,
                               model_rank=m, n_model=N_MODEL)
               for d in range(N_DATA)] for m in range(N_MODEL)]
    el, dl = cfg.n_experts // N_MODEL, cfg.d_model // N_DATA
    assert shares[1][0]["w_up"].shape == (el, dl, cfg.moe_d_ff)
    assert shares[1][0]["w_down"].shape == (el, cfg.moe_d_ff, dl)
    for name, dim in (("w_up", 1), ("w_gate", 1), ("w_down", 2)):
        whole = torch.cat([torch.cat([s[name] for s in row], dim=dim)
                           for row in shares], dim=0)
        assert torch.equal(whole, p[name]), name
    assert shares[0][1]["router"] is p["router"]
    assert shares[0][1]["shared"] is p["shared"]
    with pytest.raises(ValueError, match="experts"):
        ms.shard_params(p, cfg, data_shard=0, n_data=N_DATA, model_rank=0,
                        n_model=3)



@pytest.mark.parametrize("name", sorted(GSHARD))
def test_gshard_by_rank_equals_one_process(runs, name):
    ref = runs["jax"]
    for r, got in enumerate(runs["ranks"]):
        for k in ("y", *AUX):
            np.testing.assert_allclose(got[f"gshard/{name}/{k}"],
                                       ref[f"gshard/{name}/{k}"], **TOL,
                                       err_msg=f"rank {r} {k}")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_reference(sys.argv[2])
    else:
        _rank(int(sys.argv[2]), sys.argv[3])
