"""The port's training parts against the JAX package, each on its own.

* optimizers: ``_quantize_i8``'s ``q`` equal to the reference's exactly
  (ties at a half quantum included) and its scale within one ulp; AdamW
  (f32, bf16 and int8 moments, weight decay, the clip) and Adafactor
  (factored and not, a stacked leaf's one RMS) updates on random trees
  for three steps; the schedules at steps 0, 1, warmup and total; the
  clip's formula ``min(1, c / (norm + 1e-9))``;
* data: ``SyntheticLM``, ``PackedCorpus`` and ``make_source`` batches
  equal to the reference's bit for bit;
* checkpoints: the claims ``tests/test_checkpoint.py`` makes of the
  reference (round trip, an uncommitted step skipped, a checksum, the
  same step overwritten, a shape mismatch), a missing leaf, bf16 and int8
  leaves, neither ``msgpack`` nor ``ml_dtypes`` imported; the resume
  through ``launch.train.main`` on ``mamba2-370m --smoke``;
* ``fault_tolerance``: the claims of ``tests/test_distributed.py``;
* ``grad_compress`` and ``ef_allreduce`` over four ``gloo`` rank
  processes against the reference's under ``shard_map`` on four forced
  host devices (this file run as programs, in a module fixture);
* the SSD repair: at one chunk of 64 with A = -16 and dt = 0.1 JAX's
  gradient with respect to dt holds NaNs and the port's is finite; at
  dt = 0.01 both are finite and equal; the forward is equal in both;
* ``convert.lm_tree`` inverts ``convert.lm_params`` for every family.
"""
import ast
import datetime
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

N_RANKS = 4
TIMEOUT_S = 240
TOL = dict(rtol=1e-5, atol=1e-6)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _grad_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 16)).astype(np.float32),
            "b": (rng.normal(size=(16,)) * 1e-3).astype(np.float32)}


# ---------------------------------------------------------------------------
# the subprocess side of ef_allreduce
# ---------------------------------------------------------------------------

def _jax_reference(d: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.common import compat
    from repro.train.grad_compress import ef_allreduce

    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("d",))
    grads = [_grad_tree(r) for r in range(N_RANKS)]
    res = [_grad_tree(100 + r) for r in range(N_RANKS)]
    stack = {k: jnp.stack([g[k] for g in grads]) for k in grads[0]}
    rstack = {k: jnp.stack([0.01 * g[k] for g in res]) for k in res[0]}

    def f(g, r):
        one = lambda t: {k: v[0] for k, v in t.items()}  # noqa: E731
        red, nr = ef_allreduce(one(g), one(r), "d")
        return ({k: v[None] for k, v in red.items()},
                {k: v[None] for k, v in nr.items()})

    red, nr = jax.jit(compat.shard_map(
        f, mesh=mesh, in_specs=(P("d"), P("d")),
        out_specs=(P("d"), P("d"))))(stack, rstack)
    np.savez(f"{d}/jax.npz", **{f"red/{k}": np.asarray(v)
                                for k, v in red.items()},
             **{f"res/{k}": np.asarray(v) for k, v in nr.items()})


def _rank(r: int, d: str) -> None:
    import torch.distributed as dist

    from repro_torch.train.grad_compress import ef_allreduce

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=r,
                            world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=120))
    try:
        g = {k: torch.tensor(v) for k, v in _grad_tree(r).items()}
        res = {k: 0.01 * torch.tensor(v)
               for k, v in _grad_tree(100 + r).items()}
        red, nr = ef_allreduce(g, res)
        np.savez(f"{d}/rank{r}.npz",
                 **{f"red/{k}": v.numpy() for k, v in red.items()},
                 **{f"res/{k}": v.numpy() for k, v in nr.items()})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ef_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ef_allreduce"))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
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
    try:
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for r, (p, err) in enumerate(zip(ranks, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return (dict(np.load(f"{d}/jax.npz")),
            [dict(np.load(f"{d}/rank{r}.npz")) for r in range(N_RANKS)])


def test_ef_allreduce_over_four_gloo_ranks_equals_jax(ef_runs):
    ref, ranks = ef_runs
    for r, got in enumerate(ranks):
        assert set(got) == set(ref)
        for k, v in got.items():
            np.testing.assert_allclose(v, ref[k][r], err_msg=f"rank {r} {k}",
                                       **TOL)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_reference(sys.argv[2])
    else:
        _rank(int(sys.argv[2]), sys.argv[3])
    sys.exit(0)

# ---------------------------------------------------------------------------
# the in-process tests (JAX imported from here on)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    Heartbeat, PreemptionGuard, StepWatchdog, run_resilient,
)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.train import grad_compress as tgc  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _assert_tree(got, want, label: str, **tol) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), label
        for k in want:
            _assert_tree(got[k], want[k], f"{label}/{k}", **tol)
        return
    w = np.asarray(want.astype(jnp.float32) if hasattr(want, "astype")
                   and want.dtype == jnp.bfloat16 else want)
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        got = got.float()
    np.testing.assert_allclose(np.asarray(got, w.dtype), w, err_msg=label,
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def test_quantize_i8_equals_the_reference():
    rng = np.random.default_rng(0)
    ties = np.array([[127.0, 0.5, -0.5, 1.5, -2.5, 63.5]], np.float32)
    for x in (rng.normal(size=(7, 33)).astype(np.float32),
              rng.normal(size=(3, 4, 5)).astype(np.float32) * 1e-6,
              np.float32(rng.normal()), np.zeros((4, 6), np.float32), ties):
        want = jopt._quantize_i8(jnp.asarray(x))
        got = topt._quantize_i8(torch.tensor(x))
        np.testing.assert_array_equal(got["q"].numpy(),
                                      np.asarray(want["q"]))
        assert got["scale"].shape == tuple(want["scale"].shape)
        np.testing.assert_array_max_ulp(got["scale"].numpy(),
                                        np.asarray(want["scale"]), maxulp=1)
        back = topt._dequantize_i8(got, x.shape)
        np.testing.assert_allclose(
            back.numpy(), np.asarray(jopt._dequantize_i8(want, x.shape)),
            **TOL)


def _param_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(80, 96)).astype(np.float32),
            "v": rng.normal(size=(2, 70, 64)).astype(np.float32),
            "b": rng.normal(size=(96,)).astype(np.float32),
            "s": np.float32(rng.normal())}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_updates_equal_the_reference(state_dtype):
    sched_j = jopt.cosine_schedule(1e-2, 2, 10)
    sched_t = topt.cosine_schedule(1e-2, 2, 10)
    jc = jopt.AdamWConfig(lr=sched_j, weight_decay=0.1, grad_clip_norm=1.0,
                          state_dtype=state_dtype)
    tc = topt.AdamWConfig(lr=sched_t, weight_decay=0.1, grad_clip_norm=1.0,
                          state_dtype=state_dtype)
    jp = jax.tree.map(jnp.asarray, _param_tree(0))
    tp = _t(_param_tree(0))
    js, ts = jopt.adamw_init(jp, jc), topt.adamw_init(tp, tc)
    for i in range(3):
        g = _param_tree(10 + i)
        jp, js = jopt.adamw_update(jax.tree.map(jnp.asarray, g), js, jp, jc)
        tp, ts = topt.adamw_update(_t(g), ts, tp, tc)
        _assert_tree(tp, jp, f"{state_dtype} params {i}")
        assert int(ts["step"]) == int(js["step"]) == i + 1
        if state_dtype == "int8":
            for k in js["m"]:
                assert np.abs(ts["m"][k]["q"].numpy().astype(int) - np.asarray(
                    js["m"][k]["q"]).astype(int)).max() <= 1, k
                _assert_tree(ts["m"][k]["scale"], js["m"][k]["scale"], k)
            assert ts["v"]["w"].dtype == torch.bfloat16
        else:
            _assert_tree(ts["m"], js["m"], f"{state_dtype} m {i}")
        _assert_tree(ts["v"], js["v"], f"{state_dtype} v {i}")


def test_adafactor_updates_equal_the_reference_with_a_stacked_leaf():
    """The reference's stacked leaf ``blocks/w`` (2, 70, 64) is the port's
    ``blocks.0.w`` and ``blocks.1.w``: factored per layer, one RMS."""
    jc = jopt.AdafactorConfig(lr=jopt.cosine_schedule(1e-2, 2, 10),
                              weight_decay=0.1)
    tc = topt.AdafactorConfig(lr=topt.cosine_schedule(1e-2, 2, 10),
                              weight_decay=0.1)

    def ref_tree(t):
        return {"w": t["w"], "b": t["b"], "s": t["s"],
                "blocks": {"w": t["v"]}}

    def port_tree(t):
        return {"w": t["w"], "b": t["b"], "s": t["s"],
                "blocks.0.w": t["v"][0], "blocks.1.w": t["v"][1]}

    def port_as_ref(t):
        return {"w": t["w"], "b": t["b"], "s": t["s"], "blocks": {
            "w": torch.stack([t["blocks.0.w"], t["blocks.1.w"]])}}

    jp = jax.tree.map(jnp.asarray, ref_tree(_param_tree(0)))
    tp = _t(port_tree(_param_tree(0)))
    js, ts = jopt.adafactor_init(jp, jc), topt.adafactor_init(tp, tc)
    assert set(ts["v"]["w"]) == {"vr", "vc"} and set(ts["v"]["b"]) == {"v"}
    for i in range(3):
        g = _param_tree(10 + i)
        g["v"] = g["v"] * np.array([1.0, 30.0], np.float32)[:, None, None]
        jp, js = jopt.adafactor_update(
            jax.tree.map(jnp.asarray, ref_tree(g)), js, jp, jc)
        tp, ts = topt.adafactor_update(_t(port_tree(g)), ts, tp, tc)
        _assert_tree(port_as_ref(tp), jp, f"params {i}")
        v = ts["v"]
        _assert_tree({"w": v["w"], "b": v["b"], "s": v["s"], "blocks": {
            "w": {k: torch.stack([v["blocks.0.w"][k], v["blocks.1.w"][k]])
                  for k in ("vr", "vc")}}}, js["v"], f"v {i}")


def test_schedules_equal_the_reference():
    for peak, warm, total in ((3e-4, 100, 10_000), (1e-2, 1, 6), (1.0, 10,
                                                                   100)):
        js, ts = (jopt.cosine_schedule(peak, warm, total),
                  topt.cosine_schedule(peak, warm, total))
        for s in (0, 1, warm // 2, warm, warm + 1, (warm + total) // 2,
                  total, total + 5):
            got = ts(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_array_max_ulp(
                got.numpy(), np.asarray(js(jnp.asarray(s, jnp.int32))),
                maxulp=2)
    c = topt.constant_schedule(0.5)(torch.tensor(3))
    assert c.dtype == torch.float32 and float(c) == 0.5


def test_the_clip_is_min_one_c_over_norm_plus_1e_9():
    """One step from zero moments with huge gradients: m = (1 - b1)·g·clip,
    clip = min(1, c / (||g|| + 1e-9)) over every leaf in f32 — the
    reference's (``clip_grad_norm_`` would add 1e-6)."""
    g = _param_tree(5)
    g = {k: np.float32(1e3) * v for k, v in g.items()}
    norm = np.sqrt(sum(np.sum(np.square(v, dtype=np.float32),
                              dtype=np.float32) for v in g.values()),
                   dtype=np.float32)
    for c in (1.0, 0.25):
        cfg = topt.AdamWConfig(lr=0.0, grad_clip_norm=c)
        tp = _t(_param_tree(0))
        _, st = topt.adamw_update(_t(g), topt.adamw_init(tp, cfg), tp, cfg)
        clip = min(np.float32(1.0), np.float32(c) / (norm + np.float32(1e-9)))
        for k, v in g.items():
            np.testing.assert_allclose(st["m"][k].numpy(),
                                       np.float32(0.1) * v * clip, rtol=1e-5)
        jst = jopt.adamw_update(jax.tree.map(jnp.asarray, g),
                                jopt.adamw_init(jax.tree.map(
                                    jnp.asarray, _param_tree(0)),
                                    jopt.AdamWConfig(lr=0.0,
                                                     grad_clip_norm=c)),
                                jax.tree.map(jnp.asarray, _param_tree(0)),
                                jopt.AdamWConfig(lr=0.0,
                                                 grad_clip_norm=c))[1]
        _assert_tree(st["m"], jst["m"], f"clip {c}")


def test_grad_compress_equals_the_reference():
    g = _grad_tree(0)
    r = {k: 0.01 * v for k, v in _grad_tree(1).items()}
    for k, v in g.items():
        q, s = tgc.compress(torch.tensor(v))
        jq, js = jgc.compress(jnp.asarray(v))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    tq, tres = tgc.compress_tree(_t(g), _t(r))
    jq, jres = jgc.compress_tree(jax.tree.map(jnp.asarray, g),
                                 jax.tree.map(jnp.asarray, r))
    _assert_tree(tgc.decompress_tree(tq), jgc.decompress_tree(jq), "back")
    _assert_tree(tres, jres, "residual")
    z = tgc.init_residual(_t(g))
    assert all(v.dtype == torch.float32 and not v.any() for v in z.values())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_data_batches_equal_the_reference_bit_for_bit():
    docs = [np.arange(50), np.arange(30) + 7, np.arange(3)]
    for host in (0, 1):
        js = jdata.BatchSpec(8, 16, 100, num_hosts=2, host_index=host)
        ts = tdata.BatchSpec(8, 16, 100, num_hosts=2, host_index=host)
        assert ts.host_batch == js.host_batch == 4
        pairs = [(jdata.SyntheticLM(js, seed=3), tdata.SyntheticLM(ts, seed=3)),
                 (jdata.PackedCorpus(docs, js, seed=2),
                  tdata.PackedCorpus(docs, ts, seed=2)),
                 (jdata.make_source("synthetic", js, seed=9),
                  tdata.make_source("synthetic", ts, seed=9)),
                 (jdata.make_source("packed", js, 1, docs),
                  tdata.make_source("packed", ts, 1, docs))]
        for j, t in pairs:
            for step in (0, 1, 17):
                a, b = j.batch_at(step), t.batch_at(step)
                assert set(a) == set(b) == {"tokens", "labels"}
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
        it_j, it_t = iter(jdata.SyntheticLM(js)), iter(tdata.SyntheticLM(ts))
        np.testing.assert_array_equal(next(it_j)["tokens"],
                                      next(it_t)["tokens"])
    with pytest.raises(ValueError):
        tdata.make_source("nope", ts)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture()
def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4),
                       "h": torch.linspace(-3, 3, 5).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": {"w": {"q": torch.tensor([[1, -127, 3, 0]] * 3,
                                                  dtype=torch.int8),
                                "scale": torch.full((3, 1), 0.5)}}},
            "host": np.arange(3.0)}


def test_ckpt_round_trip_keeps_dtypes_and_meta(tmp_path, tree):
    d = str(tmp_path / "ck")
    ckpt.save(d, 10, tree, meta={"note": "hi"})
    step, out, meta = ckpt.restore(d, like=tree)
    assert step == 10 and meta["note"] == "hi"
    for (p, a), (q, b) in zip(ckpt.tree_paths(out), ckpt.tree_paths(tree)):
        assert p == q and type(a) is type(b)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), p
        else:
            np.testing.assert_array_equal(a, b)
    _, flat, _ = ckpt.restore(d, device="cpu")
    assert flat["params/h"].dtype == torch.bfloat16
    assert set(flat) == {p for p, _ in ckpt.tree_paths(tree)}
    assert os.path.exists(os.path.join(d, "step_00000010", "manifest.json"))


def test_ckpt_latest_step_ignores_uncommitted(tmp_path, tree):
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, tree)
    ckpt.save(d, 9, tree)
    os.remove(os.path.join(d, "step_00000009", "COMMIT"))  # a crash
    assert ckpt.latest_step(d) == 5
    assert ckpt.restore(d, like=tree)[0] == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), like=tree)


def test_ckpt_checksum_detects_corruption(tmp_path, tree):
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, tree)
    shard = os.path.join(d, "step_00000003", "shard_p0.npz")
    data = dict(np.load(shard))
    k = [k for k in data if k.endswith("params.w")][0]
    data[k] = data[k] + 1.0
    np.savez(shard, **data)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(d, like=tree)


def test_ckpt_overwrites_the_same_step(tmp_path, tree):
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, tree)
    tree["params"]["b"] = 2 * tree["params"]["b"]
    ckpt.save(d, 2, tree)
    _, out, _ = ckpt.restore(d, like=tree)
    assert torch.equal(out["params"]["b"], 2 * torch.ones(4))
    assert sorted(os.listdir(d)) == ["step_00000002"]


def test_ckpt_refuses_a_shape_mismatch_and_a_missing_leaf(tmp_path, tree):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, tree)
    bad = dict(tree, params=dict(tree["params"], w=torch.zeros(2, 2)))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(d, like=bad)
    more = dict(tree, extra=torch.zeros(1))
    with pytest.raises(KeyError, match="missing leaf extra"):
        ckpt.restore(d, like=more)


def test_ckpt_needs_neither_msgpack_nor_ml_dtypes():
    src = (ROOT / "src/repro_torch/checkpoint/ckpt.py").read_text()
    mods = {a.name for n in ast.walk(ast.parse(src))
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.ImportFrom)}
    assert not mods & {"msgpack", "ml_dtypes"}, mods


def test_resume_through_launch_train_reproduces_the_straight_run(tmp_path):
    """6 steps straight against 3 + checkpoint + 3 resumed, on the CPU:
    the resumed steps' losses within the reference test's rtol."""
    base = ["--arch", "mamba2-370m", "--smoke", "--global-batch", "2",
            "--seq-len", "16", "--log-every", "100", "--device", "cpu"]
    full = ttrain.main(base + ["--steps", "6"])
    d = str(tmp_path / "b")
    first = ttrain.main(base + ["--steps", "3", "--schedule-total", "6",
                                "--ckpt", d, "--ckpt-every", "3"])
    assert ckpt.latest_step(d) == 3
    resumed = ttrain.main(base + ["--steps", "6", "--ckpt", d,
                                  "--ckpt-every", "3"])
    assert len(first) == len(resumed) == 3
    np.testing.assert_allclose(first, full[:3], rtol=1e-6)
    np.testing.assert_allclose(resumed, full[3:], rtol=1e-4)
    assert all(np.isfinite(full))


# ---------------------------------------------------------------------------
# fault tolerance (the claims of tests/test_distributed.py)
# ---------------------------------------------------------------------------

def test_watchdog_flags_a_persistent_straggler_and_recovers():
    wd = StepWatchdog(straggler_factor=2.0, patience=3)
    for _ in range(20):
        wd.record(0.1)
    assert not wd.flagged
    for _ in range(2):
        wd.record(0.5)
    assert not wd.flagged  # patience not reached
    wd.record(0.5)
    assert wd.flagged
    wd = StepWatchdog(straggler_factor=2.0, patience=3)
    for _ in range(10):
        wd.record(0.1)
    for t in (0.5, 0.1, 0.5, 0.5):  # the 0.1 resets the strikes
        wd.record(t)
    assert not wd.flagged and abs(wd.p50() - 0.1) < 1e-12


def test_heartbeat_finds_dead_hosts(tmp_path):
    d = str(tmp_path / "hb")
    h0, h1 = Heartbeat(d, 0), Heartbeat(d, 1)
    h0.beat()
    h1.beat()
    now = time.time()
    assert Heartbeat.dead_hosts(d, timeout_s=60, now=now) == []
    assert Heartbeat.dead_hosts(d, timeout_s=0.0, now=now + 10) == [0, 1]
    assert Heartbeat.dead_hosts(str(tmp_path / "none"), 1.0) == []


def test_run_resilient_resumes_and_checkpoints_on_preemption(tmp_path):
    d = str(tmp_path / "ck")

    def step_fn(step, state):
        return {"x": state["x"] + 1}

    rep = run_resilient(step_fn, {"x": torch.zeros(2)}, ckpt_dir=d,
                        total_steps=10, ckpt_every=4)
    assert rep.end_step == 10 and not rep.preempted
    assert rep.checkpoints == [4, 8, 10]
    _, out, _ = ckpt.restore(d, like={"x": torch.zeros(2)})
    assert torch.equal(out["x"], torch.full((2,), 10.0))
    rep2 = run_resilient(step_fn, {"x": torch.zeros(2)}, ckpt_dir=d,
                         total_steps=10, ckpt_every=4)
    assert rep2.start_step == 10 and rep2.end_step == 10
    guard = PreemptionGuard(signals=())
    guard.should_checkpoint = True
    rep3 = run_resilient(step_fn, {"x": np.zeros(2)},
                         ckpt_dir=str(tmp_path / "p"), total_steps=10,
                         ckpt_every=100, guard=guard)
    assert rep3.preempted and rep3.end_step == 1 and rep3.checkpoints == [1]


# ---------------------------------------------------------------------------
# the SSD repair
# ---------------------------------------------------------------------------

def _ssd_inputs(dt_value: float) -> tuple:
    rng = np.random.default_rng(7)
    b, s, h, p, n = 1, 64, 2, 4, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), dt_value, np.float32)
    a = np.array([-1.0, -16.0], np.float32)
    bb = rng.normal(size=(b, s, h, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, h, n)).astype(np.float32)
    return x, dt, a, bb, cc


def _ssd_both(dt_value: float) -> tuple:
    x, dt, a, bb, cc = _ssd_inputs(dt_value)

    def jf(dt_):
        y, st = jm.ssd_scan(jnp.asarray(x), dt_, jnp.asarray(a),
                            jnp.asarray(bb), jnp.asarray(cc), chunk=64)
        return jnp.sum(y) + jnp.sum(st), (y, st)

    (_, (jy, jst)), jg = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(dt))
    tdt = torch.tensor(dt, requires_grad=True)
    ty, tst = tm.ssd_scan(torch.tensor(x), tdt, torch.tensor(a),
                          torch.tensor(bb), torch.tensor(cc), chunk=64)
    (ty.sum() + tst.sum()).backward()
    return ((np.asarray(jy), np.asarray(jst), np.asarray(jg)),
            (ty.detach().numpy(), tst.detach().numpy(), tdt.grad.numpy()))


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    (jy, jst, jg), (ty, tst, tg) = _ssd_both(0.1)
    # the exponent above the diagonal reaches 63 · 0.1 · 16 > 88
    assert np.isnan(jg).sum() > 0
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tst, jst, rtol=1e-5, atol=1e-5)


def test_ssd_gradient_equals_the_reference_where_it_is_finite():
    (jy, jst, jg), (ty, tst, tg) = _ssd_both(0.01)
    assert np.isfinite(jg).all() and np.isfinite(tg).all()
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tst, jst, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# convert.lm_tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, over", [
    ("stablelm-1.6b", {}), ("deepseek-v3-671b", {}), ("mamba2-370m", {}),
    ("zamba2-2.7b", {}), ("kimi-k2-1t-a32b", {"param_dtype": "bfloat16"})])
def test_lm_tree_inverts_lm_params(arch, over):
    import dataclasses

    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(configs.get_config(arch, smoke=True), **over)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(2), jcfg))
    back = convert.lm_tree(convert.lm_params(tree, tcfg, device="cpu"))
    flat_w = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(back)[0]
    got = {jax.tree_util.keystr(p): v for p, v in flat_g}
    assert set(got) == {jax.tree_util.keystr(p) for p, _ in flat_w}
    for p, w in flat_w:
        g = got[jax.tree_util.keystr(p)]
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w.astype(np.float32))
