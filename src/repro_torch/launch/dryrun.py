"""Dry-run: what one rank of the production mesh would do in each (arch ×
shape × mesh) cell, with no device memory allocated.

Port of ``repro.launch.dryrun``. For each cell this builds the 16×16
``(data, model)`` mesh (or 2×16×16 ``(pod, data, model)``) on torch's fake
process group in one process (``launch/mesh.fake_world``: this process is
rank 0, every collective returns at once), makes the cell's parameters,
optimizer state, batch and caches as meta tensors (shapes and dtypes, no
storage; the model through ``lm.LM(device="meta")``, which draws
nothing) placed as DTensors by ``models/sharding.py``'s specs, runs the
port's real train, prefill or decode step on them, and counts what rank
0 dispatches (``DeviceCounter``). Meta tensors, not ``FakeTensorMode``:
under that mode DTensor's own bookkeeping of a ``_StridedShard`` (torch
2.13) reads a fake tensor back to the host and raises; meta tensors carry
the same shapes through the same operations.
  * FLOPs of its local operations (``torch.utils.flop_counter``'s
    formulas on the local shards; DTensor's own shape inference, which
    runs each operation once at the global shape, is not counted);
  * bytes read and written by those operations (every tensor input and
    output of an operation that is not a view);
  * collective bytes by kind, as the reference counts them from HLO: the
    result's bytes (≈ received per device), a reduce-scatter's input;
  * peak live bytes: the storages alive at once, from the state, batch
    and caches the step starts with to the transients it makes
    (autograd's saved tensors included), read beside the card's 80 GB;
  * the derived roofline terms on one H100 SXM's published peaks at its
    700 W power limit (``H100_*`` below), and the dominant one.

The reference reads XLA's per-device HLO after compilation and needs
``launch/hlo_analysis.py`` to multiply loop bodies by their trip counts;
the port's counts come from the operations it dispatches, so every
iteration of a Python loop (layers, microbatches, attention chunks) is
counted as it runs, and no counterpart of ``hlo_analysis`` is needed.

Every figure is a dry-run prediction on the fake world, not a
measurement. Callers that already hold a process group run this in a
child process (one default group a process).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --out cells.jsonl
(no card needed; ``--device-type`` names the fake mesh's device type,
``cuda`` by default, ``cpu`` where torch has no CUDA).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import weakref

import torch

from repro_torch.configs.base import SHAPES, get_config, shape_applicable
from repro_torch.launch import input_specs
from repro_torch.launch.mesh import (PRODUCTION, data_axes, fake_world,
                                     make_production_mesh)
from repro_torch.launch.plans import (prefill_cfg_overrides,
                                      train_cfg_overrides, train_plan)
from repro_torch.models import lm, sharding
from repro_torch.train import step as tstep

# one H100 SXM's published peaks, at its 700 W power limit; a card set
# below 700 W runs slower under load
H100_PEAK_FLOPS = 989e12  # bf16 dense, FLOP/s
H100_HBM_BW = 3.35e12  # bytes/s
H100_LINK_BW = 450e9  # bytes/s, NVLink, each way
H100_HBM_GB = 80.0  # device memory, 1e9 bytes
POWER_LIMIT_W = 700

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# dispatched op name -> (kind, which tensors' bytes count)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "allgather_": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", "out"),
    "all_reduce": ("all-reduce", "out"),
    "all_reduce_coalesced": ("all-reduce", "out"),
    "allreduce_": ("all-reduce", "out"),
    "allreduce_coalesced_": ("all-reduce", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "reduce_scatter_": ("reduce-scatter", "in"),
    "_reduce_scatter_base_": ("reduce-scatter", "in"),
    "all_to_all_single": ("all-to-all", "out"),
    "alltoall_": ("all-to-all", "out"),
    "alltoall_base_": ("all-to-all", "out"),
    "recv_": ("collective-permute", "out"),
}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _group_size(name: str, args) -> int | None:
    """The size of a collective's process group: from its name (the
    functional collectives), or from its tensors (``c10d``'s gathers)."""
    from torch.distributed import distributed_c10d as c10d

    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
    if name == "allgather_" and args and args[0]:
        return len(args[0][0])
    if name == "_allgather_base_":
        return args[0].numel() // max(1, args[1].numel())
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceCounter:
    """A dispatch mode counting one rank's local operations: FLOPs,
    bytes, collectives by kind, and the peak of the live storages. DTensor
    operations pass through to DTensor, whose local operations are then
    counted; DTensor's shape inference at the global shape is skipped."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakKeyDictionary()
        self._inferring = 0
        self._flops = flop_registry

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if not counter._inferring:
                    counter._count(func, args, kwargs or {}, out)
                return out

        self._mode = _Mode()

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (DTensors: their local
        shards) as live, as a step's inputs are."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(tree):
            self._track(t._local_tensor if isinstance(t, DTensor) else t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _count(self, func, args, kwargs, out) -> None:
        pk = func._overloadpacket
        name = pk.__name__
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None and func.namespace in ("_c10d_functional",
                                                   "c10d"):
            if _group_size(name, args) == 1:
                return  # a one-rank group moves nothing
            kind, which = coll
            ts = _tensors(out) if which == "out" else _tensors(args[:1])
            self.collectives[kind] += sum(_nbytes(t) for t in ts)
            self.counts[kind] += 1
            return
        if pk in self._flops:
            self.flops += self._flops[pk](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        ret = func._schema.returns
        view = bool(ret) and ret[0].alias_info is not None \
            and not ret[0].alias_info.is_write
        if not view:
            self.bytes += sum(_nbytes(t) for t in _tensors(args)
                              + _tensors(kwargs) + outs)
        for t in outs:
            self._track(t)

    def __enter__(self):
        from torch.distributed.tensor import _sharding_prop as sp

        prop = sp.ShardingPropagator
        name = next(n for n in ("_propagate_tensor_meta_non_cached",
                                "_propagate_tensor_meta")
                    if hasattr(prop, n))
        inner = getattr(prop, name)
        counter = self

        def inferring(*a, **kw):
            counter._inferring += 1
            try:
                return inner(*a, **kw)
            finally:
                counter._inferring -= 1

        self._patched = (prop, name, inner)
        setattr(prop, name, inferring)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        prop, name, inner = self._patched
        setattr(prop, name, inner)
        return False

    def report(self) -> dict:
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives.values())
        coll["counts"] = dict(self.counts)
        return dict(flops=float(self.flops), bytes=float(self.bytes),
                    collectives=coll, peak_bytes=self.peak)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _fake_tree(tree, device):
    """A dict tree of meta tensors as zeros of their shapes and dtypes on
    ``device`` (the meta device: nothing is allocated)."""
    if isinstance(tree, dict):
        return {k: _fake_tree(v, device) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


@torch.no_grad()
def _fake_model(model: lm.LM, device, dtype=None) -> lm.LM:
    """``model``'s parameters replaced by zeros of their shapes on
    ``device`` (every floating leaf in ``dtype`` where given)."""
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        mod = model.get_submodule(".".join(path))
        dt = dtype if dtype is not None and p.is_floating_point() \
            else p.dtype
        mod._parameters[leaf] = torch.nn.Parameter(
            torch.zeros(p.shape, dtype=dt, device=device),
            requires_grad=p.requires_grad)
    return model


def _place_batch(cfg, batch: dict, daxes, mesh, device) -> dict:
    fake = _fake_tree(batch, device)
    return sharding.place_tree(fake, sharding.batch_specs(cfg, fake, daxes),
                               mesh)


def build_cell(arch: str, shape_name: str, mesh, device, cfg_overrides=None,
               plan_overrides=None, shape_overrides=None, smoke=False):
    """-> (fn, state, meta): ``fn()`` runs the cell's step once on fake
    DTensors placed on ``mesh`` (``device``: the meta device);
    ``state`` the tensors the step starts with."""
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    if cfg_overrides is None or "baseline" not in (cfg_overrides or {}):
        auto = (train_cfg_overrides(arch) if shape.step == "train"
                else prefill_cfg_overrides(arch) if shape.step == "prefill"
                else {})
        cfg = dataclasses.replace(cfg, **auto)
    if cfg_overrides:
        cfg_overrides = {k: v for k, v in cfg_overrides.items()
                         if k != "baseline"}
        if cfg_overrides:
            cfg = dataclasses.replace(cfg, **cfg_overrides)
    daxes = data_axes(mesh)
    bax = daxes if len(daxes) > 1 else daxes[0]

    if shape.step == "train":
        plan = train_plan(arch)
        if plan_overrides:
            plan = dataclasses.replace(plan, **plan_overrides)
        act = sharding.activation_spec(daxes, seq_shard=True) \
            if plan.seq_shard_acts else None
        model = input_specs.abstract_model(cfg)
        pdt = getattr(torch, plan.param_dtype) \
            if plan.param_dtype != "float32" else None
        model, opt = tstep.shard_state(_fake_model(model, device, pdt),
                                       plan, mesh)
        pspec = sharding.param_specs(cfg, model, fsdp=plan.fsdp)
        batch = _place_batch(cfg, input_specs.batch_struct(
            cfg, shape, with_labels=True), daxes, mesh, device)
        step = sharding.with_act_axes(
            tstep.make_train_step(cfg, plan, act_spec=act, batch_axes=daxes,
                                  grad_specs=pspec), bax, mesh=mesh)
        state = {"params": dict(model.named_parameters()), "opt": opt,
                 "batch": batch}
        tokens = shape.global_batch * shape.seq_len
        return (lambda: step(model, opt, batch), state,
                {"tokens": tokens,
                 "model_flops": 6.0 * cfg.n_active_params() * tokens})

    # serving shards weights over data too for the moe family
    # (weight-stationary), as the reference's cells do; every floating
    # parameter bf16, the caches in the compute dtype (bf16 at full size,
    # as the reference's; a smoke config's f32)
    model = _fake_model(input_specs.abstract_model(cfg), device,
                        torch.bfloat16)
    pspec = sharding.param_specs(cfg, model, fsdp=cfg.family == "moe",
                                 moe_shard_ffn_dim=True)
    sharding.place_model(model, mesh, pspec)
    params = dict(model.named_parameters())
    if shape.step == "prefill":
        batch = _place_batch(cfg, input_specs.batch_struct(
            cfg, shape, with_labels=False), daxes, mesh, device)
        cache = _fake_tree(lm.make_cache(
            cfg, shape.global_batch, shape.seq_len,
            dtype=lm.compute_dtype(cfg), device="meta"), device)
        cache = sharding.place_tree(
            cache, sharding.cache_specs(cfg, cache, daxes), mesh)
        step = sharding.with_act_axes(
            lambda: lm.prefill(model, batch, shape.seq_len, cache=cache),
            bax, mesh=mesh)
        tokens = shape.global_batch * shape.seq_len
        return (_replicating(step, params),
                {"params": params, "batch": batch, "cache": cache},
                {"tokens": tokens,
                 "model_flops": 2.0 * cfg.n_active_params() * tokens})

    shard_batch = shape.global_batch > 1
    inputs, _, _ = input_specs.decode_structs(cfg, shape)
    cache = lm.make_cache(cfg, shape.global_batch, shape.seq_len,
                          dtype=lm.compute_dtype(cfg), device="meta")
    inputs = _fake_tree(inputs, device)
    inputs = sharding.place_tree(inputs, {
        k: (bax, *([None] * (v.ndim - 1))) if shard_batch else ()
        for k, v in inputs.items()}, mesh)
    cache = _fake_tree(cache, device)
    cache = sharding.place_tree(cache, sharding.cache_specs(
        cfg, cache, daxes, shard_batch=shard_batch), mesh)
    pos = shape.seq_len - 1
    step = sharding.with_act_axes(
        lambda: lm.decode_step(model, inputs, pos, cache),
        bax if shard_batch else None, mesh=mesh)
    tokens = shape.global_batch
    return (_replicating(step, params),
            {"params": params, "inputs": inputs, "cache": cache},
            {"tokens": tokens,
             "model_flops": 2.0 * cfg.n_active_params() * tokens})


def _replicating(fn, params: dict):
    def run():
        with tstep.mesh_scope(params):
            return fn()
    return run


def mesh_name(mesh_shape) -> str:
    return "x".join(str(n) for n in mesh_shape)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh_shape=None, device_type: str = "cuda",
             verbose: bool = True, cfg_overrides=None, plan_overrides=None,
             shape_overrides=None, smoke: bool = False, tag: str = ""
             ) -> dict:
    """One cell's record (or ``{"skipped": why}``). ``mesh_shape`` (n_data,
    n_model) replaces the production mesh (tests: (1, 1), (2, 2))."""
    from repro_torch.launch.mesh import _make_mesh

    cfg = get_config(arch, smoke=smoke)
    ok, why = shape_applicable(cfg, shape_name)
    shape, axes = ((tuple(mesh_shape), ("data", "model"))
                   if mesh_shape is not None else PRODUCTION[multi_pod])
    name = mesh_name(shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "skipped": why}
    n_dev = 1
    for n in shape:
        n_dev *= n
    t0 = time.perf_counter()
    with fake_world(n_dev):
        mesh = (_make_mesh(shape, axes, device_type) if mesh_shape is not None
                else make_production_mesh(multi_pod=multi_pod,
                                          device_type=device_type))
        fn, state, meta = build_cell(
            arch, shape_name, mesh, torch.device("meta"), cfg_overrides,
            plan_overrides, shape_overrides, smoke)
        t_build = time.perf_counter() - t0
        counter = DeviceCounter()
        counter.hold(state)
        arg_bytes = counter.live
        with counter:
            fn()
        del fn, state
    t_run = time.perf_counter() - t0 - t_build
    rep = counter.report()
    flops_dev, bytes_dev = rep["flops"], rep["bytes"]
    coll = rep["collectives"]
    model_flops_dev = meta["model_flops"] / n_dev
    terms = {"compute_s": flops_dev / H100_PEAK_FLOPS,
             "memory_s": bytes_dev / H100_HBM_BW,
             "collective_s": coll["total"] / H100_LINK_BW}
    dom = max(terms, key=terms.get)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": name, "n_dev": n_dev,
        "tag": tag, "smoke": smoke,
        "flops_per_dev": flops_dev, "bytes_per_dev": bytes_dev,
        "collectives": coll,
        "arg_bytes_per_dev": arg_bytes,
        "peak_bytes_per_dev": rep["peak_bytes"],
        "peak_hbm_gib": rep["peak_bytes"] / 2**30,
        "fits_80gb": rep["peak_bytes"] <= H100_HBM_GB * 1e9,
        "model_flops_per_dev": model_flops_dev,
        "useful_flop_ratio": (model_flops_dev / flops_dev if flops_dev
                              else 0.0),
        **terms, "dominant": dom,
        "build_s": t_build, "run_s": t_run,
        "constants": "H100 SXM published peaks at 700 W (dry-run "
                     "prediction on the fake world)",
    }
    if verbose:
        print(f"[{arch} × {shape_name} × {name}] flops/dev={flops_dev:.3e} "
              f"bytes/dev={bytes_dev:.3e} coll/dev={coll['total']:.3e}B "
              f"peak={rec['peak_hbm_gib']:.2f}GiB | "
              f"compute={terms['compute_s'] * 1e3:.1f}ms "
              f"memory={terms['memory_s'] * 1e3:.1f}ms "
              f"coll={terms['collective_s'] * 1e3:.1f}ms -> {dom} | "
              f"useful={rec['useful_flop_ratio']:.2f} (build "
              f"{t_build:.1f}s run {t_run:.1f}s)", flush=True)
    return rec


# The smallest cells that gave each error torch 2.11's DTensor raised in
# the production cells (``scripts/dryrun_all.py`` on the card's machine),
# smoke configs on the fake world that keep the production cell's
# divisibility: heads a ``model`` rank, rows a data rank and microbatch,
# ``moe_group_tokens`` groups a row (fewer microbatches where the plan's
# count only repeats the same step). ``refused``: what 2.11 refused there
# before the port ran these paths per rank.
WITNESS_CELLS = tuple(
    dict(arch=a, shape=s, mesh=m, batch=b, microbatches=mb, cfg=c, refused=r)
    for a, s, m, b, mb, c, r in (
        ("mamba2-370m", "train_4k", (2, 2), 32, None, None,
         "IndexError in the conv's pad (2 heads, 8 rows)"),
        ("mamba2-370m", "prefill_32k", (2, 2), 32, None, None,
         "IndexError in the conv's pad"),
        ("mamba2-370m", "decode_32k", (2, 2), 32, None, None,
         "flatten of the sharded heads in the state's einsum"),
        ("zamba2-2.7b", "train_4k", (2, 4), 4, 2, None,
         "IndexError in the conv's pad (1 row)"),
        ("zamba2-2.7b", "train_4k", (4, 2), 4, 2, None,
         "a microbatch of 2 rows over 4 data ranks (2x16x16: 16 over 32)"),
        ("zamba2-2.7b", "prefill_32k", (2, 4), 32, None, None,
         "IndexError in the conv's pad"),
        ("zamba2-2.7b", "decode_32k", (2, 4), 32, None, None,
         "flatten of the sharded heads in the state's einsum"),
        ("deepseek-v3-671b", "prefill_32k", (2, 4), 32, None,
         dict(moe_group_tokens=4),
         "flatten of the sharded experts in the combine (16 groups a row)"),
        ("kimi-k2-1t-a32b", "prefill_32k", (2, 4), 32, None,
         dict(moe_group_tokens=4),
         "flatten of the sharded experts in the combine"),
        ("kimi-k2-1t-a32b", "train_4k", (2, 2), 32, None, None,
         "a view of a permuted local shard in the backward (1 kv head)"),
        ("qwen3-14b", "train_4k", (2, 4), 32, None,
         dict(n_heads=10, n_kv_heads=2),
         "split of the sharded merged heads in the backward (uneven heads)"),
        ("qwen3-14b", "train_4k", (4, 2), 4, 2, None,
         "a microbatch of 2 rows over 4 data ranks (2x16x16: 16 over 32)"),
        ("gemma-7b", "train_4k", (2, 4), 8, 2, None,
         "a view of a permuted local shard in the backward (1 head, 2 "
         "rows)"),
    ))


def witness_id(cell: dict) -> str:
    over = "".join(f"-{k}{v}" for k, v in (cell["cfg"] or {}).items())
    return f"{cell['arch']}-{cell['shape']}-{mesh_name(cell['mesh'])}{over}"


def run_witness(cell: dict, **kw) -> dict:
    """``run_cell`` of one of ``WITNESS_CELLS`` at sequence length 64
    (``kw``: ``device_type``, ``verbose``)."""
    mb = cell["microbatches"]
    return run_cell(cell["arch"], cell["shape"], mesh_shape=cell["mesh"],
                    smoke=True, cfg_overrides=cell["cfg"],
                    shape_overrides=dict(global_batch=cell["batch"],
                                         seq_len=64),
                    plan_overrides=None if mb is None
                    else dict(microbatches=mb),
                    tag=witness_id(cell), **kw)


def _parse_over(items) -> dict:
    out = {}
    for it in items:
        k, v = it.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out


def _where(e: BaseException) -> list:
    """The frames of ``e``'s traceback in this package, outermost first
    (``path:line function``)."""
    import traceback

    return [f"{f.filename.rsplit('src/', 1)[-1]}:{f.lineno} {f.name}"
            for f in traceback.extract_tb(e.__traceback__)
            if "repro_torch" in f.filename]


def main(argv=None) -> int:
    from repro_torch import configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value")
    ap.add_argument("--plan-set", action="append", default=[],
                    help="train-plan override key=value")
    ap.add_argument("--tag", default="", help="label for the record")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs")
    ap.add_argument("--device-type", default="cuda",
                    help="the fake mesh's device type")
    args = ap.parse_args(argv)
    cfg_over = _parse_over(args.set)
    plan_over = _parse_over(args.plan_set)
    if args.all:
        cells = [(a, s) for a in configs.ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               device_type=args.device_type,
                               cfg_overrides=cfg_over or None,
                               plan_overrides=plan_over or None,
                               smoke=args.smoke, tag=args.tag)
            except Exception as e:  # noqa: BLE001 — recorded, then exit 1
                rec = {"arch": arch, "shape": shape,
                       "mesh": mesh_name(PRODUCTION[mp][0]),
                       "error": f"{type(e).__name__}: {e}",
                       "where": _where(e)}
                failures.append(rec)
                print(f"[{arch} × {shape}] FAILED: {rec['error']}",
                      flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    if failures:
        print(f"{len(failures)} cells failed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
