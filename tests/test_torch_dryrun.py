"""The port's dry-run on torch's fake process group (no device memory).

* the ``stablelm`` and ``deepseek-v3`` smoke cells (train, prefill,
  decode; small batch and sequence) run on a (2, 2) mesh of the fake
  world and give a full record: FLOPs, bytes, collectives, peak, the
  roofline terms on the H100 constants and the dominant one;
* per-device FLOPs of the ``stablelm`` smoke train cell on (2, 2) are
  within 10% of a quarter of those on (1, 1): no compute is replicated
  over the mesh (the reference's "16x redundant attention");
* one dense block's forward on (2, 2) shows the Megatron all-reduces its
  specs imply: one after the attention's row-parallel ``wo`` and one
  after the FFN's ``w_down``, each of this rank's (B/2, S, D) activations,
  and no weight gathered;
* the peak grows with the batch;
* ``dryrun_boomhq``'s three variants run at a small ``--rows-per-dev``,
  the int8 DB a quarter of the f32 one, and the CLI writes its records;
* the witness cells (``launch.dryrun.WITNESS_CELLS``): the smallest
  smoke cells that gave each error torch 2.11 raised in the production
  cells, each on the fake world, each a whole record;
* no view that torch 2.11's DTensor refuses is dispatched on a DTensor in
  a smoke train step, prefill or decode of the uneven-head dense config,
  ``mamba2``, ``zamba2`` or ``deepseek-v3`` with the GShard MoE, forward
  or backward (``_refused_by_2_11``), on any torch.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun.py``.
"""
import contextlib
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

from repro_torch.launch import dryrun, dryrun_boomhq  # noqa: E402

SMALL = dict(global_batch=8, seq_len=64)
CELLS = [("stablelm-1.6b", "train_4k"), ("stablelm-1.6b", "prefill_32k"),
         ("stablelm-1.6b", "decode_32k"), ("deepseek-v3-671b", "train_4k"),
         ("deepseek-v3-671b", "decode_32k")]


def _cell(arch, shape, mesh=(2, 2), **kw):
    return dryrun.run_cell(arch, shape, mesh_shape=mesh, device_type="cpu",
                           smoke=True, verbose=False,
                           shape_overrides=kw.pop("shape_overrides", SMALL),
                           **kw)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cells_run_on_the_fake_world(arch, shape):
    rec = _cell(arch, shape)
    assert rec["mesh"] == "2x2" and rec["n_dev"] == 4
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["peak_bytes_per_dev"] >= rec["arg_bytes_per_dev"] > 0
    assert set(dryrun.COLLECTIVES) <= set(rec["collectives"])
    assert rec["collectives"]["total"] > 0
    terms = {k: rec[k] for k in ("compute_s", "memory_s", "collective_s")}
    assert rec["dominant"] == max(terms, key=terms.get)
    assert rec["compute_s"] == rec["flops_per_dev"] / 989e12
    assert 0 < rec["useful_flop_ratio"] <= 1.5


def test_flops_split_over_the_mesh():
    one = _cell("stablelm-1.6b", "train_4k", mesh=(1, 1))
    four = _cell("stablelm-1.6b", "train_4k", mesh=(2, 2))
    assert one["collectives"]["total"] == 0
    ratio = four["flops_per_dev"] / one["flops_per_dev"]
    assert abs(ratio - 0.25) <= 0.1 * 0.25, ratio


def test_dense_block_shows_megatron_all_reduces():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import configs
    from repro_torch.launch import input_specs
    from repro_torch.launch.mesh import _make_mesh, fake_world
    from repro_torch.models import lm, sharding
    from repro_torch.train.step import implicit_replication

    cfg = configs.get_config("stablelm-1.6b", smoke=True)
    b, s = 4, 32
    with fake_world(4):
        mesh = _make_mesh((2, 2), ("data", "model"), "cpu")
        model = input_specs.abstract_model(cfg)
        sharding.place_model(model, mesh, sharding.param_specs(cfg, model))
        x = sharding.place(torch.empty(b, s, cfg.d_model, device="meta"),
                           ("data", None, None), mesh)
        positions = torch.arange(s, dtype=torch.int32,
                                 device="meta").expand(b, s)
        counter = dryrun.DeviceCounter()
        with counter, implicit_replication(), \
                sharding.act_axes("data", mesh=mesh):
            y, _ = lm._block_prefill(lm.param_tree(model.blocks[0]), cfg, x,
                                     positions, None)
    rep = counter.report()["collectives"]
    local = (b // 2) * s * cfg.d_model * 4
    assert rep["counts"]["all-reduce"] == 2, rep
    assert rep["all-reduce"] == 2 * local, rep
    assert rep["counts"]["all-gather"] == 0, rep
    assert list(y.placements) == [Shard(0), Replicate()]


def test_peak_grows_with_the_batch():
    small = _cell("stablelm-1.6b", "train_4k", mesh=(1, 1),
                  shape_overrides=dict(global_batch=4, seq_len=64),
                  plan_overrides=dict(microbatches=1))
    big = _cell("stablelm-1.6b", "train_4k", mesh=(1, 1),
                shape_overrides=dict(global_batch=16, seq_len=64),
                plan_overrides=dict(microbatches=1))
    assert big["peak_bytes_per_dev"] > small["peak_bytes_per_dev"]
    assert big["peak_bytes_per_dev"] - big["arg_bytes_per_dev"] > \
        2 * (small["peak_bytes_per_dev"] - small["arg_bytes_per_dev"])


def test_boomhq_variants_and_the_cli(tmp_path):
    recs = {name: dryrun_boomhq.run_variant(
        name, rows_per_dev=2048, device_type="cpu", verbose=False, **kw)
        for name, kw in dryrun_boomhq.VARIANTS}
    for r in recs.values():
        assert r["rows"] == 2048 * 16 and r["n_dev"] == 256
        assert r["flops_per_dev_per_q"] > 0
        assert r["coll_bytes_per_dev_per_q"] > 0
        assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    c0, c1, c2 = (recs[n] for n, _ in dryrun_boomhq.VARIANTS)
    assert c2["db_gib_per_dev"] < c1["db_gib_per_dev"] / 3
    # a 64-query batch reads the DB once for 64 queries
    assert c1["bytes_per_dev_per_q"] < c0["bytes_per_dev_per_q"] / 8
    out = tmp_path / "cells.jsonl"
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "long_500k",
                        "--smoke", "--device-type", "cpu", "--out",
                        str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["skipped"] and rec["mesh"] == "16x16"


@pytest.mark.parametrize("cell", dryrun.WITNESS_CELLS,
                         ids=lambda c: dryrun.witness_id(c))
def test_witness_cells_give_whole_records(cell):
    rec = dryrun.run_witness(cell, device_type="cpu", verbose=False)
    assert rec["n_dev"] == cell["mesh"][0] * cell["mesh"][1]
    assert "skipped" not in rec and "error" not in rec
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["peak_bytes_per_dev"] >= rec["arg_bytes_per_dev"] > 0
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")


# ---------------------------------------------------------------------------
# torch 2.11's view rule, on any torch
# ---------------------------------------------------------------------------

def _view_groups(src, dst):
    """torch 2.11's ``view_groups`` (``torch/distributed/tensor/_ops/
    _view_ops.py:317-407``) on integer shapes: per output dim, ``("in",
    d)``, ``("flat", dims)``, ``("split", in, group_shape, idx)`` or
    ``("one",)``."""
    n = 1
    for v in src:
        n *= v
    dst = list(dst)
    if -1 in dst:
        known = -1
        for v in dst:
            known *= v
        dst[dst.index(-1)] = n // known
    out = []
    fi = ti = 0
    while fi < len(src) or ti < len(dst):
        fg, tg = [], []
        f = t = 1
        if fi < len(src):
            f = src[fi]
            fg.append(fi)
            fi += 1
        if ti < len(dst):
            t = dst[ti]
            tg.append(t)
            ti += 1
        if f == 1 and t != 1:
            ti -= 1
            tg = []
        elif f != 1 and t == 1:
            fi -= 1
            fg = []
        else:
            while f != t:
                if f < t:
                    f *= src[fi]
                    fg.append(fi)
                    fi += 1
                else:
                    t *= dst[ti]
                    tg.append(dst[ti])
                    ti += 1
        if not tg:
            continue
        dims = tuple(d for d in fg if src[d] >= 1)
        base = ("one",) if not dims else ("in", dims[0]) if len(dims) == 1 \
            else ("flat", dims)
        for i in range(len(tg)):
            if len(tg) == 1:
                out.append(base)
            elif tg[i] == 1:
                out.append(("one",))
            else:
                keep = [j for j, v in enumerate(tg) if v != 1]
                out.append(("split", base, tuple(tg[j] for j in keep),
                            keep.index(i)))
    return out


def _refused_by_2_11(shape, placements, mesh_sizes, dst):
    """Why torch 2.11's DTensor refuses a ``view`` / ``_unsafe_view`` of a
    DTensor of global ``shape`` and ``placements`` to ``dst``, or None.

    The rule is ``propagate_shape_and_sharding(..., strict_view=True)`` of
    ``torch/distributed/tensor/_ops/_view_ops.py`` in torch 2.11.0
    (``:504-694``); ``aten.view.default`` and ``aten._unsafe_view.default``
    are registered with ``strict_view=True`` (``:764-780``), the
    ``reshape`` that decomposes into them is not. An output dim that
    flattens input dims refuses a shard on any of them but the first, and
    an uneven shard on the first (``:565-603``); the first dim of a split
    refuses a shard of its input dim whose mesh dim does not divide its
    size (``:604-641``). A shard is looked up on the first mesh dim that
    shards the input dim (``:543-553``). torch 2.13 rewrites the first
    case to a ``_StridedShard`` and passes."""
    def shard_of(d):
        for i, p in enumerate(placements):
            if p.is_shard() and p.dim == d:
                return i
        return None

    def in_dim(cmd):
        if cmd[0] == "in":
            return cmd[1]
        if cmd[0] == "flat":
            for i, d in enumerate(cmd[1]):
                m = shard_of(d)
                if m is None:
                    continue
                if i > 0:
                    return f"flatten of the inner sharded dim {d}"
                if shape[d] % mesh_sizes[m]:
                    return f"flatten of the unevenly sharded dim {d}"
            return cmd[1][0]
        if cmd[0] == "split":
            d = in_dim(cmd[1])
            if isinstance(d, str) or cmd[3] != 0 or d is None:
                return d if isinstance(d, str) else None
            m = shard_of(d)
            if m is not None and cmd[2][0] % mesh_sizes[m]:
                return f"split of the sharded dim {d} into {cmd[2]}"
            return d
        return None

    for cmd in _view_groups(tuple(shape), tuple(dst)):
        why = in_dim(cmd)
        if isinstance(why, str):
            return why
    return None


class _ViewGuard:
    """A ``TorchDispatchMode`` that records each ``view``, ``_unsafe_view``,
    ``reshape``, ``flatten`` or ``unflatten`` dispatched on a DTensor, and
    those that ``_refused_by_2_11`` refuses, then lets DTensor run it. It
    sees the backward's operations too."""

    OPS = ("view", "_unsafe_view", "reshape", "flatten", "unflatten")

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        guard = self
        self.seen, self.refused = 0, []

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    x = args[0]
                    name = func._overloadpacket.__name__
                    if isinstance(x, DTensor) and name in guard.OPS:
                        guard.seen += 1
                        dst = func(torch.empty(x.shape, device="meta"),
                                   *args[1:], **(kwargs or {})).shape
                        why = _refused_by_2_11(
                            x.shape, x.placements, x.device_mesh.shape, dst)
                        if why is not None and name in ("view",
                                                        "_unsafe_view"):
                            guard.refused.append(
                                f"{func}: {tuple(x.shape)} "
                                f"{tuple(x.placements)} -> {tuple(dst)}: "
                                f"{why}")
                    return NotImplemented
                return func(*args, **(kwargs or {}))

        self.mode = _Mode()


def _guarded(arch, shape, over, mesh=(2, 4)):
    from repro_torch.launch.mesh import _make_mesh, fake_world

    guard = _ViewGuard()
    with fake_world(mesh[0] * mesh[1]):
        m = _make_mesh(mesh, ("data", "model"), "cpu")
        fn, _, _ = dryrun.build_cell(
            arch, shape, m, torch.device("meta"), cfg_overrides=over,
            plan_overrides=dict(microbatches=2),
            shape_overrides=dict(global_batch=8, seq_len=64), smoke=True)
        with guard.mode:
            fn()
    return guard


def test_view_guard_refuses_what_2_11_refuses():
    from torch.distributed.tensor import Replicate, Shard

    assert _refused_by_2_11((8, 4, 16), (Shard(0), Shard(1)), (2, 4),
                            (32, 16)).startswith("flatten of the inner")
    assert _refused_by_2_11((8, 10), (Shard(0), Shard(1)), (2, 4),
                            (8, 5, 2)).startswith("split")
    assert _refused_by_2_11((8, 40), (Shard(0), Shard(1)), (2, 4),
                            (8, 8, 5)) is None
    assert _refused_by_2_11((8, 4, 16), (Shard(0), Replicate()), (2, 4),
                            (32, 16)) is None
    # the parent's mamba decode: (B, H, N, P) over (data, model) flattened
    guard = _ViewGuard()
    from repro_torch.launch.mesh import _make_mesh, fake_world
    from repro_torch.models import sharding

    with fake_world(8):
        m = _make_mesh((2, 4), ("data", "model"), "cpu")
        st = sharding.place(torch.zeros(4, 8, 3, 2, device="meta"),
                            ("data", "model", None, None), m)
        # torch 2.11 raises here, after the guard has seen it
        with guard.mode, contextlib.suppress(RuntimeError):
            st.reshape(32, 3, 2)
    assert guard.seen == 1 and len(guard.refused) == 1, guard.refused


GUARDED = [("qwen3-14b", dict(n_heads=10, n_kv_heads=2)),
           ("mamba2-370m", {}), ("zamba2-2.7b", {}),
           ("deepseek-v3-671b", dict(moe_impl="gshard", moe_group_tokens=4))]


@pytest.mark.parametrize("arch,over", GUARDED, ids=[a for a, _ in GUARDED])
def test_no_view_that_torch_2_11_refuses(arch, over):
    seen, refused = 0, []
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        guard = _guarded(arch, shape, over)
        seen += guard.seen
        refused += [f"{shape}: {r}" for r in guard.refused]
    assert seen > 0
    assert not refused, "\n".join(refused)
