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
  the int8 DB a quarter of the f32 one, and the CLI writes its records.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun.py``.
"""
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
