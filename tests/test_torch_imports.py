"""Boundaries of the PyTorch port.

* No file of ``src/repro_torch/``, not ``chip_smoke.py`` and not the
  kernel-variant scripts (``scripts/*_variants.py``) nor the dry-run
  scripts (``scripts/dryrun_*.py``) imports ``jax`` or the
  JAX package ``repro`` (an AST scan, so lazy imports inside functions
  count too).
* Entry points run on the CUDA device by default: with no CUDA device and
  no ``device="cpu"`` they raise instead of falling back to the CPU.
* Every port test module caps torch's threads under pytest-xdist
  (``tests/_torch_threads.cap``), and the cap shares the cores among the
  workers.
"""
import ast
import pathlib
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*_variants.py")) \
    + sorted((ROOT / "scripts").glob("dryrun_*.py"))


def _imported_modules(path: pathlib.Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_covers_the_slice_layout():
    """Each ported module sits at its JAX counterpart's path."""
    for rel in ("kernels/shapes.py", "kernels/gather_score.py",
                "kernels/ref.py", "kernels/int8_scan.py",
                "vectordb/predicates.py", "vectordb/algebra.py",
                "vectordb/table.py", "vectordb/histogram.py",
                "vectordb/flat.py", "vectordb/ivf.py", "vectordb/graph.py",
                "kernels/masked_topk.py", "kernels/ops.py",
                "kernels/beam_search.py", "core/query.py",
                "core/executor.py", "core/data_encoder.py",
                "core/query_encoder.py", "core/rewriter.py",
                "core/boomhq.py", "serve/batch.py", "common/nn.py",
                "train/optimizer.py", "bench/augment.py",
                "bench/datasets.py", "bench/queries.py",
                "vectordb/tiered.py", "serve/queue.py", "serve/semcache.py",
                "vectordb/distributed.py", "analysis/findings.py",
                "analysis/suppressions.py", "analysis/config.py",
                "analysis/astpass.py", "analysis/runner.py",
                "analysis/cli.py", "configs/__init__.py", "configs/base.py",
                "configs/stablelm_1_6b.py", "configs/gemma_7b.py",
                "configs/qwen3_14b.py", "configs/phi3_mini_3_8b.py",
                "configs/llava_next_mistral_7b.py",
                "configs/musicgen_large.py", "configs/zamba2_2_7b.py",
                "configs/kimi_k2_1t_a32b.py", "configs/deepseek_v3_671b.py",
                "configs/mamba2_370m.py", "models/rotary.py",
                "models/ffn.py", "models/attention.py", "models/lm.py",
                "models/lm_serving.py", "launch/serve.py",
                "models/mamba2.py", "models/moe.py",
                "models/moe_sharded.py", "train/step.py",
                "train/grad_compress.py", "checkpoint/ckpt.py",
                "data/pipeline.py", "launch/train.py", "launch/plans.py",
                "distributed/fault_tolerance.py"):
        assert (ROOT / "src" / "repro" / rel).exists(), rel
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel


def test_port_covers_the_mesh_slice():
    """The mesh slice's modules sit at their JAX counterparts' paths;
    ``launch/hlo_analysis.py`` (it reads XLA's HLO text) has none: the
    port's dry-run counts the operations it dispatches."""
    for rel in ("models/sharding.py", "launch/mesh.py",
                "launch/input_specs.py", "launch/dryrun.py",
                "launch/dryrun_boomhq.py", "distributed/elastic.py",
                "distributed/pipeline.py"):
        assert (ROOT / "src" / "repro" / rel).exists(), rel
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel
    assert (ROOT / "src" / "repro" / "launch" / "hlo_analysis.py").exists()
    assert not (ROOT / "src" / "repro_torch" / "launch" /
                "hlo_analysis.py").exists()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _numpy(node):
    if isinstance(node, dict):
        return {k: _numpy(v) for k, v in node.items()}
    return node.detach().numpy()


def _stack(nodes: list):
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return np.stack(nodes)


def _entry_points():
    """Each entry point as a call taking ``device=``; functions of tensors
    (``graph.build``, ``ops.masked_topk``) take the tensors of a table
    built on that device and must run where those tensors lie."""
    from repro_torch import configs, convert
    from repro_torch.bench import augment, datasets
    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.train import step
    from repro_torch.models import lm, lm_serving
    from repro_torch.vectordb import algebra, graph, predicates
    from repro_torch.vectordb.table import (
        ScalarCol, Table, TableSchema, VectorCol,
    )

    schema = TableSchema((VectorCol("v", 4),), (ScalarCol("s", "num"),))
    vec = [np.arange(12, dtype=np.float32).reshape(3, 4)]
    scal = np.zeros((3, 1), np.float32)

    def table(**kw):
        return Table.from_numpy(schema, vec, scal, **kw)

    def scan(**kw):
        t, p = table(**kw), predicates.Predicates.none(1, **kw)
        out = ops.masked_topk(t.vectors[0][0], t.vectors[0], t.scalars, p.lo,
                              p.hi, p.active, k=2)
        assert out[1].device == t.device
        assert out[1].tolist() == [2, 1]
        return out

    def build(**kw):
        t = table(**kw)
        g = graph.build(t.vectors[0], 8)
        assert g.neighbors.device == t.device
        return g

    lm_cfg = configs.get_config("qwen3-14b", smoke=True)
    ssm_cfg = configs.get_config("mamba2-370m", smoke=True)
    hybrid_cfg = configs.get_config("zamba2-2.7b", smoke=True)
    moe_cfg = configs.get_config("deepseek-v3-671b", smoke=True)

    def generate(cfg=lm_cfg, **kw):
        model = lm.LM(cfg, **kw)
        toks = lm_serving.greedy_generate(
            model, {"tokens": torch.zeros((1, 4), dtype=torch.int32,
                                          device=model.device)},
            steps=2, max_len=8)
        assert toks.device == model.device
        return toks

    def carried(cfg=lm_cfg, **kw):
        """A CPU model's parameters in JAX's layout (each stack's block
        leaves stacked on axis 0, the hybrid's shared block as it is),
        carried to ``**kw``'s device."""
        tree = _numpy(lm.param_tree(lm.LM(cfg, device="cpu")))
        for name in ("blocks", "dense_blocks", "moe_blocks"):
            if name in tree:
                tree[name] = _stack([tree[name][str(i)]
                                     for i in range(len(tree[name]))])
        return convert.lm_params(tree, cfg, **kw)

    def serve_main(arch, **kw):
        return serve.main(["--arch", arch, "--smoke", "--batch", "1",
                           "--prompt-len", "4", "--steps", "2"], **kw)

    def train_main(**kw):
        argv = ["--arch", "mamba2-370m", "--smoke", "--steps", "1",
                "--global-batch", "2", "--seq-len", "16"]
        losses = train.main(argv + [f"--device={kw['device']}"] if kw
                            else argv)
        assert len(losses) == 1
        return losses

    def restore(**kw):
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, 1, {"x": np.arange(3.0)})
            _, tree, _ = ckpt.restore(d, **kw)
        assert tree["x"].device.type == kw.get("device", "cuda")
        return tree

    return {
        "Table.from_numpy": lambda **kw: Table.from_numpy(schema, vec, scal,
                                                          **kw),
        "datasets.make": lambda **kw: datasets.make("part", rows=50, **kw),
        "Predicates.from_conditions": lambda **kw:
            predicates.Predicates.from_conditions(1, {0: (0.0, 1.0)}, **kw),
        "PredicateSet.from_clauses": lambda **kw:
            predicates.PredicateSet.from_clauses(1, [{0: (0.0, 1.0)}], **kw),
        "algebra.compile": lambda **kw: (algebra.col(0) > 1.0).compile(
            m=1, **kw),
        "convert.ivf_index": lambda **kw: convert.ivf_index(
            np.zeros((2, 4)), np.arange(3), np.asarray([0, 1, 3]), "dot",
            **kw),
        "convert.sharded_ivf": lambda **kw: convert.sharded_ivf(
            np.zeros((2, 2, 4)), np.asarray([[0, 1], [0, 0]]),
            np.asarray([[0, 1, 2], [0, 1, 1]]), "dot", **kw),
        "convert.graph_index": lambda **kw: convert.graph_index(
            np.asarray([[1, -1], [0, 2], [1, -1]]), np.asarray([0, 2]), "l2",
            **kw),
        "graph.build": build,
        "ops.masked_topk": scan,
        "lm.LM": lambda **kw: lm.LM(lm_cfg, **kw),
        "lm_serving.greedy_generate": generate,
        "augment.lm_embed": lambda **kw: augment.lm_embed(
            np.arange(12, dtype=np.float32).reshape(6, 2), 4, arch="qwen3-14b",
            seq=4, **kw),
        "launch.serve.main": lambda **kw: serve_main("qwen3-14b", **kw),
        "convert.lm_params": carried,
        "lm.LM[ssm]": lambda **kw: lm.LM(ssm_cfg, **kw),
        "lm_serving.greedy_generate[hybrid]": lambda **kw: generate(
            hybrid_cfg, **kw),
        "augment.lm_embed[ssm]": lambda **kw: augment.lm_embed(
            np.arange(12, dtype=np.float32).reshape(6, 2), 4,
            arch="mamba2-370m", seq=4, **kw),
        "launch.serve.main[ssm]": lambda **kw: serve_main("mamba2-370m",
                                                          **kw),
        "launch.serve.main[hybrid]": lambda **kw: serve_main("zamba2-2.7b",
                                                             **kw),
        "convert.lm_params[hybrid]": lambda **kw: carried(hybrid_cfg, **kw),
        "lm.make_cache[hybrid]": lambda **kw: lm.make_cache(hybrid_cfg, 1, 8,
                                                            **kw),
        "lm.LM[moe]": lambda **kw: lm.LM(moe_cfg, **kw),
        "lm_serving.greedy_generate[moe]": lambda **kw: generate(moe_cfg,
                                                                 **kw),
        "launch.serve.main[moe]": lambda **kw: serve_main("deepseek-v3-671b",
                                                          **kw),
        "launch.serve.main[kimi]": lambda **kw: serve_main("kimi-k2-1t-a32b",
                                                           **kw),
        "convert.lm_params[moe]": lambda **kw: carried(moe_cfg, **kw),
        "lm.make_cache[moe]": lambda **kw: lm.make_cache(moe_cfg, 1, 8, **kw),
        "launch.train.main": train_main,
        "step.init_state": lambda **kw: step.init_state(
            ssm_cfg, step.TrainPlan(), **kw),
        "ckpt.restore": restore,
    }


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_points_default_to_cuda(no_cuda, name):
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
    fn(device="cpu")  # the explicit CPU request is honoured


def test_boomhq_follows_its_table_and_builds_the_graph_tier():
    """BoomHQ builds every structure on its table's device — with the
    default config, the graph tier included (the port no longer refuses
    it) — and ``graph_degree=0`` leaves the tier unbound."""
    from repro_torch.bench import datasets
    from repro_torch.core.boomhq import BoomHQ, BoomHQConfig

    table = datasets.make("part", rows=64, device="cpu")
    bq = BoomHQ(table, BoomHQConfig())
    assert all(ix.centroids.device.type == "cpu" for ix in bq.indexes)
    assert next(bq.data_encoder.parameters()).device.type == "cpu"
    assert len(bq.graphs) == table.schema.n_vec
    for g in bq.graphs:
        assert g.neighbors.shape == (64, 16)
        assert g.neighbors.device.type == "cpu"
    assert bq.executor.graphs is bq.graphs
    assert bq._batched_executor().graphs == bq.graphs
    bq0 = BoomHQ(table, BoomHQConfig(n_clusters=4, graph_degree=0))
    assert bq0.graphs is None and bq0.executor.graphs is None


def test_cpu_tensors_take_the_plain_version_without_building():
    """A CPU tensor never reaches the kernel launcher (and so never builds
    or counts a launch)."""
    from repro_torch.kernels import gather_score as gs

    gs.reset_launches()
    cand = torch.tensor([[0, 1, -1, 2]], dtype=torch.int32)
    vec = (torch.eye(3, 4),)
    out = gs.gather_score_topk(cand, vec, (torch.ones(1, 4),),
                               torch.ones(1, 1), torch.zeros(3, 1), k=2)
    assert out[0].tolist() == [[0, 1]]
    assert gs.LAUNCHES == {"fp32": 0, "int8": 0}


def test_sharded_executor_follows_its_table():
    """The per-shard indexes a sharded executor builds lie on its table's
    device, and a sharded serving pass over CPU tensors launches nothing."""
    from repro_torch.bench import datasets
    from repro_torch.kernels import gather_score as gs
    from repro_torch.vectordb import distributed

    table = datasets.make("part", rows=64, device="cpu")
    sivf = distributed.build_sharded_ivf(table.vectors[0], 3, n_clusters=4)
    assert sivf.centroids.device.type == "cpu"
    assert (sivf.n_shards, sivf.shard_len) == (3, 22)
    gs.reset_launches()
    ids, _ = distributed.sharded_topk_ref(
        torch.zeros((2, 64)), torch.ones((2, 64), dtype=torch.bool), k=4,
        n_shards=3)
    assert ids.device.type == "cpu" and ids.tolist()[0] == [0, 1, 2, 3]
    assert gs.LAUNCHES == {"fp32": 0, "int8": 0}


@pytest.mark.parametrize("path", sorted((ROOT / "tests").glob(
    "test_torch_*.py")), ids=lambda p: p.name)
def test_port_test_modules_cap_torch_threads(path):
    """Each port test module calls ``_torch_threads.cap()`` when imported,
    so no pytest-xdist worker's torch sizes its pool to every core."""
    tree = ast.parse(path.read_text(), filename=str(path))
    calls = [n for n in tree.body if isinstance(n, ast.Expr)
             and isinstance(n.value, ast.Call)
             and getattr(n.value.func, "id", None) == "cap"]
    assert "_torch_threads" in _imported_modules(path) and calls, path.name


@pytest.mark.parametrize("workers, cores, want", [
    (None, 8, None), ("1", 8, None), ("6", 8, 1), ("2", 8, 4), ("12", 8, 1)])
def test_cap_shares_the_cores_among_xdist_workers(monkeypatch, workers,
                                                  cores, want):
    import _torch_threads

    before = torch.get_num_threads()
    try:
        if workers is None:
            monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
        else:
            monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
        monkeypatch.setattr(_torch_threads.os, "cpu_count", lambda: cores)
        torch.set_num_threads(3)
        _torch_threads.cap()
        assert torch.get_num_threads() == (want or 3)
    finally:
        torch.set_num_threads(before)
