"""The mesh path of the port over four ``gloo`` ranks, against JAX's
``shard_map`` and against the port's logical shards.

One module fixture runs two programs of this file, each in its own
processes, once for the module:

* a JAX process on four host devices
  (``--xla_force_host_platform_device_count=4``) runs the reference's four
  mesh functions on seeded numpy inputs — ``sharded_masked_scan``,
  ``sharded_masked_scan_batched`` (fp32 dot, fp32 l2, int8),
  ``sharded_batch_topk`` and ``sharded_ivf_topk`` (one and two columns,
  its own ``ShardedIVF``) on a ``data`` mesh, and the batched scan and the
  batch top-k on a ``(data, model)`` mesh of (2, 2), sharded over
  ``("data",)`` and over both axes — and the int8 accumulators;
* four port ranks (``gloo``, a ``file://`` store, one thread each) run the
  port's mesh functions on the same inputs, each with its own rows and its own
  shard of the reference's ``ShardedIVF`` (``convert.sharded_ivf(shard=)``),
  then ``BatchedHybridExecutor(mesh=...)`` on the 1,500-row ``part`` of
  ``tests/test_torch_sharded.py``. Every rank's table holds NaN in the
  other ranks' rows, so a sharded route that read them would fail.

The mesh functions must equal JAX: ids equal, scores within 1e-5, the int8
accumulators bit for bit; every rank the same. The executor over the mesh
must equal the port's logical ``n_shards=4`` executor on the same
per-shard indexes — under forced per-shard probing, forced dense and the
exact mode: ids equal, scores within 1e-5, the same escalated queries and
the same flagged shards — including a case where the boundary rule
flags one shard and the retry's gather runs with the other ranks
unflagged. Then the claims of ``tests/test_sharded_ivf.py`` on a mesh:
at generous budgets, on indexes each rank builds itself, every query
meets the exact oracle.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_mesh.py``.
"""
import contextlib
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

N_RANKS = 4
ROWS, DIM, M, Q, K = 512, 16, 3, 4, 12
PART_ROWS = 1500  # tests/test_torch_sharded.py's part fixture
TIMEOUT_S = 240
IVF_CASES = {  # name -> subs: (pos, k_i, ks, nprobe, max_scan) a column
    "ivf1": ((0, 16, 16, 4, 64),),
    "ivf2": ((0, 16, 32, 2, 64), (1, 16, 32, 2, 64)),
}
SCORE_TOL = dict(atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# meshes inside the test process (the other port test files import these)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def one_rank_mesh(store_dir):
    """A one-rank ``gloo`` world and its ``(data,)`` mesh in this process,
    destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{store_dir}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_mesh(n_ranks: int, rank: int = 0):
    """Rank ``rank`` of an ``n_ranks`` ``(data,)`` mesh whose collectives do
    nothing (torch's fake process group): enough to check what is refused
    before any collective runs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n_ranks)
    try:
        yield init_device_mesh("cpu", (n_ranks,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# inputs shared by both programs
# ---------------------------------------------------------------------------

def _inputs() -> dict:
    rng = np.random.default_rng(21)
    x = {f"v{i}": rng.normal(size=(ROWS, DIM)).astype(np.float32)
         for i in range(2)}
    for i in range(2):
        sc = np.maximum(np.abs(x[f"v{i}"]).max(axis=1), 1e-12) / 127.0
        x[f"v8_{i}"] = np.clip(np.round(x[f"v{i}"] / sc[:, None]), -127,
                               127).astype(np.int8)
        x[f"sc{i}"] = sc.astype(np.float32)
        x[f"q{i}"] = rng.normal(size=(Q, DIM)).astype(np.float32)
    x["scal"] = rng.uniform(0, 1, (ROWS, M)).astype(np.float32)
    x["w"] = rng.uniform(0.2, 1.0, (Q, 2)).astype(np.float32)
    x["w_scores"] = rng.normal(size=(Q, ROWS)).astype(np.float32)
    x["bounds"] = np.sort(rng.uniform(0, 1, (Q, 2, 2)), axis=-1).astype(
        np.float32)
    return x


def _pad_total(subs, rrf_union_total) -> int:
    """The probing search's candidate width: one column's 64, or the
    multi-column union's (the package's ``rrf_union_total``)."""
    return rrf_union_total(sum(s[1] for s in subs)) if len(subs) > 1 else 64


def _clauses(b) -> list:
    """Query j's two-clause DNF from its drawn bounds."""
    return [{0: (float(b[0, 0]), float(b[0, 1]))},
            {1: (float(b[1, 0]), float(b[1, 1]))}]


# ---------------------------------------------------------------------------
# the reference program: JAX's shard_map on four host devices
# ---------------------------------------------------------------------------

def _jax_reference(d: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.core.executor import rrf_union_total
    from repro.vectordb import distributed as jd
    from repro.vectordb import predicates as jp
    from repro.vectordb.predicates import Predicates, PredicateSet

    x = dict(np.load(f"{d}/inputs.npz"))
    devs = np.array(jax.devices()[:N_RANKS])
    mesh = Mesh(devs, ("data",))
    mesh22 = Mesh(devs.reshape(2, 2), ("data", "model"))
    vecs = tuple(jnp.asarray(x[f"v{i}"]) for i in range(2))
    v8s = tuple(jnp.asarray(x[f"v8_{i}"]) for i in range(2))
    scales = tuple(jnp.asarray(x[f"sc{i}"]) for i in range(2))
    scal = jnp.asarray(x["scal"])
    qs = tuple(jnp.asarray(x[f"q{i}"]) for i in range(2))
    w = jnp.asarray(x["w"])
    preds = jp.stack([PredicateSet.from_clauses(M, _clauses(b))
                      for b in x["bounds"]])
    out = {}

    def keep(name, ids, scores):
        out[f"{name}_ids"] = np.asarray(ids)
        out[f"{name}_s"] = np.asarray(scores)

    with mesh:
        keep("scan", *jd.sharded_masked_scan(mesh, k=10, n_vec=2)(
            vecs, scal, Predicates.from_conditions(M, {0: (0.2, 0.8)}),
            tuple(q[0] for q in qs), w[0]))
        for metric in ("dot", "l2"):
            keep(f"batched_{metric}", *jd.sharded_masked_scan_batched(
                mesh, k=K, n_vec=2, metric=metric)(
                vecs, None, scal, preds, qs, w))
        keep("batched_int8", *jd.sharded_masked_scan_batched(
            mesh, k=K, n_vec=2, int8=True)(v8s, scales, scal, preds, qs, w))
        keep("batch_topk", *jd.sharded_batch_topk(mesh, k=K)(
            jnp.asarray(x["w_scores"]), scal, preds))
        sivfs = [jd.build_sharded_ivf(vecs[c], N_RANKS, n_clusters=8,
                                      seed=3 + c) for c in range(2)]
        for c, s in enumerate(sivfs):
            out[f"sivf{c}_c"] = np.asarray(s.centroids)
            out[f"sivf{c}_r"] = np.asarray(s.sorted_rows)
            out[f"sivf{c}_o"] = np.asarray(s.offsets)
        for name, subs in IVF_CASES.items():
            cols = len(subs)
            fn = jd.sharded_ivf_topk(N_RANKS, mesh, ("data",), subs=subs,
                                     k=K, n_cols=cols, metric="dot",
                                     pad_total=_pad_total(subs,
                                                          rrf_union_total))
            ids, sc, fill, bnd = fn(
                tuple(s.centroids for s in sivfs[:cols]),
                tuple(s.sorted_rows for s in sivfs[:cols]),
                tuple(s.offsets for s in sivfs[:cols]), vecs[:cols], scal,
                preds, qs[:cols], w[:, :cols])
            keep(name, ids, sc)
            out[f"{name}_fill"] = np.asarray(fill)
            out[f"{name}_bnd"] = np.asarray(bnd)
    with mesh22:
        keep("mesh22_batched", *jd.sharded_masked_scan_batched(
            mesh22, ("data",), k=K, n_vec=2)(vecs, None, scal, preds, qs, w))
        keep("mesh22_batch_topk", *jd.sharded_batch_topk(
            mesh22, ("data", "model"), k=K)(
            jnp.asarray(x["w_scores"]), scal, preds))
    # the int8 path's integer accumulators, as its local body forms them
    for i in range(2):
        qsc = jnp.maximum(jnp.max(jnp.abs(qs[i]), axis=-1), 1e-12) / 127.0
        q8 = jnp.clip(jnp.round(qs[i] / qsc[:, None]), -127, 127
                      ).astype(jnp.int8)
        out[f"q8_{i}"] = np.asarray(q8)
        out[f"acc_{i}"] = np.asarray(jnp.einsum(
            "nd,qd->qn", v8s[i], q8, preferred_element_type=jnp.int32))
    np.savez(f"{d}/jax.npz", **out)


# ---------------------------------------------------------------------------
# the port's program: one gloo rank
# ---------------------------------------------------------------------------

def _mixed_wl(qmod, t, seed):
    return qmod.gen_workload(t, 5, n_vec_used=2, seed=seed) + \
        qmod.gen_dnf_workload(t, 5, n_vec_used=2, seed=seed + 1,
                              clause_counts=(2, 3, 4))


def _plan(t, **kw):
    from repro_torch.core.query import ExecutionPlan, SubqueryParams

    return ExecutionPlan("index_scan", tuple(
        SubqueryParams(iterative=False, **kw) for _ in range(t.schema.n_vec)))


def _boundary_table(device="cpu"):
    """800 rows over four shards, shard 1's rows carrying a strong
    query-direction component (the reference's boundary fixture at four
    shards), and one unfiltered query along that direction."""
    from repro_torch.core.query import MHQ
    from repro_torch.vectordb.predicates import Predicates
    from repro_torch.vectordb.table import (
        ScalarCol, Table, TableSchema, VectorCol,
    )

    rng = np.random.default_rng(5)
    n, d, per = 800, 16, 200
    qdir = rng.normal(size=(d,)).astype(np.float32)
    qdir /= np.linalg.norm(qdir)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs[per: 2 * per] += np.linspace(4.0, 12.0, per).astype(
        np.float32)[:, None] * qdir[None, :]
    scal = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    t = Table.from_numpy(TableSchema((VectorCol("v0", d),), (
        ScalarCol("s0", "num"), ScalarCol("s1", "num"))), [vecs], scal,
        device=device)
    q = MHQ(query_vectors=(torch.as_tensor(qdir),), weights=(1.0,),
            predicates=Predicates.none(2, device=device), k=10)
    return t, q


BOUNDARY_PLAN = dict(k_mult=2, nprobe=1, max_scan=300)


def _executor_cases(t, idx, sivfs, wl, bt, bidx, bsivf, *, mesh=None):
    """The executor passes, run alike by the logical side (no ``mesh``) and
    by each rank: -> {case: (results, escalated, the flagged shards of
    each escalation)}. ``sivfs``/``bsivf``: per-column callables giving the
    per-shard index (every shard's, or the rank's own)."""
    from repro_torch.serve.batch import (
        DENSE, SHARDED_LOCAL, BatchedHybridExecutor, CostModel,
    )

    kw = dict(mesh=mesh) if mesh is not None else dict(n_shards=N_RANKS)
    plan = _plan(t, k_mult=4, nprobe=8, max_scan=256)
    out = {}
    for case, force, plans in (
            ("probe", SHARDED_LOCAL, [plan] * len(wl)),
            ("dense", DENSE, [plan] * len(wl)),
            ("exact", DENSE, None)):
        bx = BatchedHybridExecutor(t, idx, cost_model=CostModel(force=force),
                                   **kw)
        for c in range(t.schema.n_vec):
            bx._sivf[c] = sivfs(c)
        out[case] = (bx.execute_batch_sharded(wl, plans), bx.escalated, [])
    bx = BatchedHybridExecutor(bt, bidx,
                               cost_model=CostModel(force=SHARDED_LOCAL), **kw)
    bx._sivf[0] = bsivf(0)
    needs = []
    orig = bx._escalate_shards

    def spy(ids, scores, need, **k):
        needs.append(need.copy())
        return orig(ids, scores, need, **k)

    bx._escalate_shards = spy
    q = _boundary_table()[1]
    out["boundary"] = (bx.execute_batch_sharded([q], [_plan(
        bt, **BOUNDARY_PLAN)]), bx.escalated, needs)
    return out


def _poisoned(t, rows):
    """A copy of ``t`` holding NaN outside ``rows`` [row0, row1)."""
    from repro_torch.vectordb.table import Table

    keep = torch.zeros(t.n_rows, dtype=torch.bool)
    keep[rows[0]: rows[1]] = True

    def poison(x):
        return torch.where(keep[:, None], x, torch.full_like(x, float("nan")))

    return Table(t.schema, [poison(v) for v in t.vectors], poison(t.scalars))


def _save_results(path, cases: dict) -> None:
    arrs = {}
    for case, (res, escalated, needs) in cases.items():
        arrs[f"{case}_ids"] = np.stack([np.asarray(i) for i, _ in res])
        arrs[f"{case}_s"] = np.stack([np.asarray(s) for _, s in res])
        arrs[f"{case}_esc"] = np.asarray(sorted(escalated), np.int64)
        for j, need in enumerate(needs):
            arrs[f"{case}_need{j}"] = need
    np.savez(path, **arrs)


def _rank(r: int, d: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.bench import datasets as tds
    from repro_torch.bench import queries as tq
    from repro_torch.core.executor import rrf_union_total
    from repro_torch.serve.batch import (
        SHARDED_LOCAL, BatchedHybridExecutor, CostModel,
    )
    from repro_torch.vectordb import distributed as tdist
    from repro_torch.vectordb import ivf
    from repro_torch.vectordb import predicates as tp
    from repro_torch.vectordb.predicates import Predicates, PredicateSet

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=r,
                            world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (N_RANKS,), mesh_dim_names=("data",))
        mesh22 = init_device_mesh("cpu", (2, 2),
                                  mesh_dim_names=("data", "model"))
        x = dict(np.load(f"{d}/inputs.npz"))
        j = dict(np.load(f"{d}/jax.npz"))
        out = {}
        r0, r1 = tdist.shard_rows(ROWS, mesh)
        mine = slice(r0, r1)

        def t_(a):
            return torch.as_tensor(a)

        vecs = tuple(t_(x[f"v{i}"][mine]) for i in range(2))
        v8s = tuple(t_(x[f"v8_{i}"][mine]) for i in range(2))
        scales = tuple(t_(x[f"sc{i}"][mine]) for i in range(2))
        scal = t_(x["scal"][mine])
        qs = tuple(t_(x[f"q{i}"]) for i in range(2))
        w = t_(x["w"])
        preds = tp.stack([PredicateSet.from_clauses(M, _clauses(b),
                                                    device="cpu")
                          for b in x["bounds"]])

        def keep(name, ids, scores):
            out[f"{name}_ids"] = ids.numpy()
            out[f"{name}_s"] = scores.numpy()

        keep("scan", *tdist.sharded_masked_scan(mesh, k=10, n_vec=2)(
            vecs, scal, Predicates.from_conditions(M, {0: (0.2, 0.8)},
                                                   device="cpu"),
            tuple(q[0] for q in qs), w[0]))
        for metric in ("dot", "l2"):
            keep(f"batched_{metric}", *tdist.sharded_masked_scan_batched(
                mesh, k=K, n_vec=2, metric=metric)(
                vecs, None, scal, preds, qs, w))
        keep("batched_int8", *tdist.sharded_masked_scan_batched(
            mesh, k=K, n_vec=2, int8=True)(v8s, scales, scal, preds, qs, w))
        keep("batch_topk", *tdist.sharded_batch_topk(mesh, k=K)(
            t_(x["w_scores"][:, mine]), scal, preds))
        shard = [convert.sharded_ivf(j[f"sivf{c}_c"], j[f"sivf{c}_r"],
                                     j[f"sivf{c}_o"], "dot",
                                     shard=tdist.mesh_shard(mesh)[1],
                                     device="cpu") for c in range(2)]
        for name, subs in IVF_CASES.items():
            cols = len(subs)
            ids, sc, fill, bnd = tdist.sharded_ivf_topk(
                N_RANKS, mesh, subs=subs, k=K, metric="dot",
                pad_total=_pad_total(subs, rrf_union_total))(
                tuple(s.centroids for s in shard[:cols]),
                tuple(s.sorted_rows for s in shard[:cols]),
                tuple(s.offsets for s in shard[:cols]), vecs[:cols], scal,
                preds, qs[:cols], w[:, :cols])
            keep(name, ids, sc)
            out[f"{name}_fill"] = fill.numpy()
            out[f"{name}_bnd"] = bnd.numpy()
        a0, a1 = tdist.shard_rows(ROWS, mesh22)
        keep("mesh22_batched", *tdist.sharded_masked_scan_batched(
            mesh22, ("data",), k=K, n_vec=2)(
            tuple(t_(x[f"v{i}"][a0:a1]) for i in range(2)), None,
            t_(x["scal"][a0:a1]), preds, qs, w))
        b0, b1 = tdist.shard_rows(ROWS, mesh22, ("data", "model"))
        keep("mesh22_batch_topk", *tdist.sharded_batch_topk(
            mesh22, ("data", "model"), k=K)(
            t_(x["w_scores"][:, b0:b1]), t_(x["scal"][b0:b1]), preds))
        np.savez(f"{d}/functions{r}.npz", **out)

        # the executor over the mesh, on tables poisoned outside its rows
        e = dict(np.load(f"{d}/exec.npz"))
        t = tds.make("part", rows=PART_ROWS, seed=0, device="cpu")
        idx = [convert.ivf_index(e[f"idx{c}_c"], e[f"idx{c}_r"],
                                 e[f"idx{c}_o"], "dot", device="cpu")
               for c in range(2)]
        wl = _mixed_wl(tq, t, 71)
        bt, _ = _boundary_table()
        bidx = [convert.ivf_index(e["bidx_c"], e["bidx_r"], e["bidx_o"],
                                  "dot", device="cpu")]
        s = tdist.mesh_shard(mesh)[1]
        cases = _executor_cases(
            _poisoned(t, tdist.shard_rows(t.n_rows, mesh)), idx,
            lambda c: convert.sharded_ivf(
                e[f"sivf{c}_c"], e[f"sivf{c}_r"], e[f"sivf{c}_o"], "dot",
                shard=s, device="cpu"),
            wl, _poisoned(bt, tdist.shard_rows(bt.n_rows, mesh)), bidx,
            lambda c: convert.sharded_ivf(e["bsivf_c"], e["bsivf_r"],
                                          e["bsivf_o"], "dot", shard=s,
                                          device="cpu"), mesh=mesh)
        # generous budgets on the indexes each rank builds itself
        own = BatchedHybridExecutor(
            t, [ivf.build(v, 16, seed=i) for i, v in enumerate(t.vectors)],
            mesh=mesh, cost_model=CostModel(force=SHARDED_LOCAL))
        wl2 = _mixed_wl(tq, t, 73)
        cases["generous"] = (own.execute_batch_sharded(
            wl2, [_plan(t, k_mult=4, nprobe=64, max_scan=t.n_rows)]
            * len(wl2)), own.escalated, [])
        _save_results(f"{d}/exec{r}.npz", cases)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the module fixture: both programs, once
# ---------------------------------------------------------------------------

def _logical_exec(d: str) -> dict:
    """The port's logical n_shards=4 side of the executor cases, and the
    arrays the ranks load: the base and per-shard indexes."""
    from repro_torch.bench import datasets as tds
    from repro_torch.bench import queries as tq
    from repro_torch.vectordb import distributed as tdist
    from repro_torch.vectordb import ivf

    t = tds.make("part", rows=PART_ROWS, seed=0, device="cpu")
    idx = [ivf.build(v, 16, seed=i, metric=t.schema.metric)
           for i, v in enumerate(t.vectors)]
    sivfs = [tdist.build_sharded_ivf(t.vectors[c], N_RANKS,
                                     n_clusters=idx[c].n_clusters, seed=c)
             for c in range(2)]
    bt, _ = _boundary_table()
    bidx = [ivf.build(bt.vectors[0], 4, seed=0)]
    bsivf = tdist.build_sharded_ivf(bt.vectors[0], N_RANKS, n_clusters=4)
    arrs = {}
    for name, ix in [(f"idx{c}", idx[c]) for c in range(2)] + \
            [(f"sivf{c}", sivfs[c]) for c in range(2)] + \
            [("bidx", bidx[0]), ("bsivf", bsivf)]:
        arrs[f"{name}_c"] = ix.centroids.numpy()
        arrs[f"{name}_r"] = ix.sorted_rows.numpy()
        arrs[f"{name}_o"] = ix.offsets.numpy()
    np.savez(f"{d}/exec.npz", **arrs)
    return _executor_cases(t, idx, lambda c: sivfs[c], _mixed_wl(tq, t, 71),
                           bt, bidx, lambda c: bsivf)


def _run(cmd, env, what):
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert out.returncode == 0, f"{what}: {out.stderr[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    np.savez(f"{d}/inputs.npz", **_inputs())
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N_RANKS}"
    env["JAX_PLATFORMS"] = "cpu"
    me = os.path.abspath(__file__)
    jax_proc = subprocess.Popen([sys.executable, me, "jax", d], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        logical = _logical_exec(d)
    finally:
        torch.set_num_threads(threads)
    try:
        _, err = jax_proc.communicate(timeout=TIMEOUT_S)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, f"JAX reference: {err[-3000:]}"
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
    return dict(
        jax=dict(np.load(f"{d}/jax.npz")),
        functions=[dict(np.load(f"{d}/functions{r}.npz"))
                  for r in range(N_RANKS)],
        exec=[dict(np.load(f"{d}/exec{r}.npz")) for r in range(N_RANKS)],
        logical=logical)


# ---------------------------------------------------------------------------
# the claims
# ---------------------------------------------------------------------------

MESH_FUNCTIONS = ("scan", "batched_dot", "batched_l2", "batched_int8", "batch_topk",
            "ivf1", "ivf2", "mesh22_batched", "mesh22_batch_topk")


@pytest.mark.parametrize("name", MESH_FUNCTIONS)
def test_mesh_function_matches_jax_shard_map(runs, name):
    """Every rank returns the reference's result: ids equal, scores within
    1e-5; the probing search's ``fill`` equal and ``boundary`` within
    1e-5, (B, S) in shard order."""
    want = runs["jax"]
    for r, got in enumerate(runs["functions"]):
        np.testing.assert_array_equal(got[f"{name}_ids"],
                                      want[f"{name}_ids"], f"rank {r}")
        np.testing.assert_allclose(got[f"{name}_s"], want[f"{name}_s"],
                                   **SCORE_TOL)
        if name.startswith("ivf"):
            np.testing.assert_array_equal(got[f"{name}_fill"],
                                          want[f"{name}_fill"])
            assert got[f"{name}_fill"].shape == (Q, N_RANKS)
            np.testing.assert_allclose(got[f"{name}_bnd"],
                                       want[f"{name}_bnd"], **SCORE_TOL)
    valid = want[f"{name}_ids"] >= 0
    assert valid.sum() > 0  # the case selects rows


def test_int8_accumulators_are_exact():
    """The int8 path's quantized queries and integer accumulators equal
    JAX's bit for bit (the JAX side runs in the module's reference
    program; this side on the whole table)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro_torch.vectordb.distributed import int8_dot, quantize_queries

    x = _inputs()
    for i in range(2):
        q = jnp.asarray(x[f"q{i}"])
        qsc = jnp.maximum(jnp.max(jnp.abs(q), axis=-1), 1e-12) / 127.0
        want_q8 = np.asarray(jnp.clip(jnp.round(q / qsc[:, None]), -127, 127
                                      ).astype(jnp.int8))
        want_acc = np.asarray(jnp.einsum(
            "nd,qd->qn", jnp.asarray(x[f"v8_{i}"]), jnp.asarray(want_q8),
            preferred_element_type=jnp.int32))
        q8, got_qsc = quantize_queries(torch.as_tensor(x[f"q{i}"]))
        np.testing.assert_array_equal(q8.numpy(), want_q8)
        np.testing.assert_array_equal(got_qsc.numpy(), np.asarray(qsc))
        acc = int8_dot(torch.as_tensor(x[f"v8_{i}"]), q8)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), want_acc)


def test_int8_accumulators_match_the_mesh_reference(runs):
    """The same accumulators as the reference program formed them."""
    from repro_torch.vectordb.distributed import int8_dot, quantize_queries

    x = _inputs()
    for i in range(2):
        q8, _ = quantize_queries(torch.as_tensor(x[f"q{i}"]))
        np.testing.assert_array_equal(q8.numpy(), runs["jax"][f"q8_{i}"])
        np.testing.assert_array_equal(
            int8_dot(torch.as_tensor(x[f"v8_{i}"]), q8).numpy(),
            runs["jax"][f"acc_{i}"])


@pytest.mark.parametrize("case", ["probe", "dense", "exact", "boundary"])
def test_mesh_executor_matches_logical_shards(runs, case):
    """``BatchedHybridExecutor(mesh=4 ranks)`` equals the logical
    ``n_shards=4`` executor on the same per-shard indexes: ids equal,
    scores within 1e-5, the same escalated queries and flagged shards, on
    every rank."""
    res, escalated, needs = runs["logical"][case]
    want_ids = np.stack([np.asarray(i) for i, _ in res])
    want_s = np.stack([np.asarray(s) for _, s in res])
    for r, got in enumerate(runs["exec"]):
        np.testing.assert_array_equal(got[f"{case}_ids"], want_ids,
                                      f"rank {r}")
        np.testing.assert_allclose(got[f"{case}_s"], want_s, **SCORE_TOL)
        assert set(got[f"{case}_esc"].tolist()) == escalated
        got_needs = [got[k] for k in sorted(got) if
                     k.startswith(f"{case}_need")]
        assert len(got_needs) == len(needs)
        for g, n in zip(got_needs, needs):
            np.testing.assert_array_equal(g, n)


def test_boundary_retry_runs_with_unflagged_ranks(runs):
    """The boundary case escalates its query with some shards flagged and
    some not, so the retry's gather ran with unflagged ranks."""
    _, escalated, needs = runs["logical"]["boundary"]
    assert escalated == {0} and len(needs) == 1
    flagged = needs[0][0]
    assert flagged.any() and not flagged.all(), flagged


def test_mesh_oracle_floor_on_its_own_indexes(runs):
    """At generous budgets per-shard probing over the mesh, on per-shard
    indexes each rank built itself, meets the exact oracle on every query
    (``tests/test_sharded_ivf.py``'s claim); every rank serves the same."""
    from oracle import brute_force_topk, tie_aware_recall

    from repro_torch.bench import datasets as tds
    from repro_torch.bench import queries as tq

    t = tds.make("part", rows=PART_ROWS, seed=0, device="cpu")
    wl = _mixed_wl(tq, t, 73)
    ids = runs["exec"][0]["generous_ids"]
    for got in runs["exec"][1:]:
        np.testing.assert_array_equal(got["generous_ids"], ids)
    for q, row in zip(wl, ids):
        _, _, masked = brute_force_topk(
            t, [v.numpy() for v in q.query_vectors], list(q.weights),
            q.predicates, q.k)
        assert tie_aware_recall(row, masked, q.k) == 1.0


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_reference(sys.argv[2])
    else:
        _rank(int(sys.argv[2]), sys.argv[3])
