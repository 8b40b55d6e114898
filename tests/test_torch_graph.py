"""Graph strategy parity between the JAX package and the PyTorch port.

Fixture: ``tests/test_graph.py``'s — ``sift``, 2,000 rows, degree 16,
dot and l2. The JAX-built graph is carried across with
``convert.graph_index``; on it the port's ``search_local_batch`` (a walk
batched over the queries in torch ops, then the gather-score extraction)
must give the ids, ``n_scored`` and ``n_qualified`` of JAX's
``use_kernel=False`` path, scores to ``atol=1e-4``. Predicates: the four of
``test_graph.py``'s kernel-parity test, plus selective ones under which
fewer rows qualify than the beam's qualifying half — the case where the
reference's expanded-flag scatter repeats a lane (``_mark_expanded``).

The port's OWN build is held to the floors of ``tests/test_graph.py``:
structure, reachability ≥ 0.99, ``extend`` reaching its appended rows,
filtered recall ≥ 0.45 (dot) / 0.7 (l2), and on the hard stratum graph
recall ≥ IVF recall + 0.1 at equal budget.
Executor parity on fixed graph plans lives in ``test_torch_boomhq.py``,
beside the JAX-fitted fixture it reuses.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax.numpy as jnp  # noqa: E402

from oracle import NEG, similarity_np, tie_aware_recall  # noqa: E402

from repro.bench import datasets as jds  # noqa: E402
from repro.kernels import beam_search as jbs  # noqa: E402
from repro.vectordb import graph as jgraph  # noqa: E402
from repro.vectordb import predicates as jp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import beam_search as tbs  # noqa: E402
from repro_torch.kernels import gather_score as tgs  # noqa: E402
from repro_torch.vectordb import graph as tgraph  # noqa: E402
from repro_torch.vectordb import ivf as tivf  # noqa: E402
from repro_torch.vectordb import predicates as tp  # noqa: E402
from repro_torch.vectordb.table import (  # noqa: E402
    ScalarCol, Table, TableSchema, VectorCol,
)

K = 10


def _port_table(jt):
    """The JAX table's arrays as a port ``Table`` on the CPU."""
    schema = TableSchema(
        tuple(VectorCol(c.name, c.dim) for c in jt.schema.vector_cols),
        tuple(ScalarCol(c.name, c.kind, c.n_categories)
              for c in jt.schema.scalar_cols), metric=jt.schema.metric)
    return Table.from_numpy(schema, [np.array(v) for v in jt.vectors],
                            np.array(jt.scalars), device="cpu")


@pytest.fixture(scope="module", params=["dot", "l2"])
def sift(request):
    """(metric, JAX table, port table, JAX graph, that graph carried
    across, the port's own graph)."""
    metric = request.param
    jt = jds.make("sift", rows=2000, seed=0, metric=metric)
    tt = _port_table(jt)
    jg = jgraph.build(jt.vectors[0], 16, metric=metric)
    carried = convert.graph_index(np.asarray(jg.neighbors),
                                  np.asarray(jg.entry_points), metric,
                                  device="cpu")
    own = tgraph.build(tt.vectors[0], 16, metric=metric)
    return metric, jt, tt, jg, carried, own


def _queries(tt, n_q, seed):
    rng = np.random.default_rng(seed)
    vecs = tt.vectors[0].numpy()
    rows = rng.choice(vecs.shape[0], n_q, replace=False)
    return (vecs[rows] + rng.normal(0, 0.02, (n_q, vecs.shape[1]))
            ).astype(np.float32)


def _conds(tt):
    """(name, {col: (lo, hi)}) predicates: test_graph.py's four, then
    selective ones (one cluster id; a thin slice of the num column; none)."""
    med = float(np.median(tt.scalars[:, 2].numpy()))
    lo2 = float(np.quantile(tt.scalars[:, 2].numpy(), 0.5))
    hi2 = float(np.quantile(tt.scalars[:, 2].numpy(), 0.502))
    return [("none", {}), ("cluster<=7", {0: (0.0, 7.0)}),
            ("num<=median", {2: (0.0, med)}), ("col1<=8", {1: (0.0, 8.0)}),
            ("cluster==3", {0: (3.0, 3.0)}), ("thin", {2: (lo2, hi2)}),
            ("nothing", {0: (100.0, 200.0)})]


def _search_both(g_j, g_t, jt, tt, conds, q, *, beam_width, n_hops):
    m = tt.schema.n_scalar
    pj = jp.stack([jp.Predicates.from_conditions(m, c) for c in conds])
    pt = tp.stack([tp.Predicates.from_conditions(m, c, device="cpu")
                   for c in conds])
    want = jgraph.search_local_batch(
        g_j, jt.vectors[0], jt.scalars, pj, jnp.asarray(q),
        beam_width=beam_width, n_hops=n_hops, k=K, use_kernel=False)
    got = tgraph.search_local_batch(
        g_t, tt.vectors[0], tt.scalars, pt, torch.as_tensor(q),
        beam_width=beam_width, n_hops=n_hops, k=K)
    return got, want


@pytest.mark.parametrize("knobs", [(8, 4), (16, 8), (4, 2)],
                         ids=lambda kb: f"beam{kb[0]}-hops{kb[1]}")
def test_search_matches_jax_on_the_carried_graph(sift, knobs):
    _, jt, tt, jg, carried, _ = sift
    named = _conds(tt)
    q = _queries(tt, len(named), seed=3)
    tgs.reset_launches()
    got, want = _search_both(jg, carried, jt, tt, [c for _, c in named], q,
                             beam_width=knobs[0], n_hops=knobs[1])
    assert tgs.LAUNCHES == {"fp32": 0, "int8": 0}  # CPU: the plain version
    ids_t, sc_t, nv_t, nq_t = (x.numpy() for x in got)
    ids_j, sc_j, nv_j, nq_j = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(sc_t, sc_j, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(nv_t, nv_j)
    np.testing.assert_array_equal(nq_t, nq_j)


def test_mark_fresh_matches_jax():
    """Four batches of ids (padding, repeats within a batch and across
    batches) into the visited set: the same fresh flags as JAX's packed
    bitmask, query by query."""
    rng = np.random.default_rng(1)
    n, b, s = 100, 3, 40
    n_words = (n + 31) // 32
    vis_t = torch.zeros((b, n + 1), dtype=torch.bool)
    vis_j = [jnp.zeros((n_words,), jnp.uint32) for _ in range(b)]
    for _ in range(4):
        ids = rng.integers(-1, n, (b, s)).astype(np.int32)
        vis_t, fresh_t = tbs._mark_fresh(vis_t, torch.as_tensor(ids))
        for j in range(b):
            vis_j[j], fresh_j = jbs._mark_fresh(vis_j[j], jnp.asarray(ids[j]),
                                                n_words)
            np.testing.assert_array_equal(fresh_t[j].numpy(),
                                          np.asarray(fresh_j))
    assert int(vis_t[:, :n].sum()) == sum(
        int(np.unpackbits(np.asarray(v).view(np.uint8)).sum())
        for v in vis_j)


def test_mark_expanded_keeps_the_last_write():
    """A lane picked by the raw half and padded into the qualifying half
    ends unexpanded, as the reference's single scatter leaves it; a lane
    expanded in an earlier hop stays expanded."""
    exp = torch.tensor([[False, False, False, True, False, False]])
    i_raw, ok_raw = torch.tensor([[0, 4]]), torch.tensor([[True, True]])
    i_qual, ok_qual = torch.tensor([[0, 1]]), torch.tensor([[False, False]])
    got = tbs._mark_expanded(exp, i_raw, ok_raw, i_qual, ok_qual)
    fr_idx = jnp.asarray([0, 4, 0, 1])
    fr_ok = jnp.asarray([True, True, False, False])
    want = jnp.asarray(exp[0].numpy()).at[fr_idx].set(fr_ok, mode="drop") \
        | jnp.asarray(exp[0].numpy())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert got[0].tolist() == [False, False, False, True, True, False]


def test_repeated_lane_case_occurs_in_walks(sift, monkeypatch):
    """Under predicates that leave the qualifying half of the beam short,
    the repeated-lane outcome changes the walk: a port that marked every
    real pick expanded would visit other rows than JAX, and the port as it
    is matches JAX (the parity test above covers the same predicates)."""
    _, jt, tt, jg, carried, _ = sift
    named = _conds(tt)[-3:]  # the selective predicates
    q = _queries(tt, len(named), seed=4)
    got, want = _search_both(jg, carried, jt, tt, [c for _, c in named], q,
                             beam_width=8, n_hops=4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))

    def intended(pool_exp, i_raw, ok_raw, i_qual, ok_qual):
        marked = pool_exp.clone()
        marked.scatter_(1, i_qual, ok_qual)
        marked.scatter_(1, i_raw, ok_raw)
        return marked | pool_exp

    monkeypatch.setattr(tbs, "_mark_expanded", intended)
    alt, _ = _search_both(jg, carried, jt, tt, [c for _, c in named], q,
                          beam_width=8, n_hops=4)
    assert not np.array_equal(alt[2].numpy(), np.asarray(want[2]))


def test_cost_model_strategy_choice_matches_jax():
    """``CostModel.choose_strategy`` (placeholder constants, as in JAX) over
    batches, graph budgets, probe budgets and table sizes."""
    from repro.serve.batch import CostModel as JCostModel

    from repro_torch.serve.batch import CostModel

    tc, jc = CostModel(), JCostModel()
    for batch in (1, 8, 64):
        for graph_scan in (72, 552, 2120):
            for probe_scan in (2048, 32768):
                for n in (2000, 200_000, 2_000_000):
                    kw = dict(batch=batch, graph_scan=graph_scan,
                              probe_scan=probe_scan, n_rows=n)
                    assert tc.choose_strategy(**kw) == \
                        jc.choose_strategy(**kw), kw


# ---------------------------------------------------------------------------
# the port's own build against tests/test_graph.py's floors
# ---------------------------------------------------------------------------

def _reachable(g) -> np.ndarray:
    nb = g.neighbors.numpy()
    reach = np.zeros(nb.shape[0], bool)
    reach[g.entry_points.numpy()] = True
    frontier = np.where(reach)[0]
    while frontier.size:
        nxt = nb[frontier].reshape(-1)
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[~reach[nxt]]
        reach[nxt] = True
        frontier = nxt
    return reach


def test_own_build_structure_and_reachability(sift):
    metric, _, tt, _, _, g = sift
    n = tt.n_rows
    nb = g.neighbors.numpy()
    assert nb.shape == (n, 16) and g.metric == metric
    valid = nb >= 0
    assert valid.sum() > 0 and nb[valid].max() < n
    rows = np.broadcast_to(np.arange(n)[:, None], nb.shape)
    assert not np.any((nb == rows) & valid)  # no self-loops
    ep = g.entry_points.numpy()
    assert ep.shape == (tgraph.GRAPH_ENTRY_POINTS,)
    assert ((ep >= 0) & (ep < n)).all()
    assert _reachable(g).mean() >= 0.99


def test_own_extend_appends_and_reaches_new_rows(sift):
    """``graph.extend`` on the port's own build of the first 1,700 rows:
    the appended rows are spliced in (≥ 95% reachable) and a query with a
    new row's vector keeps oracle recall ≥ 0.4 — test_graph.py's floors."""
    metric, _, tt, _, _, _ = sift
    vecs = tt.vectors[0]
    n0 = 1700
    ext = tgraph.extend(tgraph.build(vecs[:n0], 16, metric=metric), vecs, n0)
    assert ext.neighbors.shape == (tt.n_rows, 16)
    assert _reachable(ext)[n0:].mean() >= 0.95
    pred = tp.Predicates.none(tt.schema.n_scalar, device="cpu")
    recs = []
    for r in range(n0, n0 + 12):
        ids, _, _, _ = tgraph.search(ext, vecs, tt.scalars, pred, vecs[r],
                                     beam_width=16, n_hops=8, k=K)
        m = similarity_np(vecs[r].numpy(), vecs.numpy(), metric)
        recs.append(tie_aware_recall(ids.numpy(), m, K))
    assert np.mean(recs) >= 0.4, recs


def test_own_build_filtered_recall(sift):
    metric, _, tt, _, _, g = sift
    scal = tt.scalars.numpy()
    lo, hi = np.quantile(scal[:, 2], [0.25, 0.75])
    pred = tp.Predicates.from_conditions(3, {2: (float(lo), float(hi))},
                                         device="cpu")
    mask = (scal[:, 2] >= lo) & (scal[:, 2] <= hi)
    rng = np.random.default_rng(11)
    vecs = tt.vectors[0].numpy()
    recs = []
    for r in rng.choice(vecs.shape[0], 10, replace=False):
        q = (vecs[r] + rng.normal(0, 0.02, vecs.shape[1])).astype(np.float32)
        ids, _, _, _ = tgraph.search(g, tt.vectors[0], tt.scalars, pred,
                                     torch.as_tensor(q), beam_width=16,
                                     n_hops=8, k=K)
        masked = np.where(mask, similarity_np(q, vecs, metric), NEG)
        recs.append(tie_aware_recall(ids.numpy(), masked, K))
    assert np.mean(recs) >= (0.45 if metric == "dot" else 0.7), recs


def test_own_build_beats_ivf_on_the_hard_stratum(sift):
    """Queries near one cluster under a predicate selecting ANOTHER: graph
    recall ≥ IVF recall + 0.1 with IVF given the graph's mean visited
    count as its scan budget (nprobe rounded up)."""
    metric, _, tt, _, _, g = sift
    clu = tt.scalars[:, 0].numpy().astype(int)
    vecs = tt.vectors[0].numpy()
    counts = np.bincount(clu)
    good = [c for c in range(counts.shape[0]) if counts[c] >= 2 * K]
    rng = np.random.default_rng(5)
    cases = []
    for _ in range(16):
        c = int(rng.choice(good))
        r = int(rng.choice(np.where(clu != c)[0]))
        q = (vecs[r] + rng.normal(0, 0.02, vecs.shape[1])).astype(np.float32)
        cases.append((c, q))

    def masked(q, c):
        return np.where(clu == c, similarity_np(q, vecs, metric), NEG)

    def pred(c):
        return tp.Predicates.from_conditions(3, {0: (float(c), float(c))},
                                             device="cpu")

    g_rec, g_vis = [], []
    for c, q in cases:
        ids, _, nvis, _ = tgraph.search(g, tt.vectors[0], tt.scalars, pred(c),
                                        torch.as_tensor(q), beam_width=16,
                                        n_hops=8, k=K)
        g_rec.append(tie_aware_recall(ids.numpy(), masked(q, c), K))
        g_vis.append(int(nvis))
    budget = int(np.mean(g_vis))
    iv = tivf.build(tt.vectors[0], 16, metric=metric)
    npb = max(2, -(-budget // (tt.n_rows // 16)))
    i_rec = []
    for c, q in cases:
        ids, _, _, _ = tivf.search(iv, tt.vectors[0], tt.scalars, pred(c),
                                   torch.as_tensor(q), nprobe=npb,
                                   max_scan=budget, k=K)
        i_rec.append(tie_aware_recall(ids.numpy(), masked(q, c), K))
    g_mean, i_mean = float(np.mean(g_rec)), float(np.mean(i_rec))
    assert g_mean >= i_mean + 0.1, (g_mean, i_mean, budget)
    assert g_mean >= 0.15, (g_mean, budget)
