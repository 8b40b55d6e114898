"""The id check ``chip_smoke.py`` holds every kernel to, on CPU tensors,
and the later phases' checks, each refusing planted faults (phase 10: a
served row out of range, twice, failing its predicate or misscored; a
wrong id from the exact route; an S=1 result differing from the unsharded
one; gather launches per probing chunk growing with the shard count;
phase 11: a mesh pass whose ranks were gathered in reverse order, whose
shard left its ids local, or whose escalated queries or scores differ
from the logical shards'; phase 11 (d): a follower's result that differs,
a batch run on a snapshot other than its stamp, a missed hot row, unequal
cold-state digests, a replayed batch with an untied id; phase 12 (c): a sync in a hot function that no
static finding covers, raised there or in a helper that is not listed;
phase 13: a logit outside the tolerance; phase 14: decode logits outside
the tolerance of the full forward's), phases 13 and 14 walked end to end
on the CPU at the smoke configs' size, the card's timers stubbed, and the
parameters a model holds beyond ``n_params()`` named leaf by leaf.

``_held_to_plain`` lets a kernel's ids differ from the plain version's only
where the plain version itself ties; ``_refuses_planted_ids`` swaps two
untied ids of a result and requires the check to refuse it. The plain
result here is ``ref.masked_topk_ref`` over a small table whose rows 0 and
1 are equal, so their scores are a real tie.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.shapes import NEG  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def result(smoke):
    """(scores, ids, rescore) of the plain top-8 over 64 rows, rows 0 and 1
    equal and ranked first."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((64, 16)).astype(np.float32)
    q = rng.standard_normal(16).astype(np.float32)
    v[0] = v[1] = 3.0 * q / np.linalg.norm(q)
    v, q = torch.from_numpy(v), torch.from_numpy(q)
    scal = torch.zeros((64, 1))
    lo, hi, act = torch.zeros(1), torch.zeros(1), torch.zeros(1)
    s, i = ref.masked_topk_ref(q, v, scal, lo, hi, act, 64, k=8)
    full = ref.scan_scores_ref(q, v, scal, lo, hi, act, 64)
    assert i[:2].tolist() == [0, 1]
    return s, i, smoke._table_rescore(full)


def _swap(ids, a, b):
    out = ids.clone()
    out[a], out[b] = ids[b], ids[a]
    return out


def test_equal_ids_pass(smoke, result):
    s, i, rescore = result
    err, swaps = smoke._held_to_plain("x", s, i, s, i, rescore)
    assert (err, swaps) == (0.0, 0)


def test_a_swap_between_tied_rows_passes(smoke, result):
    s, i, rescore = result
    assert smoke._held_to_plain("x", s, _swap(i, 0, 1), s, i,
                                rescore)[1] == 2


@pytest.mark.parametrize("case", ["untied_swap", "row_twice",
                                  "missing_clear_row"])
def test_wrong_ids_with_right_scores_are_refused(smoke, result, case):
    s, i, rescore = result
    if case == "untied_swap":
        got, msg = _swap(i, 0, 5), "does not tie"
    elif case == "row_twice":
        got, msg = _swap(i, 0, 1), "twice"
        got[0] = got[1]  # both slots of the tie name one row
    else:
        # a rescore that drifts from the plain version lets row 63 pass as
        # a tie at row 2's slot; the set check still misses row 2
        got, msg = i.clone(), "misses"
        got[2] = 63
        drifted = rescore
        rescore = lambda ids: torch.where(  # noqa: E731
            ids == 63, s[2], drifted(ids))
    with pytest.raises(AssertionError, match=msg):
        smoke._held_to_plain("x", s, got, s, i, rescore)


def test_the_planted_swap_is_refused(smoke, result, monkeypatch):
    s, i, rescore = result
    smoke._refuses_planted_ids("x", s, i, s, i, rescore)
    monkeypatch.setattr(smoke, "_held_to_plain", lambda *a: (0.0, 0))
    with pytest.raises(AssertionError, match="accepted"):
        smoke._refuses_planted_ids("x", s, i, s, i, rescore)


def test_empty_slots_rescore_to_neg(smoke):
    rescore = smoke._table_rescore(torch.tensor([1.0, 2.0]))
    assert torch.equal(rescore(torch.tensor([1, -1])),
                       torch.tensor([2.0, NEG]))


# two queries' slots over rows 3, 5, 7, 8, 9: row 5 twice in query 0, row
# 7 in both queries, row 3 twice in query 1, and padding
CAND = torch.tensor([[5, 7, 5, -1, 9, 7], [7, 3, 3, 8, -1, -1]],
                    dtype=torch.int32)
# qualifying slots name rows 5, 7 and 3 (row 7 fails in query 0's slot
# but qualifies in query 1's, row 5 qualifies in one of its two slots)
QUAL = torch.tensor([[1, 0, 0, 0, 0, 0], [1, 0, 1, 0, 0, 0]], dtype=torch.bool)


@pytest.mark.parametrize("int8", [False, True])
def test_gather_bound_counts_vectors_of_qualifying_rows_only(smoke, int8):
    """With a predicate: every named row's 4M scalar bytes (5 distinct
    rows) but only the qualifying rows' vector (and int8 scale) bytes (3
    distinct rows); the ids, queries and block outputs as ever; flops for
    the 3 qualifying slots."""
    dims, m, k = (16, 8), 4, 10
    elem = 1 if int8 else 4
    row = 24 * elem + (8 if int8 else 0)
    fixed = 2 * 6 * 4 + 2 * 1 * (8 * k + 4) + 2 * 24 * 4
    got = smoke._gather_traffic(CAND, dims, elem, m, k, int8=int8, l2=True,
                                qual=QUAL)
    assert got == (3 * row + 5 * 4 * m + fixed, 3 * 24 * 4)
    ms, by = smoke._bound_ms(CAND, dims, elem, m, k, int8=int8, l2=True,
                             qual=QUAL)
    assert by == "bytes" and ms == pytest.approx(
        got[0] / smoke.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("int8", [False, True])
def test_gather_bound_without_predicate_is_unchanged(smoke, int8):
    """No predicate: every distinct named row's vectors (5 rows), no
    scalars, and flops for the 9 valid slots — the count before the
    qualifying rows were told apart."""
    dims, m, k = (16, 8), 4, 10
    elem = 1 if int8 else 4
    row = 24 * elem + (8 if int8 else 0)
    fixed = 2 * 6 * 4 + 2 * 1 * (8 * k + 4) + 2 * 24 * 4
    assert smoke._gather_traffic(CAND, dims, elem, m, k, int8=int8,
                                 l2=False) == (5 * row + fixed, 9 * 24 * 2)


@pytest.mark.parametrize("int8", [False, True])
def test_scan_bound_counts_vectors_of_qualifying_rows_only(smoke, int8):
    """A scan under a predicate: every row's 4M scalar bytes, but only the
    30 qualifying rows' vector (and int8 scale) bytes; the query, the
    predicate fields and the block pools as ever. With no active column no
    scalar byte; with every row counted, the old every-row figure."""
    n, d, m, k, nb = 2000, 16, 4, 10, 2
    row = d * (1 if int8 else 4) + (4 if int8 else 0)
    fixed = 4 * (d + 3 * m) + nb * k * 8

    def ms(bytes_):
        return bytes_ / smoke.HBM_BYTES_PER_S * 1e3

    got, by = smoke._scan_bound_ms(n, d, m, k, nb, n_qual=30,
                                   any_active=True, int8=int8, l2=False)
    assert by == "bytes"
    assert got == pytest.approx(ms(n * 4 * m + 30 * row + fixed))
    none = smoke._scan_bound_ms(n, d, m, k, nb, n_qual=n, any_active=False,
                                int8=int8, l2=False)[0]
    assert none == pytest.approx(ms(n * row + fixed))
    every = smoke._scan_bound_ms(n, d, m, k, nb, n_qual=n, any_active=True,
                                 int8=int8, l2=False)[0]
    assert every == pytest.approx(ms(n * (row + 4 * m) + fixed))


# ---------------------------------------------------------------------------
# phase 7's checks (data updates)
# ---------------------------------------------------------------------------

@pytest.fixture()
def grown():
    """(table with column 0's replica carried through an append, old row
    count, the pre-append replica and scales)."""
    from repro_torch.bench import datasets

    t = datasets.make("part", rows=300, seed=0, device="cpu")
    old_q, old_s = (x.clone() for x in t.quantized(0))
    rng = np.random.default_rng(0)
    new = [rng.normal(size=(40, 768)).astype(np.float32) for _ in range(2)]
    return t.append(new, t.scalars[:40].numpy()), 300, old_q, old_s


def test_int8_carry_check_passes_a_carried_replica(smoke, grown):
    smoke.check_int8_carry(*grown, "x")


@pytest.mark.parametrize("fault", ["old_row", "old_scale", "new_row",
                                   "not_carried"])
def test_int8_carry_check_refuses(smoke, grown, fault):
    t, n_old, old_q, old_s = grown
    if fault == "old_row":
        t.vectors_i8[0] = t.vectors_i8[0].clone()
        t.vectors_i8[0][17] = -t.vectors_i8[0][17]
        msg = "old rows changed"
    elif fault == "old_scale":
        t.scales[0] = t.scales[0].clone()
        t.scales[0][5] *= 2.0
        msg = "old rows changed"
    elif fault == "new_row":
        t.vectors_i8[0] = t.vectors_i8[0].clone()
        t.vectors_i8[0][n_old + 3, 0] += 1
        msg = "new rows"
    else:
        t.vectors_i8[0] = None
        msg = "not carried"
    with pytest.raises(AssertionError, match=msg):
        smoke.check_int8_carry(t, n_old, old_q, old_s, "x")


def _index(rows, offsets):
    from repro_torch.vectordb.ivf import IVFIndex

    return IVFIndex(torch.zeros((len(offsets) - 1, 4)),
                    torch.tensor(rows, dtype=torch.int32),
                    torch.tensor(offsets, dtype=torch.int32), "dot")


def test_layout_check(smoke):
    smoke.check_layout(_index([3, 0, 4, 1, 2], [0, 2, 2, 5]), 5, "x")
    with pytest.raises(AssertionError, match="permutation"):
        smoke.check_layout(_index([3, 0, 4, 1, 1], [0, 2, 2, 5]), 5, "x")
    with pytest.raises(AssertionError, match="offsets"):
        smoke.check_layout(_index([3, 0, 4, 1, 2], [0, 2, 2, 4]), 5, "x")
    with pytest.raises(AssertionError, match="offsets"):
        smoke.check_layout(_index([3, 0, 4, 1, 2], [0, 3, 2, 5]), 5, "x")


def test_new_row_check(smoke):
    gt = [np.array([1, 12, 3, -1]), np.array([11, 2, 5, 6])]
    served = [(np.array([1, 12, 3, -1]), None), (np.array([2, 5, 6, 7]),
                                                 None)]
    assert smoke.new_row_shares(gt, served, 10, "x") == (2 / 7, 1 / 7)
    dropped = [(np.array([1, 3, 4, -1]), None), (np.array([2, 5, 6, 7]),
                                                 None)]
    with pytest.raises(AssertionError, match="no served result"):
        smoke.new_row_shares(gt, dropped, 10, "x")
    # a ground truth without new rows asks nothing of the served results
    assert smoke.new_row_shares([np.array([1, 2])], dropped, 10, "x") == \
        (0.0, 0.0)


def test_skewed_insert_is_the_benchmark_s(smoke):
    """The script's numpy copy draws what benchmarks/data_updates draws."""
    from benchmarks.data_updates import _skewed_insert
    from repro.bench import datasets as jds

    from repro_torch.bench import datasets

    jt = jds.make("part", rows=300, seed=0)
    tt = datasets.make("part", rows=300, seed=0, device="cpu")
    want_v, want_s = _skewed_insert(jt, 25, 1000)
    got_v, got_s = smoke.skewed_insert(tt, 25, 1000)
    for a, b in zip(got_v, want_v):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got_s, want_s)


def test_phase_7_shapes_are_phase_3_shapes(smoke):
    """Every shape phase 7 repeats on the grown tables is one of
    ``gather_cases``'s, once."""
    from repro_torch.bench import datasets, queries as qgen
    from repro_torch.vectordb import ivf

    t = datasets.make("part", rows=2000, seed=0, device="cpu")
    index = ivf.build(t.vectors[0], 16, seed=0, metric=t.schema.metric)
    wl = qgen.gen_workload(t, smoke.BATCH, n_vec_used=2, seed=3)
    labels = [c[0] for c in smoke.gather_cases(t, index, None, wl, "cpu")]
    assert all(labels.count(s) == 1 for s in smoke.GROWN_SHAPES)


# ---------------------------------------------------------------------------
# phase 8's search check
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sift_search(smoke):
    """A small ``sift`` table, its IVF index and queries, ``search_cases``
    on them, and the two searches as the port runs them on CPU tensors
    (where the wrappers take the plain versions)."""
    from repro_torch.bench import datasets, queries as qgen
    from repro_torch.vectordb import ivf, predicates

    t = datasets.make("sift", rows=4000, seed=0, device="cpu")
    index = ivf.build(t.vectors[0], 16, seed=0, metric=t.schema.metric)
    wl = qgen.gen_workload(t, 8, n_vec_used=1, seed=3)
    cases, plains, rescore = smoke.search_cases(t, index, wl, "cpu")
    pred = predicates.stack([q.predicates for q in wl])
    q_b = torch.stack([q.query_vectors[0] for q in wl])
    max_scan = smoke.SIFT_NPROBE * t.n_rows // 16
    vq, sc = t.quantized(0)
    got = ivf.search_local_batch(index, t.vectors[0], t.scalars, pred, q_b,
                                 nprobe=smoke.SIFT_NPROBE,
                                 max_scan=max_scan, k=10)
    got8 = ivf.search_local_batch_int8(
        index, t.vectors[0], vq, sc, t.scalars, pred, q_b,
        nprobe=smoke.SIFT_NPROBE, max_scan=max_scan, k=10)
    return t, cases, plains, rescore, (got, got8)


def test_search_cases_are_the_searches_launches(sift_search):
    """The three cases are the searches' own gather calls: the fp32 case
    is the fp32 search, the int8 stage feeds the rerank case, and the
    rerank case is the int8 search."""
    from repro_torch.kernels import gather_score as gs

    t, cases, plains, _, (got, got8) = sift_search
    assert [(label.split()[0], v) for label, v, _ in cases] == [
        ("search", "fp32"), ("search", "int8"), ("search", "fp32")]
    out = []
    for _, _, a in cases:
        out.append(gs.gather_score_topk(
            a["cand"], a["vectors"], a["qs"], a["w"], t.scalars, a["pred"],
            k=a["k"], metric=a["metric"], scales=a["scales"]))
    assert torch.equal(out[1][0], cases[2][2]["cand"])
    for search, case, plain in ((got, out[0], plains[0]),
                                (got8, out[2], plains[1])):
        for x in (search[0], case[0], plain[0]):
            assert torch.equal(x, search[0])
        for x in (case[1], plain[1]):
            assert torch.equal(x, search[1])
        assert torch.equal(plain[2], search[3])


def test_search_check_refuses_a_wrong_result(smoke, sift_search):
    _, _, plains, rescore, (got, got8) = sift_search
    for name, search, plain in (("fp32", got, plains[0]),
                                ("int8", got8, plains[1])):
        ids, scores = search[0], search[1]
        assert smoke._held_to_plain(name, scores, ids, plain[1], plain[0],
                                    rescore) == (0.0, 0)
        # the best row of a query with results replaced by another row
        r = int(torch.nonzero(ids[:, 0] >= 0)[0])
        bad = ids.clone()
        bad[r, 0] = next(x for x in range(10) if x not in ids[r].tolist())
        with pytest.raises(AssertionError, match="does not tie"):
            smoke._held_to_plain(name, scores, bad, plain[1], plain[0],
                                 rescore)


# ---------------------------------------------------------------------------
# phase 9's checks (tiers, tenants, the cache)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tenant_part(smoke):
    """(300-row ``part`` with the tenant column, 32 tenanted queries)."""
    from repro_torch.bench import datasets, queries as qgen

    t = smoke.tenant_table(datasets.make("part", rows=300, seed=0,
                                         device="cpu"))
    wl = qgen.gen_workload(t, smoke.BATCH, n_vec_used=2, seed=3)
    return t, [dataclasses.replace(q, tenant_id=i % smoke.TENANTS)
               for i, q in enumerate(wl)]


def test_tenant_table_is_the_benchmark_s(smoke, tenant_part):
    """run_semcache's tenant column (its generator's first draw), the
    base columns shared, and the trace its generator draws next."""
    t, _ = tenant_part
    rng = np.random.default_rng(11)
    want = rng.integers(0, 3, 300).astype(np.float32)
    np.testing.assert_array_equal(t.scalars[:, -1].numpy(), want)
    assert t.schema.scalar_cols[-1].name == "tenant" and t.schema.n_scalar == 5
    trace = list(range(16)) + list(rng.integers(0, 16, 64))
    assert smoke.semcache_draws(300)[1] == trace


def test_hot_case_is_what_hot_topk_launches(smoke, tenant_part,
                                           monkeypatch):
    """Phase 3's hot case holds exactly the arguments ``tiered._hot_topk``
    passes the gather kernel for the same view and queries."""
    from repro_torch.core.executor import K_BUCKET_FLOOR, next_bucket
    from repro_torch.kernels import gather_score as gs
    from repro_torch.vectordb import predicates, tiered

    t, qs = tenant_part
    ((label, variant, a),) = smoke.hot_case(t, qs, "cpu")
    assert variant == "fp32" and "S=2048" in label
    seen = {}
    monkeypatch.setattr(gs, "gather_score_topk", lambda *args, **kw: (
        seen.update(args=args, kw=kw)
        or (torch.zeros((32, kw["k"]), dtype=torch.int32),) * 3))
    view = tiered.HotView(
        tuple(v.numpy() for v in a["vectors"]), a["scalars"].numpy(),
        smoke.HOT_CASE_ROWS, t.n_rows, "cpu")
    tiered._hot_topk(tiered.view_args(view), a["qs"], a["w"], a["pred"],
                     k=next_bucket(10, K_BUCKET_FLOOR), metric="dot")
    cand, vecs, q_b, w, scal, pred = seen["args"]
    assert torch.equal(cand, a["cand"]) and torch.equal(scal, a["scalars"])
    assert (cand[:, smoke.HOT_CASE_ROWS:] == -1).all()
    assert (cand[:, :smoke.HOT_CASE_ROWS] >= 0).all()
    for x, y in zip(vecs + q_b, a["vectors"] + a["qs"]):
        assert torch.equal(x, y)
    assert torch.equal(w, a["w"]) and seen["kw"]["k"] == a["k"] == 16
    for f in ("active", "lo", "hi"):
        assert torch.equal(getattr(pred, f), getattr(a["pred"], f))
    # the tenant equality is folded into every clause: a row qualifies
    # iff it passes the query's own predicate and holds its tenant
    assert predicates.as_set(a["pred"]).active[..., -1].all()
    got = predicates.eval_mask(a["pred"], t.scalars)
    for j, q in enumerate(qs[:32]):
        own = predicates.eval_mask(q.predicates, t.scalars)
        assert torch.equal(got[j], own & (t.scalars[:, -1] == q.tenant_id))


def _audited(smoke):
    from repro_torch.serve.semcache import SemanticCache

    cache = SemanticCache(eps=0.0)
    return cache, smoke.audit_cache(cache)


def _cq(tenant=0, vec=(0.0, 1.0)):
    from repro_torch.core.query import MHQ
    from repro_torch.vectordb.predicates import Predicates

    return MHQ((torch.tensor(vec),), (1.0,),
               Predicates.from_conditions(2, {0: (0.0, 1.0)}, device="cpu"),
               k=3, tenant_id=tenant)


@pytest.mark.parametrize("fault", [None, "stale_epoch", "stale_hot_insert",
                                   "wrong_replay", "other_query"])
def test_cache_event_check(smoke, fault):
    cache, events = _audited(smoke)
    q = _cq()
    cache.insert(q, (0, 100), np.arange(3), np.zeros(3, np.float32))
    assert cache.lookup(q, (0, 100)) is not None
    assert cache.lookup(_cq(vec=(1.0, 0.0)), (0, 100)) is None
    if fault is None:
        assert smoke.check_cache_events(events, "x") == 1
        return
    kind, eq, token, res = events[1]
    if fault == "stale_epoch":  # the hit served under the next epoch
        events[1] = (kind, eq, (1, 100), res)
    elif fault == "stale_hot_insert":  # ... or after one hot row
        events[1] = (kind, eq, (0, 101), res)
    elif fault == "wrong_replay":
        events[1] = (kind, eq, token, (res[0][::-1].copy(), res[1]))
    else:  # a hit for a query no miss stored
        events[1] = (kind, _cq(vec=(1.0, 0.0)), token, res)
    with pytest.raises(AssertionError,
                       match="replay" if fault == "wrong_replay" else "stale"):
        smoke.check_cache_events(events, "x")


def test_tenant_id_check_refuses_another_tenant_s_row(smoke):
    tcol = np.array([0, 1, 2, 0, 1, 2], np.float32)
    good = [(np.array([0, 3, -1]), None), (np.array([4, 1]), None)]
    smoke.check_tenant_ids(good, [0, 1], tcol, "x")
    smoke.check_tenant_ids([(np.array([5]), None)], [None], tcol, "x")
    for bad in ([(np.array([0, 4]), None)], [(np.array([0, 6]), None)]):
        with pytest.raises(AssertionError, match="another tenant"):
            smoke.check_tenant_ids(bad, [0], tcol, "x")


def test_missed_hot_row_check(smoke):
    oracle_i = np.array([12, 3, 11, 5])
    oracle_s = np.array([9.0, 8.0, 7.0, 6.0], np.float32)
    served = (np.array([12, 3, 11, 5]), oracle_s)
    assert smoke.missed_hot_rows(*served, oracle_i, oracle_s, 10) == []
    # hot row 11 dropped for a cold row: refused
    got = (np.array([12, 3, 5, 4]), np.array([9, 8, 6, 5.5], np.float32))
    assert smoke.missed_hot_rows(*got, oracle_i, oracle_s, 10) == [11]
    # a cold row dropped is no hot miss
    got = (np.array([12, 3, 11, 7]), np.array([9, 8, 7, 5.9], np.float32))
    assert smoke.missed_hot_rows(*got, oracle_i, oracle_s, 10) == []
    # hot row 11 tied with the served k-th: the merge may keep the other
    got = (np.array([12, 3, 5, 4]), np.array([9, 8, 6, 7.0], np.float32))
    assert smoke.missed_hot_rows(*got, oracle_i, oracle_s, 10) == []


def test_snapshot_topk_is_the_tiered_oracle(smoke, tenant_part):
    """``snapshot_topk`` over a snapshot with two hot views against
    ``tests/oracle.tiered_brute_force_topk`` (float64)."""
    from oracle import tiered_brute_force_topk

    from repro_torch.vectordb import histogram, ivf
    from repro_torch.vectordb.predicates import fold_conjunct
    from repro_torch.vectordb.tiered import TieredTable

    t, qs = tenant_part
    tt = TieredTable(t, [ivf.build(v, 4) for v in t.vectors],
                     histogram.build(t.scalars), hot_capacity=40)
    tt.insert(*smoke.tenant_skewed_insert(t, 50, 5))  # sealed + active
    snap = tt.snapshot()
    assert len(snap.hot_views) == 2 and snap.n_rows == 350
    folded = [dataclasses.replace(q, predicates=fold_conjunct(
        q.predicates, 4, float(q.tenant_id), float(q.tenant_id)))
        for q in qs[:20]]
    ids, scores = smoke.snapshot_topk(snap, folded)
    segs = [([v.numpy() for v in t.vectors], t.scalars.numpy())] + [
        ([b[: v.count] for b in v.np_vectors], v.np_scalars[: v.count])
        for v in snap.hot_views]
    hot_seen = 0
    for q, i, s in zip(folded, ids, scores):
        want_i, want_s, _ = tiered_brute_force_topk(
            segs, "dot", [x.numpy() for x in q.query_vectors], q.weights,
            q.predicates, q.k)
        np.testing.assert_array_equal(i, want_i)
        live = want_i >= 0
        np.testing.assert_allclose(s[live], want_s[live], rtol=1e-5,
                                   atol=1e-4)
        hot_seen += int((i >= 300).sum())
    assert hot_seen > 0


def _tiered_log(smoke):
    """A first rank's two sessions (one batch each) and a follower that ran
    them alike."""
    res = [(np.array([3, 9, -1]), np.array([2.0, 1.5, NEG], np.float32))]
    warm = [dict(stamp=(0, 8, 8), results=res, status=["ok"])]
    batches = [dict(stamp=(0, 8, 10), results=res, status=["ok"]),
               dict(stamp=(1, 12, 12), results=res, status=["ok"])]
    front = dict(warm=warm, batches=batches, final=(1, 12, 12))
    followed = [dict(results=[[_copy_res(r) for r in res]], errors={},
                     stamps=[(0, 8, 8)], final=(0, 8, 8)),
                dict(results=[[_copy_res(r) for r in res]] * 2, errors={},
                     stamps=[(0, 8, 10), (1, 12, 12)], final=(1, 12, 12))]
    return front, followed


def _copy_res(r):
    return (r[0].copy(), r[1].copy())


@pytest.mark.parametrize("fault", [None, "result", "stamp", "final",
                                   "error"])
def test_tiered_follower_check(smoke, fault):
    """Phase 11 (d): a follower equal to the first rank batch for batch, on
    the same stamps, ending on its final stamp, passes; a differing
    result, a batch run on a snapshot other than its stamp, another final
    stamp or a failed batch is refused."""
    front, followed = _tiered_log(smoke)
    if fault == "result":
        followed[1]["results"][1] = [(np.array([3, 8, -1]),
                                      followed[1]["results"][1][0][1])]
    elif fault == "stamp":
        followed[1]["stamps"][0] = (0, 8, 9)
    elif fault == "final":
        followed[1]["final"] = (1, 12, 13)
    elif fault == "error":
        followed[1]["errors"] = {0: "RuntimeError('x')"}
    if fault is None:
        assert smoke.check_tiered_followers(front, followed, "x") == 3
    else:
        with pytest.raises(AssertionError, match="x"):
            smoke.check_tiered_followers(front, followed, "x")


@pytest.mark.parametrize("fault", [None, "digest", "rows", "epochs"])
def test_tiered_digest_check(smoke, fault):
    """Phase 11 (d): every rank's epochs on the same rows with equal
    cold-state digests pass; an unequal digest, other rows or a missing
    epoch on one rank is refused."""
    recs = [[dict(epoch=e, a=8 + 4 * e, b=12 + 4 * e, digest=100 + e)
             for e in (1, 2)] for _ in range(4)]
    if fault == "digest":
        recs[2][1] = dict(recs[2][1], digest=7)
    elif fault == "rows":
        recs[3][0] = dict(recs[3][0], b=13)
    elif fault == "epochs":
        recs[1] = recs[1][:1]
    if fault is None:
        assert smoke.check_digests(recs, "x") == 2
    else:
        with pytest.raises(AssertionError, match="x"):
            smoke.check_digests(recs, "x")


@pytest.mark.parametrize("fault", [None, "untied_id", "score"])
def test_tiered_replay_check(smoke, fault):
    """A replayed batch equal to the mesh's, or differing only between tied
    slots, passes; an untied id or a score beyond 1e-5 is refused."""
    want = [(np.array([4, 5, 6]), np.array([3.0, 2.0, 2.0], np.float32))]
    got = [(np.array([4, 6, 5]), np.array([3.0, 2.0, 2.0], np.float32))]
    if fault == "untied_id":
        got = [(np.array([5, 4, 6]), want[0][1].copy())]
    elif fault == "score":
        got = [(want[0][0].copy(), want[0][1] + np.float32(1e-3))]
    if fault is None:
        assert smoke.check_replayed(got, want, "x") == 2
    else:
        with pytest.raises(AssertionError, match="x"):
            smoke.check_replayed(got, want, "x")


def test_tiered_hot_row_check_on_a_snapshot(smoke, tenant_part):
    """Phase 11 (d)'s oracle check on a snapshot with two hot views: the
    oracle's own results pass; the same results with a hot row of some
    top-k replaced by the next row down are refused; a replayed snapshot
    stands at its stamp, and refuses another."""
    from repro_torch.vectordb import histogram, ivf
    from repro_torch.vectordb.predicates import fold_conjunct
    from repro_torch.vectordb.tiered import TieredTable

    t, qs = tenant_part
    tt = TieredTable(t, [ivf.build(v, 4) for v in t.vectors],
                     histogram.build(t.scalars), hot_capacity=40)
    rows = smoke.tenant_skewed_insert(t, 50, 5)
    tt.insert(*rows)
    snap = tt.snapshot()
    folded = [dataclasses.replace(q, predicates=fold_conjunct(
        q.predicates, 4, float(q.tenant_id), float(q.tenant_id)))
        for q in qs[:20]]
    ids, scores = smoke.snapshot_topk(snap, folded)
    served = [(i.copy(), s.copy()) for i, s in zip(ids, scores)]
    assert smoke.check_hot_rows(snap, folded, served, "x") > 0
    j = next(j for j, i in enumerate(ids) if (i[:-1] >= 300).any())
    p = int(np.flatnonzero(ids[j][:-1] >= 300)[0])
    bad = [(i.copy(), s.copy()) for i, s in served]
    bad[j][0][p:-1], bad[j][1][p:-1] = ids[j][p + 1:], scores[j][p + 1:]
    with pytest.raises(AssertionError, match="miss"):
        smoke.check_hot_rows(snap, folded, bad, "x")
    again = smoke.replay_snapshot(
        tt, snap.stamp, [(v.id_offset, v.count) for v in snap.hot_views],
        rows, 300)
    assert smoke.check_hot_rows(again, folded, served, "x") > 0
    with pytest.raises(AssertionError, match="stamp"):
        smoke.replay_snapshot(tt, (0, 300, 350), [(300, 40), (340, 9)],
                              rows, 300)


@pytest.mark.parametrize("epochs,final,ok", [
    ([0, 0, 1, 4, 9], 9, True),
    ([3, 9], 9, True),
    ([0, 0, 0], 0, False),  # the stream never crossed a swap
    ([0, 1], 9, False),  # no batch ran on the final epoch
])
def test_epochs_served_check(smoke, epochs, final, ok):
    if ok:
        smoke.check_epochs_served(epochs, final, "x")
    else:
        with pytest.raises(AssertionError, match="across a swap"):
            smoke.check_epochs_served(epochs, final, "x")


def test_count_launches_counts_only_its_window(smoke):
    """Launches before a window are not counted, each window's add up,
    and the compaction warm-up's go apart."""
    from repro_torch.kernels import gather_score as gs

    def serve(n_fp32, n_prewarm):
        for _ in range(n_fp32):
            gs._count_launch("fp32")
        with gs.counted_as(gs.PREWARM_LAUNCHES):
            for _ in range(n_prewarm):
                gs._count_launch("fp32")
        gs._count_launch("int8")
        return "done"

    counts = {n: {"fp32": 0, "int8": 0} for n in ("serving", "prewarm")}
    serve(5, 5)  # a comparison before the window
    assert smoke.count_launches(lambda: serve(3, 1), counts) == "done"
    serve(7, 0)  # and one between the windows
    smoke.count_launches(lambda: serve(2, 4), counts)
    assert counts == {"serving": {"fp32": 5, "int8": 2},
                      "prewarm": {"fp32": 5, "int8": 0}}


# ---------------------------------------------------------------------------
# phase 10's checks (logical shards)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded(smoke):
    """(2,000-row ``part``, its IVF indexes of 16 clusters, 32 queries, and
    their results through ``execute_batch_sharded`` over 2 shards under
    the exact scan and under per-shard probing)."""
    from repro_torch.bench import datasets, queries as qgen
    from repro_torch.core.query import ExecutionPlan, SubqueryParams
    from repro_torch.serve.batch import (
        DENSE, SHARDED_LOCAL, BatchedHybridExecutor, CostModel,
    )
    from repro_torch.vectordb import ivf

    t = datasets.make("part", rows=2000, seed=0, device="cpu")
    idx = [ivf.build(v, 16, seed=i) for i, v in enumerate(t.vectors)]
    wl = qgen.gen_workload(t, 24, n_vec_used=2, seed=3) + \
        qgen.gen_dnf_workload(t, 8, n_vec_used=2, seed=4)
    exact = BatchedHybridExecutor(t, idx, n_shards=2,
                                  cost_model=CostModel(force=DENSE)
                                  ).execute_batch_sharded(wl)
    plan = ExecutionPlan("index_scan", tuple(SubqueryParams(
        k_mult=2, nprobe=2, max_scan=256, iterative=False)
        for _ in range(2)))
    probed = BatchedHybridExecutor(t, idx, n_shards=2,
                                   cost_model=CostModel(force=SHARDED_LOCAL)
                                   ).execute_batch_sharded(
        wl, [plan] * len(wl))
    return t, idx, wl, exact, probed


def _plant(results, j, ids=None, scores=None):
    out = [(i.copy(), s.copy()) for i, s in results]
    if ids is not None:
        out[j][0][:] = ids
    if scores is not None:
        out[j][1][:] = scores
    return out


def test_served_check_passes_both_routes(smoke, sharded):
    t, _, wl, exact, probed = sharded
    for res in (exact, probed):
        assert smoke.check_served(t, wl, res, "x") <= smoke.ATOL


@pytest.mark.parametrize("fault", ["out_of_range", "twice", "fails_pred",
                                   "wrong_score", "empty_scored"])
def test_served_check_refuses(smoke, sharded, fault):
    from repro_torch.vectordb import predicates

    t, _, wl, exact, _ = sharded
    j = next(j for j, q in enumerate(wl)
             if not predicates.eval_mask(q.predicates, t.scalars).all()
             and (exact[j][0] >= 0).sum() >= 2)
    ids, sc = exact[j]
    if fault == "out_of_range":
        bad, msg = _plant(exact, j, ids=np.where(ids == ids[0], t.n_rows,
                                                 ids)), "out of range"
    elif fault == "twice":
        bad, msg = _plant(exact, j, ids=np.where(ids == ids[1], ids[0],
                                                 ids)), "twice"
    elif fault == "fails_pred":
        row = int(np.flatnonzero(~predicates.eval_mask(
            wl[j].predicates, t.scalars).numpy())[0])
        bad, msg = _plant(exact, j, ids=np.where(ids == ids[0], row,
                                                 ids)), "fails"
    elif fault == "wrong_score":
        bad, msg = _plant(exact, j, scores=sc + np.float32(0.1) * (
            ids >= 0)), "not its row"
    else:
        bad, msg = _plant(exact, j), "empty slot"
        bad[j][0][-1], bad[j][1][-1] = -1, sc[0]
    with pytest.raises(AssertionError, match=msg):
        smoke.check_served(t, wl, bad, "x")


def test_exact_check_refuses_a_wrong_id_from_the_exact_route(smoke, sharded):
    """The exact route's results pass; a row swapped for one ranked below
    the top-k (its true score planted with it) is refused."""
    from repro_torch.vectordb import flat

    t, _, wl, exact, _ = sharded
    assert smoke.check_exact(t, wl, exact, "x") >= 0
    j = next(j for j, (ids, _) in enumerate(exact) if (ids >= 0).all())
    q = wl[j]
    ids20, s20 = flat.ground_truth(t, list(q.query_vectors), list(q.weights),
                                   q.predicates, 20)
    bad = _plant(exact, j)
    bad[j][0][-1], bad[j][1][-1] = int(ids20[15]), float(s20[15])
    with pytest.raises(AssertionError):
        smoke.check_exact(t, wl, bad, "x")


def test_same_results_check_refuses_a_differing_s1_result(smoke, sharded):
    _, _, _, exact, _ = sharded
    smoke.check_same_results(exact, _plant(exact, 0), "x")
    ids, sc = exact[3]
    with pytest.raises(AssertionError, match="query 3 differs"):
        smoke.check_same_results(exact, _plant(exact, 3, ids=ids[::-1]),
                                 "x")
    with pytest.raises(AssertionError, match="query 3 differs"):
        smoke.check_same_results(
            exact, _plant(exact, 3, scores=np.nextafter(sc, np.float32(0))),
            "x")


def test_shard_launch_check_refuses_launches_growing_with_shards(smoke):
    ok = [dict(shards=s, cols=c, fp32=c + 1, int8=0)
          for s in (2, 4) for c in (1, 2)]
    smoke.check_shard_launches(ok, "x")
    for bad in (dict(shards=4, cols=2, fp32=2 * 4 + 1, int8=0),
                dict(shards=2, cols=1, fp32=2, int8=1)):
        with pytest.raises(AssertionError, match="expected"):
            smoke.check_shard_launches(ok + [bad], "x")


def test_sharded_case_is_what_the_probing_path_launches(smoke, sharded,
                                                        monkeypatch):
    """Phase 3's sharded case holds the candidates ``sharded_ivf_topk``
    gives the gather kernel for its first probed column, on the same
    per-shard index and queries: the first ``BATCH`` queries folded over
    ``SHARD_PROBE`` shards, global ids, each row's slots in its own
    shard."""
    from repro_torch.core.executor import legalize_for_shard, subquery_width
    from repro_torch.kernels import gather_score as gs
    from repro_torch.vectordb import distributed, predicates

    t, _, wl, _, _ = sharded
    ((label, variant, a),) = smoke.sharded_case(t, wl, "cpu")
    assert variant == "fp32" and a["cand"].shape[0] == smoke.SHARD_PROBE \
        * smoke.BATCH
    sivf = distributed.build_sharded_ivf(t.vectors[0], smoke.SHARD_PROBE,
                                         n_clusters=32, seed=0)
    k_s, np_s, ms_s = legalize_for_shard(
        20, 2, smoke.SHARD_MAX_SCAN, n_shards=smoke.SHARD_PROBE,
        shard_len=sivf.shard_len, n_clusters=sivf.n_clusters)
    seen = []
    monkeypatch.setattr(gs, "gather_score_topk", lambda cand, *args, **kw: (
        seen.append((cand, args, kw))
        or (torch.full((cand.shape[0], kw["k"]), -1, dtype=torch.int32),
            torch.full((cand.shape[0], kw["k"]), NEG),
            torch.zeros(cand.shape[0], dtype=torch.int32))))
    fn = distributed.sharded_ivf_topk(
        smoke.SHARD_PROBE, subs=((0, k_s, subquery_width(k_s, ms_s), np_s,
                                  ms_s),), k=10, metric="dot", pad_total=64)
    qs = wl[: smoke.BATCH]
    fn((sivf.centroids,), (sivf.sorted_rows,), (sivf.offsets,),
       (t.vectors[0],), t.scalars, predicates.take(a["pred"],
                                                   np.arange(len(qs))),
       (a["qs"][0][: len(qs)],), torch.ones((len(qs), 1)))
    cand, args, kw = seen[0]
    assert torch.equal(cand, a["cand"]) and kw["k"] == a["k"]
    for f in ("active", "lo", "hi", "clause_valid"):
        assert torch.equal(getattr(args[4], f), getattr(a["pred"], f))
    shard = torch.arange(cand.shape[0]) // len(qs)
    live = cand >= 0
    assert (live.sum(1) > 0).all()
    assert ((cand.long() // sivf.shard_len == shard[:, None]) | ~live).all()
    for x, y in zip(a["qs"], [torch.stack([q.query_vectors[i] for q in qs])
                              for i in range(2)]):
        assert torch.equal(x, y.repeat(smoke.SHARD_PROBE, 1))


# ---------------------------------------------------------------------------
# phase 11's check (the mesh against the logical shards)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def logical4(smoke, sharded):
    """A fixed-plan pass over 4 logical shards of ``sharded``'s table,
    recorded as phase 11 holds a mesh pass to it: results, escalated
    queries and each probing search's per-shard fill and boundary."""
    from repro_torch.core.query import ExecutionPlan, SubqueryParams
    from repro_torch.serve.batch import (
        SHARDED_LOCAL, BatchedHybridExecutor, CostModel,
    )

    t, idx, wl, _, _ = sharded
    plan = ExecutionPlan("index_scan", tuple(SubqueryParams(
        k_mult=2, nprobe=2, max_scan=256, iterative=False)
        for _ in range(2)))
    bx = BatchedHybridExecutor(t, idx, n_shards=4,
                               cost_model=CostModel(force=SHARDED_LOCAL))
    with smoke.sharded_records() as rec:
        results, escalated, _ = smoke.fixed_batches(
            bx, wl, [plan] * len(wl), rec)
        probes = smoke._host_probes(rec["probes"])
    assert probes and all(f.shape[1] == 4 for f, _ in probes)
    return t, dict(results=results, escalated=set(escalated), probes=probes)


def _copy_pass(p):
    return dict(results=[(i.copy(), s.copy()) for i, s in p["results"]],
                escalated=set(p["escalated"]),
                probes=[(f.copy(), b.copy()) for f, b in p["probes"]])


def test_mesh_check_passes_the_logical_pass(smoke, logical4):
    _, want = logical4
    smoke.check_mesh_pass(_copy_pass(want), want, "x")
    smoke.check_mesh_pass(_copy_pass(want), want, "x", atol=0.0)


@pytest.mark.parametrize("fault", ["reversed", "local_ids", "escalated",
                                   "score"])
def test_mesh_check_refuses(smoke, logical4, fault):
    """Ranks gathered in reverse order (each probing search's per-shard
    fill and boundary in reversed shard order, as such a gather returns
    them), one shard's ids left local (shard 2's rows, less its first
    row), query 0 escalated or not where the logical pass differs, and a
    live score moved by 1e-4."""
    t, want = logical4
    got = _copy_pass(want)
    per = t.n_rows // 4
    if fault == "reversed":
        got["probes"] = [(f[:, ::-1].copy(), b[:, ::-1].copy())
                         for f, b in got["probes"]]
        msg = "shard order"
    elif fault == "local_ids":
        for ids, _ in got["results"]:
            mine = (ids >= 2 * per) & (ids < 3 * per)
            ids[mine] -= 2 * per
        assert any(((i >= 2 * per) & (i < 3 * per)).any()
                   for i, _ in want["results"])
        msg = "ids differ"
    elif fault == "escalated":
        got["escalated"] ^= {0}
        msg = "escalated"
    else:
        j = next(j for j, (ids, _) in enumerate(got["results"]) if ids[0] >= 0)
        got["results"][j][1][0] += np.float32(1e-4)
        msg = "scores differ"
    with pytest.raises(AssertionError, match=msg):
        smoke.check_mesh_pass(got, want, "x")


# ---------------------------------------------------------------------------
# phase 12 (c): every sync inside a hot function accounted for
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sync_lint():
    """(phase 12 (a)'s findings on the shipped tree, AST only; a line of
    ``serve/batch.py`` that is a finding inside a hot function; the first
    line of ``_batched_subquery``, inside it and no finding)."""
    from repro_torch.analysis.astpass import ModuleLint
    from repro_torch.analysis.config import LintConfig
    from repro_torch.analysis.runner import run_paths

    res = run_paths([str(ROOT / "src" / "repro_torch")],
                    LintConfig(runtime=False))
    path = "src/repro_torch/serve/batch.py"
    findings = [dict(f.to_dict(), path=path) for f in
                res["active"] + res["suppressed"]
                if f.path.endswith("serve/batch.py")]
    spans = ModuleLint(path, (ROOT / path).read_text(),
                       LintConfig(runtime=False),
                       relpath=path).hot_spans()
    sub = next(a for a, _, qn in spans
               if qn == "BatchedHybridExecutor._batched_subquery")
    hot = next(f["line"] for f in findings
               if any(a <= f["line"] <= z for a, z, _ in spans))
    return dict(findings=findings), path, hot, sub


@pytest.mark.parametrize("case,accepted", [
    ("raised_at_a_finding", True),
    ("raised_in_a_hot_function_off_the_findings", False),
    ("listed_helper", True),
    ("unlisted_helper", False),
    ("unlisted_helper_called_at_a_finding", True),
    ("outside_the_port", True),
])
def test_sync_phase_accounts_for_every_hot_sync(smoke, sync_lint,
                                                monkeypatch, case, accepted):
    lint, path, hot, sub = sync_lint
    pred = "src/repro_torch/vectordb/predicates.py"
    stack = {
        "raised_at_a_finding": ((path, hot, "f"),),
        "raised_in_a_hot_function_off_the_findings": ((path, sub, "f"),),
        "listed_helper": ((pred, 1, "take"),
                          (path, sub, "_batched_subquery")),
        "unlisted_helper": ((pred, 1, "stack"),
                            (path, sub, "_batched_subquery")),
        "unlisted_helper_called_at_a_finding": ((pred, 1, "stack"),
                                                (path, hot, "f")),
        "outside_the_port": (),
    }[case]
    monkeypatch.setattr(smoke, "sync_sites", lambda run: {stack: 3})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    class Served:
        def bind_cost_model(self, cm=None):
            pass

        def execute_batch(self, batch):
            pass

    if accepted:
        out = smoke.sync_phase(Served(), list(range(40)), lint)
        assert out["default"]["syncs"] == 3
    else:
        with pytest.raises(AssertionError, match="rule misses"):
            smoke.sync_phase(Served(), list(range(40)), lint)


def test_lm_check_refuses_a_logit_outside_the_tolerance(smoke):
    want = torch.linspace(-3.0, 3.0, 40).reshape(2, 20)
    assert smoke._held(want + 5e-5, want, 1e-4, 1e-4, "x") == \
        pytest.approx(5e-5, rel=1e-2)
    with pytest.raises(AssertionError, match="max abs err"):
        smoke._held(want + 3e-4, want, 1e-4, 1e-4, "x")


class _HostEvent:
    """``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_lm_phase_runs_on_the_cpu(smoke, monkeypatch):
    """Phase 13's code paths at the smoke config's size, the CUDA events,
    graph replays and profiles stubbed, the CLI's device sent to the
    CPU."""
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(smoke, "graph_time_ms",
                        lambda fn, iters=20: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "profile_batch",
                        lambda run, top=8: (run(), {})[1])
    monkeypatch.setattr(serve, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    out = smoke.lm_phase(torch.device("cpu"), smoke=True)
    assert [p["arch"] for p in out["parity"]] == ["stablelm-smoke",
                                                  "qwen3-14b-smoke"]
    b = out["decode_vs_forward"]
    assert b["beyond_n_params"] and all(
        k.endswith(".bias") for k in b["beyond_n_params"])
    assert b["params"] == b["n_params"] + sum(b["beyond_n_params"].values())
    assert out["generate"]["steps"] == 6 and out["embed"]["rows"] == 300
    assert out["serve"]["shape"] == [4, 16]


def _stub_timers(smoke, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(smoke, "graph_time_ms",
                        lambda fn, iters=20: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "profile_batch",
                        lambda run, top=8: (run(), {})[1])
    monkeypatch.setattr(serve, "resolve_device",
                        lambda device=None: torch.device("cpu"))


def test_ssm_phase_runs_on_the_cpu(smoke, monkeypatch):
    """Phase 14's code paths at the smoke configs' size, the CUDA events,
    graph replays and profiles stubbed, the CLI's device sent to the
    CPU."""
    _stub_timers(smoke, monkeypatch)
    out = smoke.ssm_phase(torch.device("cpu"), smoke=True)
    assert [p["arch"] for p in out["parity"]] == ["mamba2-smoke",
                                                  "zamba2-smoke"]
    for b in out["decode_vs_forward"]:
        assert b["params"] == b["n_params"] + sum(b["beyond_n_params"].values())
        assert (b["prompt"], b["forward_len"]) == (16, 32)
    mamba, zamba = out["generate"]
    for g in (mamba, zamba):
        assert g["steps"] == 6 and g["dtype"] == "float32"
        assert g["decode_bound_ms"] > 0 and g["prefill_bound_ms"] > 0
        assert g["decode_bytes"]["state"] > 0
    assert mamba["decode_bytes"]["kv"] == 0 < zamba["decode_bytes"]["kv"]
    assert [s["shape"] for s in out["serve"]] == [[4, 16], [4, 16]]


def test_ssm_check_refuses_a_logit_outside_the_tolerance(smoke, monkeypatch):
    from repro_torch.models import lm

    real = lm.decode_step

    def off(*a, **kw):
        logits, cache = real(*a, **kw)
        return logits + 0.05, cache

    kw = dict(arch="mamba2-370m", phase="14 (b)", smoke=True, b=2,
              prompt=16, total=32)
    out = smoke.lm_decode_matches_forward(torch.device("cpu"), **kw)
    assert out["max_abs_err"] < smoke.DECODE_ATOL
    monkeypatch.setattr(lm, "decode_step", off)
    with pytest.raises(AssertionError, match=r"14 \(b\) mamba2-smoke"):
        smoke.lm_decode_matches_forward(torch.device("cpu"), **kw)


def test_param_count_gap_names_each_leaf(smoke):
    """The padded vocab's rows (of the table and of an untied head) and
    the LayerNorm biases are what a model holds beyond ``n_params()``."""
    from repro_torch import configs
    from repro_torch.models import lm

    padded = dataclasses.replace(configs.get_config("zamba2-2.7b",
                                                    smoke=True),
                                 vocab_pad_multiple=48)
    model = lm.init(padded, device="cpu")
    gap = smoke.param_count_gap(model)
    assert gap == {"embed.table": 32 * 64, "lm_head.w": 32 * 64}
    n = sum(p.numel() for p in model.parameters())
    assert n == padded.n_params() + sum(gap.values())
    dense = lm.init(configs.get_config("stablelm-1.6b", smoke=True),
                    device="cpu")
    gap = smoke.param_count_gap(dense)
    assert gap and all(k.endswith(".bias") for k in gap)
    assert sum(p.numel() for p in dense.parameters()) == \
        dense.cfg.n_params() + sum(gap.values())


def test_f32_param_generation_runs_on_the_cpu(smoke):
    """Phase 13 (f)'s code path at the smoke config's size: ``qwen3``
    generating in bf16 on f32 parameters, each block cast at its use."""
    out = smoke.lm_generate_f32_params(torch.device("cpu"), smoke=True, b=2,
                                       prompt=16, steps=4)
    assert (out["dtype"], out["param_dtype"]) == ("bfloat16", "float32")
    assert out["whole_copy_bytes"] * 2 < out["params_bytes"]
    assert (out["batch"], out["steps"]) == (2, 4)


def test_moe_phase_runs_on_the_cpu(smoke, monkeypatch):
    """Phase 15's code paths at the smoke configs' size, the CUDA events,
    graph replays and profiles stubbed: the sharded MoE's four ``gloo``
    rank processes import this module by name."""
    import sys

    _stub_timers(smoke, monkeypatch)
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)
    monkeypatch.syspath_prepend(str(ROOT))
    out = smoke.moe_phase(torch.device("cpu"), smoke=True)
    assert [p["arch"] for p in out["parity"]] == ["deepseek-v3-smoke",
                                                  "kimi-k2-smoke"]
    assert all(p["aux"]["moe_drop_frac"] > 0 for p in out["parity"])
    sharded = out["sharded"]
    assert sharded["ranks"] == 4 and sharded["drop_frac"] > 0
    assert sharded["no_drop_max_abs_err"] < 1e-4
    b = out["decode_vs_forward"]
    assert b["n_layers"] == 2 and set(b["beyond_n_params"]) == {"mtp"}
    assert b["beyond_n_params"]["mtp"] < 0  # n_params() counts a MoE FFN
    assert b["params"] == b["n_params"] + b["beyond_n_params"]["mtp"]
    for g in out["generate"]:
        assert g["steps"] == 6 and g["dtype"] == g["param_dtype"] == \
            "bfloat16"
        assert g["decode_bound_ms"] > 0 and g["prefill_bound_ms"] > 0
        assert 0.0 <= g["moe_drop_frac"] < 1.0
    ds, kimi = out["generate"]
    assert ds["decode_bytes"]["cache"] > 0 and kimi["n_layers"] == 2


def test_moe_bounds_count_every_expert(smoke):
    """A decode step's bytes hold every expert's weights (the GShard
    einsum runs them all) and the head once; the prefill's bf16 products
    grow with the capacity factor."""
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get_config("kimi-k2-1t-a32b",
                                                 smoke=True),
                              param_dtype="bfloat16", dtype="bfloat16")
    model = lm.init(cfg, device="cpu")
    bounds = smoke.moe_bounds(model, 2, 32, 4)
    experts = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 2
    head = cfg.d_model * cfg.vocab_padded * 2
    assert bounds["decode_bytes"]["weights"] > experts + head
    wide = dataclasses.replace(cfg, capacity_factor=8.0)
    model.cfg = wide
    more = smoke.moe_bounds(model, 2, 32, 4)
    assert more["capacity"] > bounds["capacity"]
    assert more["prefill_flops"]["bf16"] > bounds["prefill_flops"]["bf16"]


def test_train_phase_runs_on_the_cpu(smoke):
    """Phase 16 on the CPU: (a) card against CPU is then CPU against CPU
    (the same numbers), (b) and (c) at the smoke configs' size, the
    profile left out (it runs on the card only)."""
    out = smoke.train_phase(torch.device("cpu"), smoke=True)
    assert [(p["arch"], p["plan"]) for p in out["parity"]] == [
        (a, p) for a in ("stablelm-smoke", "deepseek-v3-smoke",
                         "mamba2-smoke", "zamba2-smoke")
        for p in smoke.TRAIN_SMOKE_PLANS]
    for p in out["parity"]:
        assert p["param_max_abs_err"] == 0.0 == p["loss_max_abs_err"]
    full = out["full_width"]
    assert len(full["losses"]) == 8 and full["losses"][-1] < full["losses"][0]
    assert set(full["first_step"]) == {"remat, 4 microbatches",
                                       "no remat, 4 microbatches",
                                       "remat, 1 microbatch"}
    assert full["bound_ms"] > 0 and full["flops"]["head"] > 0
    cli = out["ssm_cli"]
    assert len(cli["straight"]) == 4 and cli["resumed"] == cli["straight"][2:]
    assert cli["checkpoint_bytes"] > 0


def test_train_parity_refuses_a_parameter_off(smoke, monkeypatch):
    """(a) fails once the second run's updates (the card's) move every
    parameter by 1e-3."""
    from repro_torch.train import step

    real, calls = step.adamw_update, []

    def off(grads, state, params, cfg):
        new, st = real(grads, state, params, cfg)
        calls.append(1)
        if len(calls) > smoke.TRAIN_SMOKE_STEPS:
            new = {k: v + 1e-3 for k, v in new.items()}
        return new, st

    monkeypatch.setattr(step, "adamw_update", off)
    with pytest.raises(AssertionError, match="16 \\(a\\)"):
        smoke.train_parity("stablelm-1.6b", "adamw-f32", torch.device("cpu"))


def test_mesh17_walks_on_the_cpu_and_refuses_planted_offsets(smoke,
                                                            monkeypatch):
    """Phase 17 on the CPU: (a) the stablelm case over four ``gloo`` ranks
    against one process, (b) at the smoke size on a one-rank (1, 1) mesh,
    (c) the pipeline against the blocks in turn (the rank processes import
    this module by name); then each check refuses a planted offset: a
    loss off by 1e-3 in (a), a first loss off by 2e-3 relative in (b), a
    stage's output off by 1e-3 in (c), a predicted peak 20% off the
    measured one in (d)."""
    import sys

    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)
    monkeypatch.syspath_prepend(str(ROOT))
    cpu = torch.device("cpu")
    a = smoke.mesh17_train(cpu, cases=("stablelm-adamw-f32",))
    case = a["cases"]["stablelm-adamw-f32"]
    assert case["errors"]["loss"] < 1e-4 and case["errors"]["params"] < 1e-4
    assert case["collective_bytes"]["counts"]["all-reduce"] > 0
    b = smoke.mesh17_full_width(cpu, smoke=True, b=8, s=32, steps=2)
    assert len(b["losses"]) == 2 and all(np.isfinite(b["losses"]))
    assert smoke.check_first_loss(b["losses"][0], b["losses"][0]) == 0.0
    c = smoke.pipe17_check(cpu)
    assert c["handoff"] == "device" and c["ticks"] == 11
    assert c["max_abs_err"] <= smoke.PIPE_TOL and c["bubble"] == 3 / 11
    mesh = {"stablelm-adamw-f32": dict(
        losses=[{"loss": 1.0}], params={"w": torch.ones(3)})}
    one = {"stablelm-adamw-f32": dict(
        losses=[{"loss": 1.001}], params={"w": torch.ones(3)})}
    with pytest.raises(AssertionError, match="17 \\(a\\)"):
        smoke.check_mesh17(mesh, one)
    with pytest.raises(AssertionError, match="17 \\(b\\)"):
        smoke.check_first_loss(b["losses"][0] * (1 + 2e-3), b["losses"][0])
    want = torch.zeros(2, 3)
    assert smoke.check_pipe17([want.clone()], want) == 0.0
    with pytest.raises(AssertionError, match="17 \\(c\\)"):
        smoke.check_pipe17([want + 1e-3], want)
    assert smoke.check_peak(1.1e9, 1e9) == pytest.approx(0.1)
    with pytest.raises(AssertionError, match="17 \\(d\\)"):
        smoke.check_peak(1.2e9, 1e9)


def test_witness_check_refuses_a_record_without_a_step(smoke):
    """Phase 17 (d)'s ``check_witness`` passes a whole record and refuses
    a skipped cell, a record with no FLOPs and one whose peak is below its
    arguments."""
    from repro_torch.launch import dryrun

    cell = dryrun.WITNESS_CELLS[0]
    rec = dict(tag=dryrun.witness_id(cell), flops_per_dev=1.0,
               bytes_per_dev=2.0, peak_bytes_per_dev=8,
               arg_bytes_per_dev=4)
    assert smoke.check_witness(rec, cell) is rec
    for bad in (dict(rec, skipped="why"), dict(rec, flops_per_dev=0.0),
                dict(rec, peak_bytes_per_dev=2)):
        with pytest.raises(AssertionError, match="17 \\(d\\)"):
            smoke.check_witness(bad, cell)
