"""Gather-score parity between the JAX package and the PyTorch port.

The same numpy inputs go through three implementations of the
candidate-local gather+score+DNF-mask+top-k contract:

  * the JAX plain reference (``use_kernel=False``) and the JAX Pallas kernel
    in interpret mode (``use_kernel=True, interpret=True``);
  * the port's ``gather_score_topk`` on CPU tensors, which runs its plain
    version (``repro_torch.kernels.ref.gather_score_ref``).

Ids and qualifying counts must be equal; scores agree to ``atol=1e-3,
rtol=1e-4`` — the tolerance the JAX harness holds its own kernel to. The
fp32 and int8 (kernel 2) variants run over the same corpus as
``tests/test_gather_score.py`` against the JAX reference; the interpreted
Pallas kernel, which costs a compile per shape on the CPU, meets every
corpus case once — the even seeds in fp32, the odd seeds in int8. The
``cuda`` case runs only with a card and holds the port's CUDA kernel to its
plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax.numpy as jnp  # noqa: E402

from repro.kernels import gather_score as jgs  # noqa: E402
from repro.kernels.int8_scan import quantize_rows as j_quantize  # noqa: E402
from repro.vectordb import predicates as jp  # noqa: E402

from repro_torch.kernels import gather_score as tgs  # noqa: E402
from repro_torch.kernels.int8_scan import quantize_rows as t_quantize  # noqa: E402
from repro_torch.vectordb import predicates as tp  # noqa: E402

ATOL, RTOL = 1e-3, 1e-4


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip when this machine has none — decided when
    the test runs, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

# (seed, n, dims, m, b, s, c, k, metric) — the corpus of test_gather_score.py
CORPUS = [
    (0, 200, (16,), 2, 3, 64, 1, 5, "dot"),
    (1, 200, (16, 8), 3, 2, 33, 1, 5, "l2"),
    (2, 300, (8,), 2, 4, 100, 2, 10, "dot"),
    (3, 300, (8, 24), 2, 2, 57, 2, 7, "l2"),
    (4, 150, (32,), 4, 3, 48, 4, 10, "dot"),
    (5, 150, (8,), 3, 2, 96, 4, 3, "l2"),
    (6, 120, (8,), 2, 2, 3, 1, 5, "dot"),
    (7, 250, (16,), 2, 1, 129, 2, 10, "dot"),
]


def make_case(seed, n, dims, m, b, s, c, *, dup_frac=0.3, pad_frac=0.2,
              sel=0.5):
    """Numpy inputs: table columns, scalars, per-query DNF clauses (as
    ``{col: (lo, hi)}`` dicts), queries, weights and a candidate matrix
    with duplicates and -1 padding mixed in."""
    rng = np.random.default_rng(seed)
    vectors = [rng.normal(size=(n, d)).astype(np.float32) for d in dims]
    scalars = rng.uniform(0, 10, (n, m)).astype(np.float32)
    clauses = []
    for _ in range(b):
        cl = []
        for _ in range(c):
            lo = float(rng.uniform(0, 10 * (1 - sel)))
            cl.append({int(rng.integers(0, m)): (lo, lo + 10 * sel)})
        clauses.append(cl)
    qs = [rng.normal(size=(b, d)).astype(np.float32) for d in dims]
    w = rng.uniform(0.1, 1.0, (b, len(dims))).astype(np.float32)
    cand = rng.integers(0, n, size=(b, s))
    n_dup = int(s * dup_frac)
    if n_dup and s > 1:
        for row in cand:
            row[rng.integers(0, s, size=n_dup)] = \
                row[rng.integers(0, s, size=n_dup)]
    cand[rng.random(size=(b, s)) < pad_frac] = -1
    return dict(vectors=vectors, scalars=scalars, clauses=clauses, qs=qs,
                w=w, cand=cand.astype(np.int32), m=m, c=c)


def jax_pred(case):
    if case["clauses"] is None:
        return None
    return jp.stack([jp.PredicateSet.from_clauses(case["m"], cl,
                                                  n_clauses=case["c"])
                     for cl in case["clauses"]])


def torch_pred(case, device="cpu"):
    if case["clauses"] is None:
        return None
    return tp.stack([tp.PredicateSet.from_clauses(case["m"], cl,
                                                  n_clauses=case["c"],
                                                  device=device)
                     for cl in case["clauses"]])


def run_jax(case, *, k, metric, use_kernel, vectors=None, scales=None):
    vecs = case["vectors"] if vectors is None else vectors
    return jgs.gather_score_topk(
        jnp.asarray(case["cand"]), tuple(jnp.asarray(v) for v in vecs),
        tuple(jnp.asarray(q) for q in case["qs"]), jnp.asarray(case["w"]),
        jnp.asarray(case["scalars"]), jax_pred(case), k=k, metric=metric,
        use_kernel=use_kernel, interpret=True, block_s=32,
        scales=None if scales is None else tuple(jnp.asarray(s)
                                                 for s in scales))


def run_torch(case, *, k, metric, vectors=None, scales=None, device="cpu"):
    vecs = case["vectors"] if vectors is None else vectors

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return tgs.gather_score_topk(
        t(case["cand"]), tuple(t(v) for v in vecs),
        tuple(t(q) for q in case["qs"]), t(case["w"]), t(case["scalars"]),
        torch_pred(case, device), k=k, metric=metric,
        scales=None if scales is None else tuple(t(s) for s in scales))


def assert_same(a, b):
    ids_a, s_a, q_a = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                       for x in a)
    ids_b, s_b, q_b = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                       for x in b)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(q_a, q_b)
    np.testing.assert_allclose(s_a, s_b, atol=ATOL, rtol=RTOL)


def int8_replica(case):
    """The JAX package's int8 replicas + scales, fed to both sides."""
    out = [j_quantize(jnp.asarray(v)) for v in case["vectors"]]
    return [np.asarray(q) for q, _ in out], [np.asarray(s) for _, s in out]


@pytest.mark.parametrize("seed,n,dims,m,b,s,c,k,metric", CORPUS)
def test_fp32_corpus_matches_jax(seed, n, dims, m, b, s, c, k, metric):
    case = make_case(seed, n, dims, m, b, s, c)
    port = run_torch(case, k=k, metric=metric)
    assert_same(port, run_jax(case, k=k, metric=metric, use_kernel=False))
    if seed % 2 == 0:
        assert_same(port, run_jax(case, k=k, metric=metric, use_kernel=True))


@pytest.mark.parametrize("seed,n,dims,m,b,s,c,k,metric", CORPUS)
def test_int8_corpus_matches_jax(seed, n, dims, m, b, s, c, k, metric):
    """Kernel 2: the int8 stage (scaled scores, exact fp32 predicates) and
    the full two-stage ``gather_score_topk_int8`` with its fp32 rerank."""
    case = make_case(seed, n, dims, m, b, s, c)
    q8, sc = int8_replica(case)
    kq = max(k, min(4 * k, 128))
    port = run_torch(case, k=kq, metric=metric, vectors=q8, scales=sc)
    assert_same(port, run_jax(case, k=kq, metric=metric, use_kernel=False,
                              vectors=q8, scales=sc))
    if seed % 2 == 1:
        assert_same(port, run_jax(case, k=kq, metric=metric, use_kernel=True,
                                  vectors=q8, scales=sc))
    two = tgs.gather_score_topk_int8(
        torch.as_tensor(case["cand"]),
        tuple(torch.as_tensor(v) for v in case["vectors"]),
        tuple(torch.as_tensor(v) for v in q8),
        tuple(torch.as_tensor(s) for s in sc),
        tuple(torch.as_tensor(q) for q in case["qs"]),
        torch.as_tensor(case["w"]), torch.as_tensor(case["scalars"]),
        torch_pred(case), k=k, metric=metric)
    want = jgs.gather_score_topk_int8(
        jnp.asarray(case["cand"]), tuple(map(jnp.asarray, case["vectors"])),
        tuple(map(jnp.asarray, q8)), tuple(map(jnp.asarray, sc)),
        tuple(map(jnp.asarray, case["qs"])), jnp.asarray(case["w"]),
        jnp.asarray(case["scalars"]), jax_pred(case), k=k, metric=metric,
        use_kernel=False)
    assert_same(two, want)


def test_quantize_rows_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(300, 48)).astype(np.float32)
    v[7] = 0.0  # an all-zero row takes the 1e-12 scale floor
    q_j, s_j = j_quantize(jnp.asarray(v))
    q_t, s_t = t_quantize(torch.as_tensor(v))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-7)


def test_duplicates_all_filtered_and_pred_none_match_jax():
    """Duplicate-dominated candidates still surface k distinct rows; an
    all-filtered group returns -1 / NEG / 0; ``pred=None`` scores every
    valid slot — identically on both packages."""
    dup = make_case(31, 100, (8,), 1, 1, 60, 1, dup_frac=0.9, pad_frac=0.1)
    dup["cand"][0, :40] = dup["cand"][0, 0]
    dup["clauses"] = [[{}]]
    port = run_torch(dup, k=5, metric="dot")
    assert_same(port, run_jax(dup, k=5, metric="dot", use_kernel=True))
    got = port[0].numpy()[0]
    assert len(set(got[got >= 0].tolist())) == int((got >= 0).sum())

    none = make_case(21, 120, (16,), 2, 2, 64, 2, pad_frac=0.0)
    none["clauses"] = [[{0: (100.0, 200.0)}, {1: (-50.0, -40.0)}]] * 2
    ids, scores, n_qual = run_torch(none, k=5, metric="dot")
    assert (ids.numpy() == -1).all()
    assert (scores.numpy() <= tgs.NEG / 2).all()
    assert (n_qual.numpy() == 0).all()
    assert_same((ids, scores, n_qual),
                run_jax(none, k=5, metric="dot", use_kernel=True))

    free = make_case(41, 90, (8,), 2, 2, 48, 1, pad_frac=0.25)
    free["clauses"] = None
    port = run_torch(free, k=5, metric="l2")
    np.testing.assert_array_equal(port[2].numpy(),
                                  (free["cand"] >= 0).sum(axis=1))
    assert_same(port, run_jax(free, k=5, metric="l2", use_kernel=True))


def test_merge_topk_unique_underfill_and_ties():
    ids = torch.tensor([[7, 3, 7, -1, 3, 9]], dtype=torch.int32)
    scores = torch.tensor([[1.0, 2.0, 1.0, tgs.NEG, 2.0, 2.0]])
    out_ids, out_scores = tgs.merge_topk_unique(ids, scores, 5)
    np.testing.assert_array_equal(out_ids.numpy()[0], [3, 9, 7, -1, -1])
    assert out_scores.numpy()[0, 3] <= tgs.NEG / 2


# (seed, n, dims, m, b, s, c, k, metric, kind): the shapes the int8
# kernel branches on — 16-byte loads at d=16 and 48 (under one step of
# three loads a lane), byte loads at the unaligned d=770, one group of 32
# lanes per slot at M=16 with its scale, four clauses, a predicate every
# slot fails, no predicate, one row in most slots of a block, the
# denormal strict bounds that ~(col == 0) compiles to, on zeros, and
# queries past 32 KB of shared memory (the int8 launch raises its limit)
BRANCH_CASES = [
    (50, 400, (16,), 16, 3, 300, 4, 10, "dot", "dnf"),
    (51, 400, (48,), 16, 2, 300, 4, 32, "l2", "dnf"),
    (52, 400, (770,), 4, 2, 300, 2, 16, "dot", "dnf"),
    (53, 400, (770, 48), 16, 2, 300, 4, 128, "l2", "dnf"),
    (54, 400, (16, 768, 48, 770), 16, 2, 256, 4, 64, "l2", "dnf"),
    (55, 400, (768,), 16, 2, 500, 4, 32, "dot", "all_fail"),
    (56, 400, (768,), 4, 2, 500, 1, 32, "l2", "no_pred"),
    (57, 400, (768,), 4, 3, 500, 2, 32, "dot", "same_row"),
    (58, 400, (768,), 4, 2, 500, 2, 32, "dot", "not_zero"),
    (59, 300, (3072, 3072, 3072), 4, 2, 256, 1, 16, "dot", "dnf"),
]

# chip_smoke.py's selectivity shapes at k=32 on 768-d rows: ≈1%, ≈10% and
# 100% ranges on one column, ~(col == 0) on zeros, one conjunction over all
# M columns — the qualifying list from a few slots a block to all of them
SELECTIVITY_CASES = [
    (60, 5000, (768,), 4, 4, 2048, 1, 32, "dot", "range_1"),
    (61, 5000, (768,), 4, 4, 2048, 1, 32, "dot", "range_10"),
    (62, 5000, (768,), 4, 4, 2048, 1, 32, "dot", "range_100"),
    (63, 5000, (768,), 4, 4, 2048, 2, 32, "dot", "not_zero"),
    (64, 5000, (768,), 4, 4, 2048, 1, 32, "dot", "all_cols"),
]


def branch_case(seed, n, dims, m, b, s, c, kind):
    case = make_case(seed, n, dims, m, b, s, c)
    if kind == "all_fail":
        case["clauses"] = [[{0: (100.0, 200.0)}] * c] * b
    elif kind == "no_pred":
        case["clauses"] = None
    elif kind == "same_row":
        first = case["cand"][0][case["cand"][0] >= 0][0]
        case["cand"][:, 3:200] = first
    elif kind == "not_zero":
        case["scalars"][::3, 0] = 0.0
        tiny = float(np.nextafter(np.float32(0), np.float32(1)))
        case["clauses"] = [[{0: (-np.inf, -tiny)}, {0: (tiny, np.inf)}]] * b
    elif kind.startswith("range_"):  # scalars are uniform on [0, 10)
        half = 5.0 * int(kind[6:]) / 100
        case["clauses"] = [[{0: (5.0 - half, 5.0 + half)}
                            if half < 5.0 else {}]] * b
    elif kind == "all_cols":
        case["clauses"] = [[{col: (0.2, 9.8) for col in range(m)}]] * b
    return case


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_kernel_matches_plain_version(cuda_device, int8):
    """The CUDA kernel (both element types) against the port's plain
    version on the same card tensors, over the corpus, main-path widths
    (768-d columns, k up to 128), the kernels' branch shapes and
    ``chip_smoke.py``'s selectivity shapes."""
    cases = [(*x, "dnf") for x in CORPUS] + [
        (8, 5000, (768,), 4, 8, 1000, 2, 32, "dot", "dnf"),
        (9, 5000, (768, 768), 4, 4, 700, 4, 128, "l2", "dnf")] + \
        BRANCH_CASES + SELECTIVITY_CASES
    for seed, n, dims, m, b, s, c, k, metric, kind in cases:
        case = branch_case(seed, n, dims, m, b, s, c, kind)
        vecs, scales = (int8_replica(case) if int8 else (None, None))
        kern = run_torch(case, k=k, metric=metric, vectors=vecs,
                         scales=scales, device=cuda_device)
        lo, hi, act, cv = tgs._pred_fields(torch_pred(case, cuda_device), b,
                                           m, cuda_device)
        from repro_torch.kernels.ref import gather_score_ref

        vv = case["vectors"] if vecs is None else vecs
        plain = gather_score_ref(
            torch.as_tensor(case["cand"], device=cuda_device),
            tuple(torch.as_tensor(v, device=cuda_device) for v in vv),
            tuple(torch.as_tensor(q, device=cuda_device) for q in case["qs"]),
            torch.as_tensor(case["w"], device=cuda_device),
            torch.as_tensor(case["scalars"], device=cuda_device),
            lo, hi, act, cv, k=k, metric=metric,
            apply_pred=case["clauses"] is not None,
            scales=None if scales is None else tuple(
                torch.as_tensor(x, device=cuda_device) for x in scales))
        torch.cuda.synchronize()
        ids_k, s_k, q_k = (x.cpu().numpy() for x in kern)
        ids_p, s_p, q_p = (x.cpu().numpy() for x in plain)
        np.testing.assert_array_equal(q_k, q_p)
        np.testing.assert_allclose(s_k, s_p, atol=ATOL, rtol=RTOL)
        # the kernel and cuBLAS sum in other orders: rows whose scores tie
        # within the tolerance may swap places, no others
        swapped = ids_k != ids_p
        assert (np.abs(s_k - s_p)[swapped]
                <= ATOL + RTOL * np.abs(s_p[swapped])).all()
