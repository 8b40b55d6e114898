"""Full-table scan parity between the JAX package and the PyTorch port.

The same numpy inputs go through the JAX entry points ``ops.masked_topk``
and ``ops.int8_masked_topk`` (their Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them) and the port's, which on CPU tensors
run their plain versions (``repro_torch.kernels.ref``). Ids and ``valid``
must be equal and scores agree to ``atol=1e-4``.

The corpus spans n ∈ {10, 600, 1030}, block_rows ∈ {32, 128, 1024}, k ∈
{1, 10, 128} (k ≤ n), dot and l2, selectivity from all-filtered to none
(no column active). Vectors, queries and int8 scales sit on a binary grid
(multiples of 1/8, scales powers of two), so every score is exact in
float32 whatever the summation order: equal scores are real ties, which
the duplicated rows and the coarse grid make common, and the tie rule
(smaller row id first) decides between them on both sides. ``cuda`` cases
hold each CUDA kernel to its plain version on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import masked_topk as tmt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.int8_scan import quantize_rows as t_quantize  # noqa: E402

ATOL = 1e-4
M = 3

# (n, d, block_rows, k, metric, selectivity, duplicated rows)
FP32 = [
    (10, 32, 32, 1, "dot", "none", False),
    (10, 24, 128, 10, "l2", "mid", True),
    (600, 32, 32, 10, "dot", "mid", True),
    (600, 32, 128, 128, "l2", "none", True),
    (600, 16, 1024, 1, "dot", "all", False),
    (1030, 32, 1024, 128, "dot", "mid", True),
    (1030, 24, 128, 10, "l2", "narrow", False),
    (1030, 32, 32, 128, "dot", "narrow", True),
]
# (n, d, block_rows, k, selectivity, duplicated rows)
INT8 = [
    (10, 32, 32, 10, "none", False),
    (600, 48, 128, 128, "mid", True),
    (1030, 32, 1024, 10, "narrow", True),
    (1030, 24, 32, 1, "all", False),
]


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip when this machine has none — decided when
    the test runs, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_case(n, d, sel, dup, seed):
    """numpy (q, vectors, scalars, lo, hi, active) on the binary grid."""
    rng = np.random.default_rng(seed)
    vecs = (rng.integers(-16, 17, (n, d)) / 8).astype(np.float32)
    if dup:  # a fifth of the rows copy another row: exact score ties
        src = rng.integers(0, n, n // 5 + 1)
        dst = rng.integers(0, n, n // 5 + 1)
        vecs[dst] = vecs[src]
    q = (rng.integers(-16, 17, d) / 8).astype(np.float32)
    scal = rng.uniform(0, 10, (n, M)).astype(np.float32)
    lo = np.full(M, -np.inf, np.float32)
    hi = np.full(M, np.inf, np.float32)
    act = np.zeros(M, bool)
    if sel == "mid":  # ≈ 40%
        lo[:2], hi[:2], act[:2] = (2.0, 0.0), (7.0, 8.0), True
    elif sel == "narrow":  # ≈ 1%: fewer qualifying rows than k at k=128
        lo[0], hi[0], act[0] = 5.0, 5.1, True
    elif sel == "all":  # nothing qualifies
        lo[2], hi[2], act[2] = 100.0, 200.0, True
    elif sel == "all_cols":  # every column active, ≈ 12.5% in all
        lo[:], hi[:], act[:] = 2.5, 7.5, True
    return q, vecs, scal, lo, hi, act


def int8_rows(n, d, seed):
    """int8 rows and power-of-two per-row scales (exact dequantization)."""
    rng = np.random.default_rng(seed + 1)
    v = rng.integers(-127, 128, (n, d)).astype(np.int8)
    sc = (2.0 ** -rng.integers(4, 8, n)).astype(np.float32)
    return v, sc


def _assert_same(got, want):
    s_t, i_t, v_t = (x.numpy() for x in got)
    s_j, i_j, v_j = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_allclose(s_t, s_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", FP32, ids=lambda c: "-".join(map(str, c)))
def test_masked_topk_matches_jax(case):
    n, d, block, k, metric, sel, dup = case
    arrs = make_case(n, d, sel, dup, seed=n + k)
    want = jops.masked_topk(*(jnp.asarray(a) for a in arrs), k=k,
                            block_rows=block, metric=metric)
    tmt.reset_launches()
    got = tops.masked_topk(*(torch.as_tensor(a) for a in arrs), k=k,
                           block_rows=block, metric=metric)
    assert tmt.LAUNCHES == {"fp32": 0, "int8": 0}  # CPU: the plain version
    _assert_same(got, want)
    if sel == "all":
        assert not got[2].any()


@pytest.mark.parametrize("case", INT8, ids=lambda c: "-".join(map(str, c)))
def test_int8_masked_topk_matches_jax(case):
    n, d, block, k, sel, dup = case
    q, _, scal, lo, hi, act = make_case(n, d, sel, dup, seed=n + k)
    v8, sc = int8_rows(n, d, seed=n + k)
    if dup:
        v8[n // 2:n // 2 + n // 5] = v8[:n // 5]
        sc[n // 2:n // 2 + n // 5] = sc[:n // 5]
    arrs = (q, v8, sc, scal, lo, hi, act)
    want = jops.int8_masked_topk(*(jnp.asarray(a) for a in arrs), k=k,
                                 block_rows=block)
    got = tops.int8_masked_topk(*(torch.as_tensor(a) for a in arrs), k=k,
                                block_rows=block)
    _assert_same(got, want)


def test_quantize_rows_matches_jax():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(300, 40)).astype(np.float32)
    v[7] = 0.0  # an all-zero row takes the 1e-12 floor
    qj, sj = jops.quantize_rows(jnp.asarray(v))
    qt, st = t_quantize(torch.as_tensor(v))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_merge_matches_jax():
    """Block pools with NEG/-1 padding and scores tied across blocks."""
    rng = np.random.default_rng(9)
    nb, k = 6, 8
    s = rng.integers(0, 5, (nb, k)).astype(np.float32)
    s = -np.sort(-s, axis=1)
    i = np.arange(nb * k, dtype=np.int32).reshape(nb, k)
    s[:, 5:] = jops.NEG  # underfilled blocks
    i[:, 5:] = -1
    want = jops._merge(jnp.asarray(s), jnp.asarray(i), 12)
    got = tops._merge(torch.as_tensor(s), torch.as_tensor(i), 12)
    _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_scan_matches_plain_version(cuda_device, int8):
    """The CUDA kernel (both element types) through the entry points
    against the plain version on the same card tensors, over the corpus
    plus main-path widths (768-d rows, 1024-row blocks): ≈40%, ≈1% at
    k=10 and at k=128 (fewer qualifying rows than k), and every column
    active."""
    cases = list(FP32) + [(5000, 768, 1024, 128, "dot", "mid", True),
                          (5000, 768, 1024, 10, "l2", "narrow", False),
                          (5000, 768, 1024, 128, "dot", "narrow", False),
                          (5000, 768, 1024, 10, "l2", "all_cols", True)]
    for n, d, block, k, metric, sel, dup in cases:
        q, vecs, scal, lo, hi, act = (
            torch.as_tensor(a, device=cuda_device)
            for a in make_case(n, d, sel, dup, seed=n + k))
        tmt.reset_launches()
        if int8:  # the same shapes, dot only
            v8, sc = (torch.as_tensor(a, device=cuda_device)
                      for a in int8_rows(n, d, seed=n + k))
            got = tops.int8_masked_topk(q, v8, sc, scal, lo, hi, act, k=k,
                                        block_rows=block)
            plain = tref.int8_topk_ref(q, v8, sc, scal, lo, hi, act, n, k=k)
        else:
            got = tops.masked_topk(q, vecs, scal, lo, hi, act, k=k,
                                   block_rows=block, metric=metric)
            plain = tref.masked_topk_ref(q, vecs, scal, lo, hi, act, n, k=k,
                                         metric=metric)
        torch.cuda.synchronize()
        assert tmt.LAUNCHES["int8" if int8 else "fp32"] == 1
        s_k, i_k, v_k = (x.cpu().numpy() for x in got)
        s_p, i_p = (x.cpu().numpy() for x in plain)
        np.testing.assert_array_equal(v_k, i_p >= 0)
        np.testing.assert_allclose(s_k, s_p, atol=1e-3, rtol=1e-4)
        # grid data: scores are exact, so ids match exactly, ties included
        np.testing.assert_array_equal(i_k, i_p)
