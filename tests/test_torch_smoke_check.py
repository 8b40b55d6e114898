"""The id check ``chip_smoke.py`` holds every kernel to, on CPU tensors.

``_held_to_plain`` lets a kernel's ids differ from the plain version's only
where the plain version itself ties; ``_refuses_planted_ids`` swaps two
untied ids of a result and requires the check to refuse it. The plain
result here is ``ref.masked_topk_ref`` over a small table whose rows 0 and
1 are equal, so their scores are a real tie.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
