"""The CUDA scan source, run on the CPU under emulation.

``csrc/masked_topk.cu`` is built with the host C++ compiler against the
emulation header of ``tests/test_torch_gather_emulated.py`` (a thread per
CUDA thread, the CTAs one after another, barriers for ``__syncthreads`` and
the warp collectives), and each of its three kernels (fp32 dot, fp32 l2,
int8 dot) is launched through the C entry point on CPU tensors. The block
outputs must equal the plain version's block by block — each tile's top-k
by (score desc, id asc), (NEG, -1) past the qualifying count — and, merged
by ``ops._merge``, ``ref.masked_topk_ref`` / ``ref.int8_topk_ref``. The
data sit on the binary grid of ``tests/test_torch_scan.py`` (multiples of
1/8, power-of-two scales), so every score is exact whatever the summation
order and ids must match exactly, ties included. The shapes are the ones
the kernel branches on: qualifying lists of no multiple of the rows a pass
scores, one qualifying row a tile, k above the qualifying count and above
``block_rows``, lists ranked by counting and lists sorted (≈700 and 1024
entries, no active column), all 16 columns active, the unaligned widths
d=12 and d=770, and tiles cut by ``n_rows``.
This checks indexing and control flow, not timing; the ``cuda`` tests and
``chip_smoke.py`` hold the real build on the card.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

from test_torch_gather_emulated import build_emulated  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.shapes import NEG  # noqa: E402
from repro_torch.vectordb.flat import topk_stable  # noqa: E402


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated build of ``csrc/masked_topk.cu`` with its C entry point
    declared as ``masked_topk._library`` declares it."""
    dll = build_emulated(tmp_path_factory.mktemp("scan_emulated"),
                         "masked_topk", 3)  # int8, fp32 l2, fp32 dot
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.masked_topk_launch.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i,
                                       i, i, p, p, p]
    dll.masked_topk_launch.restype = i
    return dll


# (name, n, n_rows, d, m, block_rows, k, kind). "rows": the qualifying rows
# are listed; "range": column 0 in [lo, hi] on uniform scalars (≈ the
# share given); "none": no active column; "all16": all 16 columns active
CASES = [
    # 37 and 41 qualifying rows in the two tiles (no multiple of any pass),
    # the second tile 476 rows long
    ("ragged-768", 1500, 1500, 768, 4, 1024, 10, ("rows", 37, 41)),
    # one qualifying row a tile, k above it
    ("one_live-768", 2048, 2048, 768, 4, 1024, 10, ("rows", 1, 1)),
    # k above block_rows: every tile emits 96 padded slots at least
    ("k_over_block-32", 300, 300, 32, 3, 32, 128, ("range", 0.4)),
    # every row qualifies: a 1024-entry sort (its strides past a warp go
    # through shared memory) and a 476-entry one
    ("none_active-48", 1500, 1500, 48, 3, 1024, 128, ("none",)),
    # ≈70%: a list longer than one entry a thread but short of 1024
    ("wide-64", 1100, 1100, 64, 4, 1024, 16, ("range", 0.7)),
    ("all16-64", 600, 600, 64, 16, 256, 10, ("all16",)),
    ("unaligned-12", 300, 300, 12, 3, 64, 10, ("range", 0.4)),
    ("unaligned-770", 300, 300, 770, 4, 128, 20, ("range", 0.4)),
    # tile 3 cut at row 1000 by n_rows, tile 4 wholly past it; the rows past
    # n_rows hold the best dot scores, so a kernel that admits them fails
    ("n_rows_cut-64", 1030, 1000, 64, 4, 256, 16, ("range", 0.5)),
    ("all_fail-16", 600, 600, 16, 3, 128, 10, ("range", 0.0)),
    # the main path's width at ≈1%, fewer qualifying rows than k
    ("narrow-768", 2048, 2048, 768, 4, 1024, 128, ("range", 0.01)),
]


def _case(seed, n, n_rows, d, m, kind):
    """numpy (q, fp32 rows, int8 rows, int8 scales, scalars, lo, hi, act)
    on the binary grid."""
    rng = np.random.default_rng(seed)
    vecs = (rng.integers(-16, 17, (n, d)) / 8).astype(np.float32)
    v8 = rng.integers(-127, 128, (n, d)).astype(np.int8)
    sc = (2.0 ** -rng.integers(4, 8, n)).astype(np.float32)
    dup = rng.integers(0, n, (2, n // 5 + 1))  # exact ties between rows
    vecs[dup[1]], v8[dup[1]], sc[dup[1]] = vecs[dup[0]], v8[dup[0]], sc[dup[0]]
    q = (rng.integers(-16, 17, d) / 8).astype(np.float32)
    if n_rows < n:  # past n_rows: the best dot scores, if admitted
        vecs[n_rows:] = 2 * np.sign(q) + (q == 0)
        v8[n_rows:] = 127 * np.sign(q) + (q == 0)
        sc[n_rows:] = 1.0
    scal = rng.uniform(0, 10, (n, m)).astype(np.float32)
    lo = np.full(m, -np.inf, np.float32)
    hi = np.full(m, np.inf, np.float32)
    act = np.zeros(m, np.float32)
    if kind[0] == "rows":
        scal[:, 0] = 20.0
        for tile, count in enumerate(kind[1:]):
            rows = tile * 1024 + rng.choice(min(1024, n - tile * 1024),
                                            count, replace=False)
            scal[rows, 0] = 5.0
        lo[0], hi[0], act[0] = 4.0, 6.0, 1.0
    elif kind[0] == "range":
        lo[0], hi[0], act[0] = 5.0, 5.0 + 10.0 * kind[1], 1.0
    elif kind[0] == "all16":  # each column passes 94%: ≈ 37% pass all 16
        lo[:], hi[:], act[:] = 0.3, 9.7, 1.0
    return q, vecs, v8, sc, scal, lo, hi, act


def _block_ref(scores, n, block_rows, k):
    """Each tile's top-k of the plain per-row scores (NEG where a row fails)
    by (score desc, id asc), (NEG, -1) where no row is left."""
    nb = -(-n // block_rows)
    tiles = torch.full((nb * block_rows,), NEG)
    tiles[:n] = scores
    tiles = torch.cat([tiles.reshape(nb, block_rows), torch.full(
        (nb, max(k - block_rows, 0)), NEG)], dim=1)
    top, pos = topk_stable(tiles, k)
    ids = pos + torch.arange(nb)[:, None] * block_rows
    live = top > NEG / 2
    return (torch.where(live, top, torch.full_like(top, NEG)),
            torch.where(live, ids, torch.full_like(ids, -1)).to(torch.int32))


@pytest.mark.parametrize("variant", ["dot", "l2", "int8"])
@pytest.mark.parametrize("name,n,n_rows,d,m,block_rows,k,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_emulated_scan_matches_plain_version(emulated, variant, name, n,
                                             n_rows, d, m, block_rows, k,
                                             kind):
    q, vecs, v8, sc, scal, lo, hi, act = (torch.as_tensor(a) for a in _case(
        n + d + k, n, n_rows, d, m, kind))
    int8 = variant == "int8"
    rows = v8 if int8 else vecs
    nb = -(-n // block_rows)
    out_s = torch.empty((nb, k))
    out_i = torch.empty((nb, k), dtype=torch.int32)
    rc = emulated.masked_topk_launch(
        int(int8), int(variant == "l2"), q.data_ptr(), rows.data_ptr(),
        sc.data_ptr() if int8 else None, scal.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), act.data_ptr(), n_rows, nb, d, m, block_rows, k,
        out_s.data_ptr(), out_i.data_ptr(), None)
    assert rc == 0
    deq = v8.to(torch.float32) * sc[:, None] if int8 else vecs
    metric = "l2" if variant == "l2" else "dot"
    scores = ref.scan_scores_ref(q, deq, scal, lo, hi, act, n_rows,
                                 metric=metric)
    want_s, want_i = _block_ref(scores, n, block_rows, k)
    assert torch.equal(out_i, want_i)
    torch.testing.assert_close(out_s, want_s, atol=1e-4, rtol=0)
    got = ops._merge(out_s, out_i, k)
    if int8:
        plain = ref.int8_topk_ref(q, v8, sc, scal, lo, hi, act, n_rows, k=k)
    else:
        plain = ref.masked_topk_ref(q, vecs, scal, lo, hi, act, n_rows, k=k,
                                    metric=metric)
    assert torch.equal(got[1], plain[1])
    torch.testing.assert_close(got[0], plain[0], atol=1e-4, rtol=0)
    n_qual = int((scores > NEG / 2).sum())
    if kind[0] == "rows":
        assert n_qual == sum(kind[1:])
    elif kind[0] in ("none", "all16"):
        assert 0 < n_qual <= n_rows
    elif kind[1] == 0.0:
        assert n_qual == 0
