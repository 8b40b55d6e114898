"""The CUDA gather-score source, run on the CPU under emulation.

A CUDA kernel has no interpret mode, so ``csrc/gather_score.cu`` is built
here with the host C++ compiler against a small header that emulates what
the source uses: one OS thread per CUDA thread, the CTAs of a grid one
after another, ``__syncthreads`` and the warp collectives (``__ballot_sync``,
``__shfl_xor_sync``) as barriers, and the byte and integer intrinsics
(``__byte_perm``, ``__dp4a``) by their definitions. The launch syntax is
rewritten to a call. Both kernels (each with its predicate-first read and
qualifying-row list; fp32 rows scored by warps, int8 rows by 16-lane
groups) are then held to the port's plain version on the shapes they
branch on: qualifying
counts equal, scores to atol=1e-3, rtol=1e-4, ids equal except between
tied scores, and no block emitting a row twice. This checks the kernels'
indexing and control flow, not timing or the memory model; the ``cuda``
tests and ``chip_smoke.py`` hold the real build on the card.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

from repro_torch.kernels import gather_score as gs  # noqa: E402
from repro_torch.kernels.int8_scan import quantize_rows  # noqa: E402
from repro_torch.kernels.ref import gather_score_ref  # noqa: E402
from repro_torch.vectordb import predicates as tp  # noqa: E402
from repro_torch.vectordb.algebra import col  # noqa: E402

CSRC = pathlib.Path(gs.__file__).resolve().parents[1] / "csrc"
ATOL, RTOL = 1e-3, 1e-4

EMULATION_HEADER = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
#define __restrict__
using std::max;
using std::min;
struct int4 { int x, y, z, w; };
struct float4 { float x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline thread_local uint3 threadIdx;
inline uint3 blockIdx, gridDim;
inline float* emu_dynamic_smem = nullptr;
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline uint64_t emu_exchange[1024];
template <typename T> T __ldg(const T* p) { return *p; }
inline float __int_as_float(unsigned v) { float f; std::memcpy(&f, &v, 4); return f; }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  uint8_t in[8];
  std::memcpy(in, &x, 4);
  std::memcpy(in + 4, &y, 4);
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) r |= unsigned(in[(s >> (4 * n)) & 7]) << (8 * n);
  return r;
}
inline int __dp4a(int a, int b, int c) {
  for (int n = 0; n < 4; ++n)
    c += int(int8_t(a >> (8 * n))) * int(int8_t(b >> (8 * n)));
  return c;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fsub_rn(float a, float b) { return a - b; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline std::barrier<>& emu_warp() { return *emu_warp_barriers[threadIdx.x >> 5]; }
template <typename T> T __shfl_xor_sync(unsigned, T x, int off) {
  uint64_t v = 0;
  std::memcpy(&v, &x, sizeof(T));
  emu_exchange[threadIdx.x] = v;
  emu_warp().arrive_and_wait();
  const uint64_t o = emu_exchange[threadIdx.x ^ off];
  emu_warp().arrive_and_wait();
  T r;
  std::memcpy(&r, &o, sizeof(T));
  return r;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  emu_exchange[threadIdx.x] = p;
  emu_warp().arrive_and_wait();
  unsigned r = 0;
  const unsigned base = threadIdx.x & ~31u;
  for (int l = 0; l < 32; ++l) r |= unsigned(emu_exchange[base + l] != 0) << l;
  emu_warp().arrive_and_wait();
  return r;
}
template <typename K>
auto emu_launch(K kernel, dim3 grid, int threads, size_t smem) {
  return [=](auto... args) {
    std::vector<float> dynamic(smem / 4 + 4);
    gridDim = {grid.x, grid.y, grid.z};
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = {bx, by, 0};
        std::fill(dynamic.begin(), dynamic.end(), NAN);
        emu_dynamic_smem = dynamic.data();
        std::barrier<> block(threads);
        emu_block_barrier = &block;
        emu_warp_barriers.clear();
        for (int w = 0; w < threads / 32; ++w)
          emu_warp_barriers.emplace_back(new std::barrier<>(32));
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([=] {
            threadIdx = {unsigned(t), 0, 0};
            kernel(args...);
          });
        for (auto& t : pool) t.join();
      }
  };
}
"""


def _emulated_source(src: str) -> str:
    """The CUDA source with its dynamic shared array bound to the
    emulator's buffer and each ``k<<<grid, threads, smem, stream>>>(`` a
    call of ``emu_launch``."""
    src = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                 r"float* \1 = emu_dynamic_smem;", src)
    return re.sub(r"(\S[^\n]*?)<<<([^,]+), ([^,]+), ([^,]+), [^>]+>>>\(",
                  r"emu_launch(\1, \2, \3, \4)(", src)


def build_emulated(out: pathlib.Path, name: str, launches: int):
    """``csrc/<name>.cu`` built with the host ``g++`` against the emulation
    header (and the shared ``csrc/*.cuh``) into ``out``; the source must
    hold ``launches`` kernel launches. -> the loaded library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    (out / "cuda_runtime.h").write_text(EMULATION_HEADER)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    src = _emulated_source((CSRC / f"{name}.cu").read_text())
    assert src.count("emu_launch(") == launches
    (out / f"{name}.cpp").write_text(src)
    lib = out / f"lib{name}.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-Wno-unknown-pragmas", "-I", str(out),
                    "-o", str(lib), str(out / f"{name}.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated build of ``csrc/gather_score.cu`` with its C entry
    point declared as ``gather_score._library`` declares it."""
    dll = build_emulated(tmp_path_factory.mktemp("gather_emulated"),
                         "gather_score", 2)  # the fp32 and the int8 launch
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.gather_score_launch.argtypes = [
        i, i, p, i, i, i, i, p, p, p, p, p, p, i, p, p, p, p, i, i, i, i,
        p, p, p, p]
    dll.gather_score_launch.restype = i
    return dll


def _launch(lib, cand, vectors, qs, w, scalars, pred, k, metric, scales):
    """``gather_score_topk``'s CUDA path with CPU tensors: pad to whole
    blocks, launch, check no block emits a row twice, merge."""
    b, s_tot = cand.shape
    m = scalars.shape[1]
    lo, hi, act, cv = (x.contiguous() for x in gs._pred_fields(
        pred, b, m, "cpu"))
    bs = min(gs.GATHER_BLOCK_S, gs._next_pow2(max(s_tot, k, 8)))
    cand = torch.cat([cand, torch.full((b, (-s_tot) % bs), -1,
                                       dtype=torch.int32)], 1).contiguous()
    nb = cand.shape[1] // bs
    n_vec = len(vectors)
    out_s = torch.empty((b, nb, k))
    out_i = torch.empty((b, nb, k), dtype=torch.int32)
    out_q = torch.empty((b, nb), dtype=torch.int32)
    ptrs = ctypes.c_void_p * n_vec
    rc = lib.gather_score_launch(
        int(scales is not None), int(metric == "l2"), cand.data_ptr(), b,
        cand.shape[1], scalars.shape[0], n_vec,
        ptrs(*[v.data_ptr() for v in vectors]),
        ptrs(*([s.data_ptr() for s in scales] if scales is not None
               else [None] * n_vec)),
        ptrs(*[q.data_ptr() for q in qs]),
        (ctypes.c_int * n_vec)(*[v.shape[1] for v in vectors]),
        w.data_ptr(), scalars.data_ptr(), m, lo.data_ptr(), hi.data_ptr(),
        act.data_ptr(), cv.data_ptr(), lo.shape[1], int(pred is not None),
        bs, k, out_s.data_ptr(), out_i.data_ptr(), out_q.data_ptr(), None)
    assert rc == 0
    for ids in out_i.reshape(b * nb, k):
        live = ids[ids >= 0]
        assert torch.unique(live).numel() == live.numel(), "row twice"
    ids, scores = gs.merge_topk_unique(out_i.reshape(b, -1),
                                       out_s.reshape(b, -1), k)
    return ids, scores, out_q.sum(1)


# (seed, n, dims, m, b, s, c, k, metric, kind): 16-byte loads at d=16, 48
# and 768, byte loads at the unaligned d=770, M=16 (one 32-lane group a
# slot with its scale), four clauses, four columns, a query past 32 KB of
# shared memory, a predicate every slot fails, no predicate, the
# ±1.4e-45 bounds of ~(col == 0), and one row in most slots of a block;
# then 16-byte loads on fewer lanes than a group (d=4, 12), qualifying
# lists of 37 and 41 slots (no multiple of the rows a pass scores) and of
# one slot, each under k, M=16 under four clauses at d=768 ("fields16"),
# and a graph walk's pool (S=530: three blocks, the last part padding,
# k=128); both of these draw a random DNF, as "dnf" does
CASES = [
    (0, 200, (16,), 2, 3, 64, 1, 5, "dot", "dnf"),
    (1, 200, (16, 8), 3, 2, 33, 1, 5, "l2", "dnf"),
    (2, 300, (48,), 16, 2, 300, 4, 20, "l2", "dnf"),
    (3, 400, (768,), 4, 2, 300, 2, 128, "l2", "dnf"),
    (4, 300, (770, 48), 16, 2, 200, 4, 16, "l2", "dnf"),
    (5, 300, (16, 768, 48, 770), 16, 1, 256, 4, 64, "dot", "dnf"),
    (6, 100, (3072, 3072, 3072), 4, 1, 64, 1, 8, "dot", "dnf"),
    (7, 300, (768,), 16, 2, 300, 4, 32, "dot", "all_fail"),
    (8, 300, (768,), 4, 2, 300, 1, 32, "l2", "no_pred"),
    (9, 300, (768,), 4, 2, 300, 2, 32, "dot", "not_zero"),
    (10, 300, (768,), 4, 2, 400, 2, 32, "dot", "same_row"),
    (11, 200, (4,), 4, 2, 300, 2, 16, "dot", "dnf"),
    (12, 200, (12, 4), 3, 2, 300, 1, 16, "l2", "dnf"),
    (13, 300, (768,), 4, 2, 300, 2, 64, "l2", "ragged"),
    (14, 300, (768, 12), 4, 2, 300, 1, 10, "dot", "one_live"),
    (15, 300, (768,), 16, 2, 300, 4, 10, "l2", "fields16"),
    (16, 400, (768,), 4, 2, 530, 2, 128, "dot", "pool"),
]


def _case(seed, n, dims, m, b, s, c, kind):
    rng = np.random.default_rng(seed)
    vectors = [torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))
               for d in dims]
    scal = rng.uniform(0, 10, (n, m)).astype(np.float32)
    scal[::3, 0] = 0.0
    qs = tuple(torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32))
               for d in dims)
    w = torch.as_tensor(rng.uniform(0.1, 1.0, (b, len(dims)))
                        .astype(np.float32))
    cand = rng.integers(0, n, (b, s))
    for row in cand:  # duplicates within a query
        row[rng.integers(0, s, s // 3)] = row[rng.integers(0, s, s // 3)]
    cand[rng.random((b, s)) < 0.2] = -1
    if kind == "same_row":
        cand[:, 3:200] = cand[0][cand[0] >= 0][0]
    elif kind == "ragged":  # 37 live slots in the first block, 41 in the next
        cand[:, :37] = rng.integers(0, n, (b, 37))
        cand[:, 37:256] = -1
        cand[:, 256:297] = rng.integers(0, n, (b, 41))
        cand[:, 297:] = -1
    elif kind == "one_live":
        cand[:] = -1
        cand[:, 5] = rng.integers(0, n, b)
    if kind == "no_pred":
        pred = None
    elif kind in ("ragged", "one_live"):  # every row passes
        pred = tp.PredicateSet.from_clauses(m, [{0: (-1.0, 11.0)}] * c,
                                            n_clauses=c, device="cpu")
    elif kind == "all_fail":
        pred = tp.PredicateSet.from_clauses(m, [{0: (100.0, 200.0)}] * c,
                                            n_clauses=c, device="cpu")
    elif kind == "not_zero":
        pred = (col(0) != 0.0).compile(m=m, device="cpu")
    else:
        pred = tp.PredicateSet.from_clauses(m, [
            {int(rng.integers(0, m)): (lo, lo + 5.0)}
            for lo in rng.uniform(0, 5, c)], n_clauses=c, device="cpu")
    if pred is not None:
        pred = tp.stack([pred] * b)
    return (torch.as_tensor(cand.astype(np.int32)), vectors, qs, w,
            torch.as_tensor(scal), pred)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("seed,n,dims,m,b,s,c,k,metric,kind", CASES,
                         ids=[f"{x[-1]}-{'x'.join(map(str, x[2]))}"
                              for x in CASES])
def test_emulated_kernel_matches_plain_version(emulated, int8, seed, n, dims,
                                               m, b, s, c, k, metric, kind):
    cand, vectors, qs, w, scal, pred = _case(seed, n, dims, m, b, s, c, kind)
    scales = None
    if int8:
        pairs = [quantize_rows(v) for v in vectors]
        vectors, scales = [q for q, _ in pairs], tuple(x for _, x in pairs)
    got = _launch(emulated, cand, tuple(vectors), qs, w, scal, pred, k,
                  metric, scales)
    lo, hi, act, cv = gs._pred_fields(pred, b, m, "cpu")
    want = gather_score_ref(cand, tuple(vectors), qs, w, scal, lo, hi, act,
                            cv, k=k, metric=metric,
                            apply_pred=pred is not None, scales=scales)
    assert torch.equal(got[2].long(), want[2].long())
    if kind == "all_fail":
        assert int(want[2].sum()) == 0
    elif kind == "ragged":
        assert want[2].tolist() == [78] * b
    elif kind == "one_live":
        assert want[2].tolist() == [1] * b
    elif kind == "not_zero":  # the rows holding 0 are excluded
        assert int(want[2].sum()) < int((cand >= 0).sum())
    torch.testing.assert_close(got[1], want[1], atol=ATOL, rtol=RTOL)
    swapped = got[0] != want[0]
    assert bool(((got[1] - want[1]).abs()[swapped]
                 <= ATOL + RTOL * want[1].abs()[swapped]).all())
