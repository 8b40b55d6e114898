// Full-table filtered scan: conjunctive range mask, score the rows that
// pass, block top-k.
//
// Replaces two TPU Pallas kernels: `_kernel` of
// src/repro/kernels/masked_topk.py (launched by `masked_topk_blocks`, fp32
// rows, dot or l2) and `_kernel` of src/repro/kernels/int8_scan.py
// (launched by `int8_topk_blocks`, int8 rows with a per-row f32 dequant
// scale, dot only). One source, templated on the row element type.
//
// What it computes, per tile j of `block_rows` table rows:
//   * the conjunctive mask: AND over the M columns of
//     (lo <= x <= hi) || active < 0.5; a row at or past n_rows never
//     qualifies (the table is never padded: the kernel bounds-checks);
//   * the score of every qualifying row: q.v (int8: scale[gid] * q.v), and
//     for l2 2 q.v - |v|^2 — the query's constant -|q|^2 is dropped,
//     unlike the gather kernel;
//   * the tile's top-k (score, id) pairs, by score descending then id
//     ascending; slots past the qualifying count are (NEG, -1). The caller
//     merges the tiles (ops._merge in torch).
//
// Bound on the H100: HBM bytes, and only the bytes the answer needs. A row
// that fails scores NEG whatever its vector holds, so the least traffic is
// every row's 4M bytes of scalars when some column is active (none when no
// column is), plus the vectors (d*elem, +4 for the int8 scale) of the
// qualifying rows only, the query, and the tile outputs. One query against
// the table is a matvec: 2 flops an int8 byte, 0.5 an fp32 byte, far under
// the fp32 rate, and with one query there is no second operand to reuse,
// so tensor cores (wgmma, mma) do not move it. At n=200,000, d=768, M=4:
// ≈10% qualifying is 18.7 MB int8 / 64.7 MB fp32 (5.6 / 19.3 us at 3.35
// TB/s), 100% (no active column) 154.4 / 614.4 MB (46 / 183 us); at ≈1% the
// fixed part (launch, one CTA's chain of round trips) is what is left.
//
// The design, in the order a CTA runs it:
//   1. the query is staged once in shared memory (transposed for aligned
//      int8 rows, as the row loops of row_dot.cuh read it) with the
//      predicate fields;
//   2. the predicate first: the tile's scalars are block_rows * M
//      contiguous floats, read by all threads, next_pow2(M) lanes a row and
//      one field a lane (a warp reads 128 contiguous bytes at M=4), eight
//      passes' loads issued before any is used; only active columns are
//      loaded, and with no active column no scalar byte is read. One
//      __ballot_sync a pass decides each row, with no data-dependent exit;
//   3. the qualifying rows are compacted into a list in shared memory
//      (ballot + __popc prefix), so a failing row costs no vector byte, no
//      scale byte and no lane;
//   4. the list is scored with several rows in flight: int8 by 16-lane
//      groups, two rows a group, three 16-byte loads a lane a row, with the
//      byte-permute conversion; the scale of each listed row is loaded with
//      its vector; fp32 by whole warps, two rows a warp (twelve float4
//      loads a lane), l2's |v|^2 in the same pass; a byte or float a lane
//      where widths or addresses rule out 16-byte loads;
//   5. the selection scales with the qualifying count: a list of at most
//      one entry a thread is ranked by counting (each entry against every
//      other, in parallel, no barrier) and written straight to its slot; a
//      longer one is sorted by a bitonic network over next_pow2(count)
//      entries held in registers, two a thread, with warp shuffles for the
//      strides within a warp and shared memory only for longer ones.
// What is left between a shape and its bound (the phase stamps of
// scripts/scan_variants.py): at ≈1% the launch and each CTA's fixed chain
// (query and fields, one round trip for the tile's scalars, the list, one
// pass of rows, the selection); at ≈10% scoring streams at about the HBM
// rate and the fixed chain remains; at 100% the 1024-entry sort of every
// tile, and the 196-tile grid, which puts two tiles on 64 of the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / kGroupLanes;  // int8 row groups per CTA
constexpr int kRowsInFlight = 2;     // int8 rows a group loads at once
constexpr int kF32RowsInFlight = 2;  // fp32 rows a warp loads at once
constexpr int kFieldPasses = 8;      // rows a thread reads fields for at once
constexpr int kMaxRows = 1024;       // block_rows and k <= 1024
constexpr int kMaxScalars = 16;
constexpr int kMaxQueryFloats = 8 * 1024;  // 32 KB, under the default 48 KB
constexpr float kNeg = -1e30f;
constexpr int kIdSentinel = 1 << 30;

// Score list entries [0, n_live) of int8 rows: group g takes entries
// (p * kRowsInFlight + r) * kGroups + g; every thread runs every pass.
__device__ __forceinline__ void score_list(
    const int8_t* __restrict__ vec, const float* __restrict__ scale,
    const float* s_query, const int* s_id, float* s_score, int n_live, int d,
    bool vec_ok, int tid) {
  const int g = tid / kGroupLanes;
  const int l = tid % kGroupLanes;
  const int n_pass = (n_live + kGroups * kRowsInFlight - 1) /
                     (kGroups * kRowsInFlight);
  for (int p = 0; p < n_pass; ++p) {
    bool has[kRowsInFlight];
    const int8_t* row[kRowsInFlight];
    float dot[kRowsInFlight], sc[kRowsInFlight];
    int vv[kRowsInFlight];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const int idx = (p * kRowsInFlight + r) * kGroups + g;
      has[r] = idx < n_live;
      const int gid = has[r] ? s_id[idx] : 0;
      row[r] = vec + (size_t)gid * d;
      sc[r] = has[r] ? __ldg(scale + gid) : 0.f;
      dot[r] = 0.f;
      vv[r] = 0;
    }
    if (vec_ok) {
      row_dots_aligned<false, kRowsInFlight>(
          row, has, reinterpret_cast<const float4*>(s_query), d >> 4, l, dot,
          vv);
    } else {
      row_dots_bytes<false, kRowsInFlight>(row, has, s_query, d, l, dot, vv);
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const float dsum = group_sum(dot[r]);
      if (l == 0 && has[r])
        s_score[(p * kRowsInFlight + r) * kGroups + g] = dsum * sc[r];
    }
  }
}

// The same for fp32 rows: warp w takes entries
// (p * kF32RowsInFlight + r) * kWarps + w.
template <bool kL2>
__device__ __forceinline__ void score_list(
    const float* __restrict__ vec, const float* s_query, const int* s_id,
    float* s_score, int n_live, int d, bool vec_ok, int tid) {
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_pass = (n_live + kWarps * kF32RowsInFlight - 1) /
                     (kWarps * kF32RowsInFlight);
  for (int p = 0; p < n_pass; ++p) {
    bool has[kF32RowsInFlight];
    const float* row[kF32RowsInFlight];
    float dot[kF32RowsInFlight], vv[kF32RowsInFlight];
#pragma unroll
    for (int r = 0; r < kF32RowsInFlight; ++r) {
      const int idx = (p * kF32RowsInFlight + r) * kWarps + warp;
      has[r] = idx < n_live;
      row[r] = vec + (size_t)(has[r] ? s_id[idx] : 0) * d;
      dot[r] = 0.f;
      vv[r] = 0.f;
    }
    if (vec_ok) {
      f32_row_dots_aligned<kL2, kF32RowsInFlight>(
          row, has, reinterpret_cast<const float4*>(s_query), d >> 2, lane,
          dot, vv);
    } else {
      f32_row_dots_elems<kL2, kF32RowsInFlight>(row, has, s_query, d, lane,
                                                dot, vv);
    }
#pragma unroll
    for (int r = 0; r < kF32RowsInFlight; ++r) {
      const float dsum = warp_sum(dot[r]);
      const float vsum = kL2 ? warp_sum(vv[r]) : 0.f;
      if (lane == 0 && has[r]) {
        s_score[(p * kF32RowsInFlight + r) * kWarps + warp] =
            kL2 ? 2.f * dsum - vsum : dsum;
      }
    }
  }
}

// A bitonic sort of list entries [0, n_live), padded to width =
// next_pow2(n_live) with (NEG, sentinel), best (score desc, id asc) first.
// Thread t holds entries kSortPer * t + e in registers: a stride under
// kSortPer pairs two entries of one thread, a stride under 32 * kSortPer a
// shuffle partner in the warp, and only longer strides (10 of the 55
// stages at width 1024) go through shared memory, with two barriers each.
constexpr int kSortPer = kMaxRows / kThreads;

__device__ __forceinline__ bool ranks_first(float sa, int ia, float sb,
                                            int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// What a compare-exchange of block `size` and `stride` leaves at entry i,
// which holds (s, id), against its partner's (so, io).
__device__ __forceinline__ void keep_at(int i, int size, int stride, float& s,
                                        int& id, float so, int io) {
  const bool up = (i & size) == 0;       // the block ranks best first
  const bool lower = (i & stride) == 0;  // i is the pair's lower entry
  if (ranks_first(s, id, so, io) != (lower == up)) {
    s = so;
    id = io;
  }
}

__device__ __forceinline__ void sort_list(float* s_score, int* s_id,
                                          int n_live, int tid) {
  int width = 1;
  while (width < n_live) width <<= 1;
  float s[kSortPer];
  int id[kSortPer];
#pragma unroll
  for (int e = 0; e < kSortPer; ++e) {
    const int i = kSortPer * tid + e;
    s[e] = i < n_live ? s_score[i] : kNeg;
    id[e] = i < n_live ? s_id[i] : kIdSentinel;
  }
  for (int size = 2; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32 * kSortPer) {
        __syncthreads();  // the last exchange's reads are done
#pragma unroll
        for (int e = 0; e < kSortPer; ++e) {
          s_score[kSortPer * tid + e] = s[e];
          s_id[kSortPer * tid + e] = id[e];
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < kSortPer; ++e) {
          const int i = kSortPer * tid + e;
          if (i < width)
            keep_at(i, size, stride, s[e], id[e], s_score[i ^ stride],
                    s_id[i ^ stride]);
        }
      } else if (stride >= kSortPer) {
#pragma unroll
        for (int e = 0; e < kSortPer; ++e) {
          const float so = __shfl_xor_sync(0xffffffffu, s[e], stride / kSortPer);
          const int io = __shfl_xor_sync(0xffffffffu, id[e], stride / kSortPer);
          keep_at(kSortPer * tid + e, size, stride, s[e], id[e], so, io);
        }
      } else {
#pragma unroll
        for (int half = kSortPer / 2; half > 0; half >>= 1) {
          if (stride != half) continue;
#pragma unroll
          for (int e = 0; e < kSortPer; ++e) {
            if (e & half) continue;
            const bool up = ((kSortPer * tid + e) & size) == 0;
            if (ranks_first(s[e], id[e], s[e | half], id[e | half]) != up) {
              const float ts = s[e];
              s[e] = s[e | half];
              s[e | half] = ts;
              const int ti = id[e];
              id[e] = id[e | half];
              id[e | half] = ti;
            }
          }
        }
      }
    }
  }
  __syncthreads();  // every exchange's reads are done
#pragma unroll
  for (int e = 0; e < kSortPer; ++e) {
    s_score[kSortPer * tid + e] = s[e];
    s_id[kSortPer * tid + e] = id[e];
  }
  __syncthreads();
}

// The k slots of a list of at most kThreads entries without a sort: thread
// t counts the entries that rank before entry t (n_live compares of
// broadcast shared-memory reads, no barrier) and writes entry t at that
// rank if it is under k. The ranks are distinct, since ids are.
__device__ __forceinline__ void emit_ranked(const float* s_score,
                                            const int* s_id, int n_live,
                                            int k, float* os, int* oi,
                                            int tid) {
  if (tid < n_live) {
    const float s = s_score[tid];
    const int id = s_id[tid];
    int rank = 0;
    for (int e = 0; e < n_live; ++e)
      rank += ranks_first(s_score[e], s_id[e], s, id);
    if (rank < k) {
      const bool live = s > 0.5f * kNeg;
      os[rank] = live ? s : kNeg;
      oi[rank] = live ? id : -1;
    }
  }
  for (int t = n_live + tid; t < k; t += kThreads) {
    os[t] = kNeg;
    oi[t] = -1;
  }
}

template <typename T, bool kL2>
__global__ void __launch_bounds__(kThreads, 2)
masked_topk_kernel(const float* __restrict__ q, const T* __restrict__ vec,
                   const float* __restrict__ scale,
                   const float* __restrict__ scalars,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   const float* __restrict__ act, int n_rows, int d, int M,
                   int block_rows, int k, int vec_ok,
                   float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float s_query[];
  __shared__ float s_score[kMaxRows];
  __shared__ int s_id[kMaxRows];  // the qualifying rows' ids, in row order
  __shared__ bool s_ok[kMaxRows];
  __shared__ float s_lo[kMaxScalars], s_hi[kMaxScalars], s_act[kMaxScalars];
  __shared__ int s_warp_live[kWarps];

  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = j * block_rows;
  const int rows = max(0, min(block_rows, n_rows - row0));

  // 1. the query and the predicate fields
  constexpr bool kInt8 = sizeof(T) == 1;
  if (kInt8 && vec_ok) {
    const int n16 = d >> 4;
    for (int x = tid; x < d; x += kThreads)
      s_query[(((x >> 2) & 3) * n16 + (x >> 4)) * 4 + (x & 3)] = q[x];
  } else {
    for (int x = tid; x < d; x += kThreads) s_query[x] = q[x];
  }
  if (tid < M) {
    s_lo[tid] = lo[tid];
    s_hi[tid] = hi[tid];
    s_act[tid] = act[tid];
  }
  __syncthreads();

  // 2. the predicate first: row t's M scalars by a group of G = next_pow2(M)
  // lanes, field f on lane f of its group; row t of pass p is
  // p * (kThreads / G) + tid / G. Eight passes' loads are issued before any
  // is used. A row passes when every lane of its group passes (a lane past
  // M or on an inactive column passes without a load).
  bool any_active = false;
  for (int m = 0; m < M; ++m) any_active |= s_act[m] >= 0.5f;
  if (any_active) {
    int lg = 0;
    while ((1 << lg) < M) ++lg;
    const int G = 1 << lg;
    const int f = tid & (G - 1);
    const int first = tid >> lg;
    const int per_pass = kThreads >> lg;
    const int n_pass = (rows + per_pass - 1) / per_pass;
    const int gbase = lane & ~(G - 1) & 31;
    const unsigned gmask = G == 32 ? 0xffffffffu : (1u << G) - 1u;
    const bool f_act = f < M && s_act[f] >= 0.5f;
    const float f_lo = f_act ? s_lo[f] : 0.f;
    const float f_hi = f_act ? s_hi[f] : 0.f;
    for (int p0 = 0; p0 < n_pass; p0 += kFieldPasses) {
      float x[kFieldPasses];
#pragma unroll
      for (int u = 0; u < kFieldPasses; ++u) {
        const int t = (p0 + u) * per_pass + first;
        x[u] = f_act && t < rows
                   ? __ldg(scalars + (size_t)(row0 + t) * M + f) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFieldPasses; ++u) {
        if (p0 + u >= n_pass) break;  // uniform across the CTA
        const int t = (p0 + u) * per_pass + first;
        const bool pass = !f_act || (x[u] >= f_lo && x[u] <= f_hi);
        const unsigned all = (__ballot_sync(0xffffffffu, pass) >> gbase) & gmask;
        if (f == 0 && t < rows) s_ok[t] = all == gmask;
      }
    }
  }
  __syncthreads();

  // 3. compact the qualifying rows into s_id, kThreads rows at a time
  int n_live = 0;
  for (int c0 = 0; c0 < rows; c0 += kThreads) {
    const int t = c0 + tid;
    const bool live = t < rows && (!any_active || s_ok[t]);
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_warp_live[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp_live[w];
      if (w < warp) before += c;
      total += c;
    }
    if (live) s_id[n_live + before + __popc(bal & ((1u << lane) - 1u))] =
        row0 + t;
    n_live += total;
    __syncthreads();  // s_warp_live is rewritten by the next chunk
  }

  // 4. score the list
  if constexpr (kInt8) {
    score_list(vec, scale, s_query, s_id, s_score, n_live, d, vec_ok != 0,
               tid);
  } else {
    score_list<kL2>(vec, s_query, s_id, s_score, n_live, d, vec_ok != 0, tid);
  }

  // 5. the k slots, best (score desc, id asc) first, (NEG, -1) past the
  // list: a list of at most one entry a thread is ranked by counting, a
  // longer one sorted
  __syncthreads();  // every score is in
  float* os = out_s + (size_t)j * k;
  int* oi = out_i + (size_t)j * k;
  if (n_live <= kThreads) {
    emit_ranked(s_score, s_id, n_live, k, os, oi, tid);
  } else {
    sort_list(s_score, s_id, n_live, tid);
    for (int t = tid; t < k; t += kThreads) {
      const float sc = t < n_live ? s_score[t] : kNeg;
      const bool live = sc > 0.5f * kNeg;
      os[t] = live ? sc : kNeg;
      oi[t] = live ? s_id[t] : -1;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `vec` holds (>= n_rows, d) float
// rows, or int8 rows when `int8_rows` (then `scale` is their f32 dequant
// scale, else null); `scalars` (>= n_rows, M) f32; lo/hi/act (M,) f32; outputs
// (n_blocks, k) f32 / i32 for n_blocks >= ceil(n_rows / block_rows) (blocks
// past n_rows come out empty). Launches on `stream` and returns
// cudaGetLastError() of the launch (0 = success). Shapes are checked by the
// Python wrapper; the limits here guard the static buffers.
extern "C" int masked_topk_launch(int int8_rows, int l2, const float* q,
                                  const void* vec, const float* scale,
                                  const float* scalars, const float* lo,
                                  const float* hi, const float* act,
                                  int n_rows, int n_blocks, int d, int M,
                                  int block_rows, int k, float* out_s,
                                  int* out_i, void* stream) {
  if (n_rows < 1 || d < 1 || d > kMaxQueryFloats || M < 0 ||
      M > kMaxScalars || block_rows < 1 || block_rows > kMaxRows || k < 1 ||
      k > kMaxRows || n_blocks < (n_rows + block_rows - 1) / block_rows ||
      (int8_rows && (l2 || scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = int8_rows ? 1 : 4;
  const int vec_ok = (d * elem) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vec) % 16 == 0;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_rows) {
    masked_topk_kernel<int8_t, false><<<n_blocks, kThreads, smem, st>>>(
        q, static_cast<const int8_t*>(vec), scale, scalars, lo, hi, act,
        n_rows, d, M, block_rows, k, vec_ok, out_s, out_i);
  } else if (l2) {
    masked_topk_kernel<float, true><<<n_blocks, kThreads, smem, st>>>(
        q, static_cast<const float*>(vec), nullptr, scalars, lo, hi, act,
        n_rows, d, M, block_rows, k, vec_ok, out_s, out_i);
  } else {
    masked_topk_kernel<float, false><<<n_blocks, kThreads, smem, st>>>(
        q, static_cast<const float*>(vec), nullptr, scalars, lo, hi, act,
        n_rows, d, M, block_rows, k, vec_ok, out_s, out_i);
  }
  return static_cast<int>(cudaGetLastError());
}
