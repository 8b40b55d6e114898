// Full-table filtered scan: score every row, conjunctive range mask, block
// top-k.
//
// Replaces two TPU Pallas kernels: `_kernel` of
// src/repro/kernels/masked_topk.py (launched by `masked_topk_blocks`, fp32
// rows, dot or l2) and `_kernel` of src/repro/kernels/int8_scan.py
// (launched by `int8_topk_blocks`, int8 rows with a per-row f32 dequant
// scale, dot only). One source, templated on the row element type.
//
// What it computes, per block j of `block_rows` table rows:
//   * the score of every row gid < n_rows:  q.v  (int8: scale[gid] * q.v),
//     and for l2  2 q.v - |v|^2  — the query's constant -|q|^2 is dropped,
//     unlike the gather kernel;
//   * the conjunctive mask: AND over the M columns of
//     (lo <= x <= hi) || active < 0.5; a failing row scores NEG, and so
//     does every slot past n_rows (the table is never padded: the kernel
//     bounds-checks gid instead of copying the table to a block multiple);
//   * the block's top-k (score, id) pairs, by score descending then id
//     ascending; a slot whose score is <= NEG/2 is written as (NEG, -1).
//     The caller merges the blocks (ops._merge in torch).
//
// Bound on the H100: the bytes. Every row is read once — n*d*elem bytes of
// vectors (+4n of int8 scales) and 4nM of scalars — against 2nd flops for
// the dot (4nd with the l2 norm), two orders of magnitude under the fp32
// rate at d=768. At n=200,000, d=768, M=4 that is 617.6 MB (fp32) or
// 157.6 MB (int8), 0.184 ms or 0.047 ms at 3.35 TB/s.
//
// What the design does about it: one CTA per row tile, with the query and
// the predicate fields staged once in shared memory; one warp per row, its
// lanes reading the row with 16-byte loads and reducing with shuffles, so
// every table byte is read once and in full sectors. The block's (score,
// id) pairs sit in shared memory and a bitonic sort over the next power of
// two >= max(block_rows, k) orders them (the selection gather_score.cu
// uses). Not done yet: several rows in flight per warp (cp.async
// pipelines), a persistent grid, and a selection cheaper than a full sort.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 1024;  // the sort width: block_rows and k <= 1024
constexpr int kMaxScalars = 16;
constexpr int kMaxQueryFloats = 8 * 1024;  // 32 KB: with the sort, under 48 KB
constexpr float kNeg = -1e30f;
constexpr int kIdSentinel = 1 << 30;

template <typename T, bool kL2>
__global__ void __launch_bounds__(kThreads)
masked_topk_kernel(const float* __restrict__ q, const T* __restrict__ vec,
                   const float* __restrict__ scale,
                   const float* __restrict__ scalars,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   const float* __restrict__ act, int n_rows, int d, int M,
                   int block_rows, int slots, int k, int vec_ok,
                   float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float s_q[];
  __shared__ float s_score[kMaxSlots];
  __shared__ int s_id[kMaxSlots];
  __shared__ float s_lo[kMaxScalars], s_hi[kMaxScalars], s_act[kMaxScalars];

  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < d; e += kThreads) s_q[e] = q[e];
  if (tid < M) {
    s_lo[tid] = lo[tid];
    s_hi[tid] = hi[tid];
    s_act[tid] = act[tid];
  }
  for (int t = tid; t < slots; t += kThreads) {
    s_score[t] = kNeg;
    s_id[t] = kIdSentinel;
  }
  __syncthreads();

  const int row0 = j * block_rows;
  for (int t = warp; t < block_rows; t += kWarps) {
    const int gid = row0 + t;
    if (gid >= n_rows) break;  // warp-uniform: later t only grow
    float dot = 0.f, vv = 0.f;
    RowDot<T>::run(vec + (size_t)gid * d, s_q, d, lane, vec_ok != 0, dot, vv);
    dot = warp_sum(dot);
    if (kL2) vv = warp_sum(vv);
    if (lane == 0) {
      float s = scale != nullptr ? dot * __ldg(scale + gid) : dot;
      if (kL2) s = 2.f * s - vv;
      const float* srow = scalars + (size_t)gid * M;
      bool ok = true;
      for (int m = 0; m < M && ok; ++m) {
        const float x = __ldg(srow + m);
        ok = (x >= s_lo[m] && x <= s_hi[m]) || s_act[m] < 0.5f;
      }
      s_score[t] = ok ? s : kNeg;
      s_id[t] = gid;
    }
  }
  __syncthreads();

  // bitonic sort of the block's slots: best (score desc, id asc) first
  for (int size = 2; size <= slots; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < slots; i += kThreads) {
        const int p = i ^ stride;
        if (p > i) {
          const float si = s_score[i], sp = s_score[p];
          const int ii = s_id[i], ip = s_id[p];
          const bool i_first = si > sp || (si == sp && ii < ip);
          const bool want_i_first = (i & size) == 0;
          if (i_first != want_i_first) {
            s_score[i] = sp;
            s_score[p] = si;
            s_id[i] = ip;
            s_id[p] = ii;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int t = tid; t < k; t += kThreads) {
    const float sc = s_score[t];
    const bool live = sc > 0.5f * kNeg;
    out_s[(size_t)j * k + t] = live ? sc : kNeg;
    out_i[(size_t)j * k + t] = live ? s_id[t] : -1;
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
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
      M > kMaxScalars || block_rows < 1 || block_rows > kMaxSlots || k < 1 ||
      k > kMaxSlots || n_blocks < (n_rows + block_rows - 1) / block_rows ||
      (int8_rows && (l2 || scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slots = next_pow2(block_rows > k ? block_rows : k);
  const int elem = int8_rows ? 1 : 4;
  const int vec_ok = (d * elem) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vec) % 16 == 0;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_rows) {
    masked_topk_kernel<int8_t, false><<<n_blocks, kThreads, smem, st>>>(
        q, static_cast<const int8_t*>(vec), scale, scalars, lo, hi, act,
        n_rows, d, M, block_rows, slots, k, vec_ok, out_s, out_i);
  } else if (l2) {
    masked_topk_kernel<float, true><<<n_blocks, kThreads, smem, st>>>(
        q, static_cast<const float*>(vec), nullptr, scalars, lo, hi, act,
        n_rows, d, M, block_rows, slots, k, vec_ok, out_s, out_i);
  } else {
    masked_topk_kernel<float, false><<<n_blocks, kThreads, smem, st>>>(
        q, static_cast<const float*>(vec), nullptr, scalars, lo, hi, act,
        n_rows, d, M, block_rows, slots, k, vec_ok, out_s, out_i);
  }
  return static_cast<int>(cudaGetLastError());
}
