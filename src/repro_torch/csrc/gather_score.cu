// Candidate-local gather + weighted score + DNF mask + block top-k.
//
// Replaces the TPU Pallas kernel `_kernel` of src/repro/kernels/gather_score.py
// (launched by `gather_score_blocks`), in both of its variants: fp32 vector
// columns (kernel 1) and int8 replicas with a per-row f32 dequant scale
// (kernel 2, stage 1 of `gather_score_topk_int8`). One source, templated on
// the element type of the gathered rows.
//
// What it computes, per (query b, block j of `bs` candidate slots):
//   * gathers each slot's row (clamped id; -1 marks padding) from every
//     weighted vector column and the (n, M) scalar matrix;
//   * scores  sum_i w_i * s_i  with  s_i = q_i.v_i  (int8: scale * q_i.v_i),
//     and for l2  s_i = 2 q_i.v_i - |v_i|^2 - |q_i|^2  (int8: the norm term
//     rescales by scale^2) — score VALUES match table.similarity;
//   * DNF mask: OR over valid clauses of AND over active columns of
//     lo <= x <= hi; a slot qualifies if it passes and its id is >= 0;
//   * writes the block's qualifying-slot count and its top-k distinct row
//     ids by (score desc, id asc); empty output slots carry score NEG and
//     id -1. The caller merges blocks (merge_topk_unique in torch).
//
// Bound on the H100: the gather. Every valid slot names a row of
// sum_i d_i*elem bytes of vectors plus 4M bytes of scalars (+4 bytes of
// scale per column for int8), and every slot has a 4-byte id. The slots of
// one launch repeat rows (a batch's queries probe shared IVF clusters), and
// a repeated row need leave HBM only once, so the least traffic is
// distinct_rows*(sum d_i*elem + 4M) + B*S*4 bytes over 3.35 TB/s; the
// design issues B*S*(sum d_i*elem + 4M + 4) bytes of loads, the repeats
// served from L2 when they hit there. The arithmetic (2*sum d_i flops per
// slot) is two orders of magnitude below the fp32 rate, so the kernel is
// memory bound.
//
// What the design does about it: one CTA per (256-slot block, query), with
// the query vectors and predicate fields staged once in shared memory; one
// warp per candidate row, whose lanes read the row with 16-byte loads
// (a 768-float row is six coalesced 512-byte passes, an int8 row one and a
// half), so every gathered byte is read once and in full sectors. The warp
// reduces with shuffles. The block top-k is a bitonic sort of the 256
// (score, id) pairs in shared memory; duplicates of a row score
// bit-identically, so they sit side by side and the emit step skips them.
// Not done yet: keeping several rows per warp in flight (cp.async
// pipelines) and a persistent grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace {

constexpr int kMaxCols = 4;
constexpr int kMaxPredFields = 64;  // C * M <= 4 * 16
constexpr int kBlockSlots = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr int kIdSentinel = 1 << 30;

struct Cols {
  const void* vec[kMaxCols];     // (n, d_i) float or int8, row-major
  const float* scale[kMaxCols];  // (n,) per-row dequant scale (int8 only)
  const float* q[kMaxCols];      // (B, d_i) f32
  int dim[kMaxCols];
  int qoff[kMaxCols];            // column i's query offset in shared memory
  int vec_ok[kMaxCols];          // 16-byte loads allowed for column i
};

template <typename T, bool kL2>
__global__ void __launch_bounds__(kThreads)
gather_score_kernel(const int* __restrict__ cand, int S, int n_rows, int n_vec,
                    Cols cols, const float* __restrict__ weights,
                    const float* __restrict__ scalars, int M,
                    const float* __restrict__ lo, const float* __restrict__ hi,
                    const float* __restrict__ act, const float* __restrict__ cval,
                    int C, int apply_pred, int bs, int k,
                    float* __restrict__ out_s, int* __restrict__ out_i,
                    int* __restrict__ out_q) {
  extern __shared__ __align__(16) float s_query[];
  __shared__ float s_score[kBlockSlots];
  __shared__ int s_id[kBlockSlots];
  __shared__ float s_lo[kMaxPredFields], s_hi[kMaxPredFields], s_act[kMaxPredFields];
  __shared__ float s_cval[kMaxCols];
  __shared__ float s_w[kMaxCols], s_qn[kMaxCols];
  __shared__ int s_qual;

  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int nb = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = 0; i < n_vec; ++i) {
    const float* src = cols.q[i] + (size_t)b * cols.dim[i];
    float* dst = s_query + cols.qoff[i];
    for (int e = tid; e < cols.dim[i]; e += kThreads) dst[e] = src[e];
  }
  if (apply_pred) {
    for (int e = tid; e < C * M; e += kThreads) {
      s_lo[e] = lo[(size_t)b * C * M + e];
      s_hi[e] = hi[(size_t)b * C * M + e];
      s_act[e] = act[(size_t)b * C * M + e];
    }
    if (tid < C) s_cval[tid] = cval[(size_t)b * C + tid];
  }
  if (tid < n_vec) s_w[tid] = weights[(size_t)b * n_vec + tid];
  if (tid == 0) s_qual = 0;
  __syncthreads();
  if (kL2 && warp < n_vec) {
    const float* qv = s_query + cols.qoff[warp];
    float acc = 0.f;
    for (int e = lane; e < cols.dim[warp]; e += 32) acc += qv[e] * qv[e];
    acc = warp_sum(acc);
    if (lane == 0) s_qn[warp] = acc;
  }
  __syncthreads();

  const int* cand_b = cand + (size_t)b * S + (size_t)j * bs;
  for (int t = warp; t < kBlockSlots; t += kWarps) {
    const int id = t < bs ? cand_b[t] : -1;
    const int idc = min(max(id, 0), n_rows - 1);
    float total = 0.f;
    for (int i = 0; i < n_vec; ++i) {
      const int d = cols.dim[i];
      const T* row = static_cast<const T*>(cols.vec[i]) + (size_t)idc * d;
      float dot = 0.f, vv = 0.f;
      RowDot<T>::run(row, s_query + cols.qoff[i], d, lane, cols.vec_ok[i] != 0,
                     dot, vv);
      dot = warp_sum(dot);
      if (kL2) vv = warp_sum(vv);
      float s;
      if (cols.scale[i] != nullptr) {
        const float sc = __ldg(cols.scale[i] + idc);
        s = dot * sc;
        if (kL2) s = 2.f * s - vv * sc * sc - s_qn[i];
      } else {
        s = dot;
        if (kL2) s = 2.f * s - vv - s_qn[i];
      }
      total += s_w[i] * s;
    }
    if (lane == 0) {
      bool ok = true;
      if (apply_pred) {
        const float* srow = scalars + (size_t)idc * M;
        ok = false;
        for (int c = 0; c < C; ++c) {
          bool clause = s_cval[c] > 0.5f;
          for (int m = 0; m < M && clause; ++m) {
            const float x = __ldg(srow + m);
            const int f = c * M + m;
            clause = (x >= s_lo[f] && x <= s_hi[f]) || s_act[f] < 0.5f;
          }
          ok = ok || clause;
        }
      }
      const bool qual = ok && id >= 0;
      if (qual) atomicAdd(&s_qual, 1);
      s_score[t] = qual ? total : kNeg;
      s_id[t] = id >= 0 ? id : kIdSentinel;
    }
  }
  __syncthreads();

  // bitonic sort of the 256 slots: best (score desc, id asc) first
  for (int size = 2; size <= kBlockSlots; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int p = tid ^ stride;
      if (p > tid) {
        const float si = s_score[tid], sp = s_score[p];
        const int ii = s_id[tid], ip = s_id[p];
        const bool i_first = si > sp || (si == sp && ii < ip);
        const bool want_i_first = (tid & size) == 0;
        if (i_first != want_i_first) {
          s_score[tid] = sp;
          s_score[p] = si;
          s_id[tid] = ip;
          s_id[p] = ii;
        }
      }
      __syncthreads();
    }
  }

  if (tid == 0) {
    float* os = out_s + ((size_t)b * nb + j) * k;
    int* oi = out_i + ((size_t)b * nb + j) * k;
    int cnt = 0;
    int last = -1;
    for (int p = 0; p < kBlockSlots && cnt < k; ++p) {
      const float sc = s_score[p];
      if (!(sc > 0.5f * kNeg)) break;  // sorted: only masked slots remain
      const int id = s_id[p];
      if (id == last) continue;  // duplicate of the row just emitted
      os[cnt] = sc;
      oi[cnt] = id;
      last = id;
      ++cnt;
    }
    for (; cnt < k; ++cnt) {
      os[cnt] = kNeg;
      oi[cnt] = -1;
    }
    out_q[(size_t)b * nb + j] = s_qual;
  }
}

template <typename T>
cudaError_t launch_typed(bool l2, dim3 grid, size_t smem, cudaStream_t stream,
                         const int* cand, int S, int n_rows, int n_vec,
                         const Cols& cols, const float* weights,
                         const float* scalars, int M, const float* lo,
                         const float* hi, const float* act, const float* cval,
                         int C, int apply_pred, int bs, int k, float* out_s,
                         int* out_i, int* out_q) {
  if (l2) {
    gather_score_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        cand, S, n_rows, n_vec, cols, weights, scalars, M, lo, hi, act, cval,
        C, apply_pred, bs, k, out_s, out_i, out_q);
  } else {
    gather_score_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        cand, S, n_rows, n_vec, cols, weights, scalars, M, lo, hi, act, cval,
        C, apply_pred, bs, k, out_s, out_i, out_q);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointer arrays `vecs`, `scales`,
// `qs` and `dims` are host arrays of length n_vec holding device pointers;
// `scales` entries are null for fp32 columns. Launches on `stream` and
// returns cudaGetLastError() of the launch (0 = success). Shapes are checked
// by the Python wrapper; the limits here only guard the static buffers.
extern "C" int gather_score_launch(int int8_rows, int l2, const int* cand,
                                   int B, int S, int n_rows, int n_vec,
                                   const void* const* vecs,
                                   const float* const* scales,
                                   const float* const* qs, const int* dims,
                                   const float* weights, const float* scalars,
                                   int M, const float* lo, const float* hi,
                                   const float* act, const float* cval, int C,
                                   int apply_pred, int bs, int k, float* out_s,
                                   int* out_i, int* out_q, void* stream) {
  if (n_vec < 0 || n_vec > kMaxCols || C * M > kMaxPredFields || C > kMaxCols ||
      bs < 1 || bs > kBlockSlots || S % bs != 0 || k < 1 || B < 1 ||
      n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cols cols = {};
  int off = 0;
  for (int i = 0; i < n_vec; ++i) {
    cols.vec[i] = vecs[i];
    cols.scale[i] = scales[i];
    cols.q[i] = qs[i];
    cols.dim[i] = dims[i];
    cols.qoff[i] = off;
    off += (dims[i] + 3) & ~3;  // 16-byte aligned query slices
    const int elems_per_16b = int8_rows ? 16 : 4;
    cols.vec_ok[i] = (dims[i] % elems_per_16b == 0) &&
                     (reinterpret_cast<uintptr_t>(vecs[i]) % 16 == 0);
  }
  const size_t smem = static_cast<size_t>(off > 0 ? off : 4) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(S / bs, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_rows) {
    return static_cast<int>(launch_typed<int8_t>(
        l2 != 0, grid, smem, st, cand, S, n_rows, n_vec, cols, weights,
        scalars, M, lo, hi, act, cval, C, apply_pred, bs, k, out_s, out_i,
        out_q));
  }
  return static_cast<int>(launch_typed<float>(
      l2 != 0, grid, smem, st, cand, S, n_rows, n_vec, cols, weights, scalars,
      M, lo, hi, act, cval, C, apply_pred, bs, k, out_s, out_i, out_q));
}
