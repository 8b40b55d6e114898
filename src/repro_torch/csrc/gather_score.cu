// Candidate-local gather + weighted score + DNF mask + block top-k.
//
// Replaces the TPU Pallas kernel `_kernel` of src/repro/kernels/gather_score.py
// (launched by `gather_score_blocks`), in both of its variants: fp32 vector
// columns (kernel 1) and int8 replicas with a per-row f32 dequant scale
// (kernel 2, stage 1 of `gather_score_topk_int8`). One source, a kernel for
// each element type of the gathered rows.
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
// Bound on the H100: the gather. Every slot has a 4-byte id. A row that
// some valid slot names needs its 4M bytes of scalars to decide the mask;
// only a row that qualifies for some slot needs its sum_i d_i*elem bytes
// of vectors (+4 bytes of scale per column for int8) — without a predicate
// every named row qualifies. The slots of one launch repeat rows (a batch's
// queries probe shared IVF clusters), and a repeated row need leave HBM
// only once, so the least traffic is named_rows*4M + qualifying_rows*(sum
// d_i*elem [+4 n_vec]) + B*S*4 bytes of ids, plus the queries read and the
// block outputs written once, over 3.35 TB/s. The arithmetic (2*sum d_i
// flops per qualifying slot) is two orders of magnitude below the fp32
// rate, so the kernel is memory bound.
//
// Two kernels, one per element type; both take one CTA per (256-slot
// block, query), stage the query vectors and predicate fields once in
// shared memory, and end in the same block top-k: a bitonic sort of the
// 256 (score, id) pairs in shared memory. Duplicates of a row score
// bit-identically, so they sit side by side and the emit step skips them.
//
// fp32 (kernel 1) moves enough bytes a row (3,072 at d=768) to be bound by
// the qualifying rows' vector bytes, once latency is hidden. It runs the
// int8 kernel's first three steps (ids; the predicate first, next_pow2(M)
// lanes a slot, one field a lane, one ballot a clause; the qualifying slots
// compacted into a list), so a padded or failing slot costs no vector byte
// and no lane, and no lane waits on a chain of another's scalar loads. The
// list is then scored by whole warps, two rows in flight a warp: a
// 768-float row is six 16-byte loads a lane, so twelve are issued before
// any is used, 16 rows a CTA. Every row is scored by the same code,
// lane mapping and reduction order with explicitly rounded arithmetic, so
// duplicates score bit-identically; widths or addresses that rule out
// 16-byte loads read a float a lane. Its grid is query-major, so the CTAs
// resident at one time hold the same blocks of every query, and a row that
// several queries' IVF probes share is read again while still in L2. What
// is left between it and its bound: one round trip a pass of 16 rows, the
// fixed work of each CTA (ids, fields, the 256-slot sort, the one-thread
// emit), and shared rows that leave L2 before their last reader comes.
//
// int8 (kernel 2) is bound by latency and instruction issue, not bytes: a
// 768-byte row is too little to hide a round trip behind. Its design, in
// the order a CTA runs it:
//   1. ids: one coalesced load, one slot a thread;
//   2. predicate and scales first: each slot's M scalars and its per-column
//      scales are read by a group of lanes (one field a lane, one coalesced
//      read of the row's scalars), eight slots' loads a lane issued before
//      any is used; each clause is one __ballot_sync over the group's lanes;
//   3. the slots that qualify are compacted into a list, so a padded or
//      failing slot costs no vector byte and no lane;
//   4. the list is scored by 16-lane groups, two rows in flight per group:
//      a 768-byte row is three 16-byte loads a lane and no lane idles. Each
//      int8 value becomes a float exactly by a byte permute and one
//      subtraction (no I2F conversion, which issues at a fraction of the
//      FMA rate); v.v is an exact integer __dp4a. The query of an aligned
//      column is staged transposed (float4 f of 16-byte chunk e at
//      f*(d/16) + e), so a group's lanes read consecutive float4s of shared
//      memory with no bank conflict. Every row is scored by the same code,
//      lane mapping and reduction order, with explicitly rounded
//      arithmetic, whichever group or pass it lands in, so two slots naming
//      one row score bit-identically. Unaligned or odd widths read a byte a
//      lane.
// The row loops of both kernels live in row_dot.cuh, shared with the
// full-table scan (masked_topk.cu).

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

// ---------------------------------------------------------------------------
// int8 (kernel 2)
// ---------------------------------------------------------------------------

constexpr int kGroups = kThreads / kGroupLanes;  // row groups per CTA
constexpr int kRowsInFlight = 2;                 // rows a group loads at once
constexpr int kFieldPasses = 8;  // slots a thread reads fields for at once

template <bool kL2>
__global__ void __launch_bounds__(kThreads)
gather_score_int8_kernel(const int* __restrict__ cand, int S, int n_rows,
                         int n_vec, Cols cols, const float* __restrict__ weights,
                         const float* __restrict__ scalars, int M,
                         const float* __restrict__ lo,
                         const float* __restrict__ hi,
                         const float* __restrict__ act,
                         const float* __restrict__ cval, int C, int apply_pred,
                         int bs, int k, float* __restrict__ out_s,
                         int* __restrict__ out_i, int* __restrict__ out_q) {
  extern __shared__ __align__(16) float s_query[];
  __shared__ float s_score[kBlockSlots];
  __shared__ int s_id[kBlockSlots];
  __shared__ int s_live[kBlockSlots];  // the qualifying slots, in slot order
  __shared__ float s_scale[kMaxCols][kBlockSlots];
  __shared__ bool s_ok[kBlockSlots];
  __shared__ float s_lo[kMaxPredFields], s_hi[kMaxPredFields], s_act[kMaxPredFields];
  __shared__ float s_cval[kMaxCols];
  __shared__ float s_w[kMaxCols], s_qn[kMaxCols];
  __shared__ int s_warp_live[kWarps];

  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int nb = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. the block's ids, the queries and the predicate fields
  s_id[tid] = tid < bs ? cand[(size_t)b * S + (size_t)j * bs + tid] : -1;
  for (int i = 0; i < n_vec; ++i) {
    const int d = cols.dim[i];
    const float* src = cols.q[i] + (size_t)b * d;
    float* dst = s_query + cols.qoff[i];
    if (cols.vec_ok[i]) {
      const int n16 = d >> 4;
      for (int x = tid; x < d; x += kThreads)
        dst[(((x >> 2) & 3) * n16 + (x >> 4)) * 4 + (x & 3)] = src[x];
    } else {
      for (int x = tid; x < d; x += kThreads) dst[x] = src[x];
    }
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
  __syncthreads();

  // 2. each slot's scalars and scales, G lanes a slot (field f on lane f of
  // its group); eight passes' loads are issued before any is used, so
  // G <= 8 (M + n_vec <= 8, as at the main path's M = 4) takes one round
  const int mp = apply_pred ? M : 0;
  const int nf = mp + n_vec;
  int lg = 0;
  while ((1 << lg) < nf) ++lg;
  const int G = 1 << lg;
  const int f = tid & (G - 1);
  const int first = tid >> lg;
  const int per_pass = kThreads >> lg;
  if (kL2 && warp < n_vec) {
    const float* qv = s_query + cols.qoff[warp];
    float acc = 0.f;
    for (int e = lane; e < cols.dim[warp]; e += 32) acc += qv[e] * qv[e];
    acc = warp_sum(acc);
    if (lane == 0) s_qn[warp] = acc;
  }
  // the DNF mask: per clause one ballot, passed when every lane of the
  // group passes (a lane past the scalars passes); this lane's column of
  // each clause is read once
  const int gbase = lane & ~(G - 1) & 31;
  const unsigned gmask = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  bool f_act[kMaxCols];
  float f_lo[kMaxCols], f_hi[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    f_act[c] = c < C && f < mp && s_act[c * M + f] >= 0.5f;
    f_lo[c] = f_act[c] ? s_lo[c * M + f] : 0.f;
    f_hi[c] = f_act[c] ? s_hi[c * M + f] : 0.f;
  }
  for (int p0 = 0; p0 < G; p0 += kFieldPasses) {
    float x[kFieldPasses];
#pragma unroll
    for (int u = 0; u < kFieldPasses; ++u) {
      x[u] = 0.f;
      const int id = p0 + u < G ? s_id[(p0 + u) * per_pass + first] : -1;
      if (id >= 0 && f < nf) {
        const int idc = min(id, n_rows - 1);
        x[u] = f < mp ? __ldg(scalars + (size_t)idc * M + f)
                      : __ldg(cols.scale[f - mp] + idc);
      }
    }
#pragma unroll
    for (int u = 0; u < kFieldPasses; ++u) {
      if (p0 + u >= G) break;  // uniform across the CTA
      const int t = (p0 + u) * per_pass + first;
      bool ok = true;
      if (apply_pred) {
        ok = false;
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          if (c >= C) break;  // uniform across the CTA
          const bool pass = !f_act[c] || (x[u] >= f_lo[c] && x[u] <= f_hi[c]);
          const unsigned all = (__ballot_sync(0xffffffffu, pass) >> gbase) & gmask;
          ok = ok || (all == gmask && s_cval[c] > 0.5f);
        }
      }
      if (f == 0) s_ok[t] = ok;
      if (f >= mp && f < nf) s_scale[f - mp][t] = x[u];
    }
  }
  __syncthreads();

  // 3. compact the qualifying slots
  const int my_id = s_id[tid];
  const bool live = my_id >= 0 && s_ok[tid];
  const unsigned bal = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_warp_live[warp] = __popc(bal);
  s_score[tid] = live ? 0.f : kNeg;
  __syncthreads();
  int n_live = 0, before = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp_live[w];
    if (w < warp) before += c;
    n_live += c;
  }
  if (live) s_live[before + __popc(bal & ((1u << lane) - 1u))] = tid;
  __syncthreads();

  // 4. score the qualifying rows: group g takes list entries
  // (p * kRowsInFlight + r) * kGroups + g; every thread runs every pass
  const int g = tid / kGroupLanes;
  const int l = tid % kGroupLanes;
  const int n_pass = (n_live + kGroups * kRowsInFlight - 1) /
                     (kGroups * kRowsInFlight);
  for (int i = 0; i < n_vec; ++i) {
    const int d = cols.dim[i];
    const int8_t* vec = static_cast<const int8_t*>(cols.vec[i]);
    const float* sq = s_query + cols.qoff[i];
    const float w = s_w[i];
    for (int p = 0; p < n_pass; ++p) {
      int slot[kRowsInFlight];
      bool has[kRowsInFlight];
      const int8_t* row[kRowsInFlight];
      float dot[kRowsInFlight];
      int vv[kRowsInFlight];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const int idx = (p * kRowsInFlight + r) * kGroups + g;
        has[r] = idx < n_live;
        slot[r] = has[r] ? s_live[idx] : 0;
        const int idc = has[r] ? min(s_id[slot[r]], n_rows - 1) : 0;
        row[r] = vec + (size_t)idc * d;
        dot[r] = 0.f;
        vv[r] = 0;
      }
      if (cols.vec_ok[i]) {
        row_dots_aligned<kL2, kRowsInFlight>(
            row, has, reinterpret_cast<const float4*>(sq), d >> 4, l, dot, vv);
      } else {
        row_dots_bytes<kL2, kRowsInFlight>(row, has, sq, d, l, dot, vv);
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const float dsum = group_sum(dot[r]);
        const int vsum = kL2 ? group_sum(vv[r]) : 0;
        if (l == 0 && has[r]) {
          const float sc = s_scale[i][slot[r]];
          float s = __fmul_rn(dsum, sc);
          if (kL2) {
            s = __fsub_rn(__fsub_rn(__fmul_rn(2.f, s),
                                    __fmul_rn(__fmul_rn(static_cast<float>(vsum), sc), sc)),
                          s_qn[i]);
          }
          s_score[slot[r]] = fmaf(w, s, s_score[slot[r]]);
        }
      }
    }
  }
  if (my_id < 0) s_id[tid] = kIdSentinel;
  __syncthreads();

  // 5. the block top-k, as in gather_score_kernel: bitonic sort of the 256
  // slots, best (score desc, id asc) first, then the distinct-id emit
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
    out_q[(size_t)b * nb + j] = n_live;
  }
}

cudaError_t launch_int8(bool l2, dim3 grid, size_t smem, cudaStream_t stream,
                        const int* cand, int S, int n_rows, int n_vec,
                        const Cols& cols, const float* weights,
                        const float* scalars, int M, const float* lo,
                        const float* hi, const float* act, const float* cval,
                        int C, int apply_pred, int bs, int k, float* out_s,
                        int* out_i, int* out_q) {
  auto kernel = l2 ? gather_score_int8_kernel<true>
                   : gather_score_int8_kernel<false>;
  if (smem > 32 * 1024) {  // with the static arrays, past the default 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      cand, S, n_rows, n_vec, cols, weights, scalars, M, lo, hi, act, cval, C,
      apply_pred, bs, k, out_s, out_i, out_q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 (kernel 1)
// ---------------------------------------------------------------------------

constexpr int kF32RowsInFlight = 2;  // rows a warp loads at once

template <bool kL2>
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
  __shared__ int s_live[kBlockSlots];  // the qualifying slots, in slot order
  __shared__ bool s_ok[kBlockSlots];
  __shared__ float s_lo[kMaxPredFields], s_hi[kMaxPredFields], s_act[kMaxPredFields];
  __shared__ float s_cval[kMaxCols];
  __shared__ float s_w[kMaxCols], s_qn[kMaxCols];
  __shared__ int s_warp_live[kWarps];

  const int b = blockIdx.x;  // query-major: see gather_score_launch
  const int j = blockIdx.y;
  const int nb = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. the block's ids, the queries and the predicate fields
  s_id[tid] = tid < bs ? cand[(size_t)b * S + (size_t)j * bs + tid] : -1;
  for (int i = 0; i < n_vec; ++i) {
    const float* src = cols.q[i] + (size_t)b * cols.dim[i];
    float* dst = s_query + cols.qoff[i];
    for (int x = tid; x < cols.dim[i]; x += kThreads) dst[x] = src[x];
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
  __syncthreads();
  if (kL2 && warp < n_vec) {
    const float* qv = s_query + cols.qoff[warp];
    float acc = 0.f;
    for (int e = lane; e < cols.dim[warp]; e += 32) acc += qv[e] * qv[e];
    acc = warp_sum(acc);
    if (lane == 0) s_qn[warp] = acc;
  }

  // 2. the predicate first: each slot's M scalars by a group of G =
  // next_pow2(M) lanes, field f on lane f of its group (one coalesced read
  // of the row's scalars); eight passes' loads are issued before any is
  // used, so M <= 8 takes one round. Per clause one ballot: the clause
  // holds when every lane of the group passes (a lane past M passes).
  if (apply_pred) {
    int lg = 0;
    while ((1 << lg) < M) ++lg;
    const int G = 1 << lg;
    const int f = tid & (G - 1);
    const int first = tid >> lg;
    const int per_pass = kThreads >> lg;
    const int gbase = lane & ~(G - 1) & 31;
    const unsigned gmask = G == 32 ? 0xffffffffu : (1u << G) - 1u;
    bool f_act[kMaxCols];
    float f_lo[kMaxCols], f_hi[kMaxCols];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      f_act[c] = c < C && f < M && s_act[c * M + f] >= 0.5f;
      f_lo[c] = f_act[c] ? s_lo[c * M + f] : 0.f;
      f_hi[c] = f_act[c] ? s_hi[c * M + f] : 0.f;
    }
    for (int p0 = 0; p0 < G; p0 += kFieldPasses) {
      float x[kFieldPasses];
#pragma unroll
      for (int u = 0; u < kFieldPasses; ++u) {
        x[u] = 0.f;
        const int id = p0 + u < G ? s_id[(p0 + u) * per_pass + first] : -1;
        if (id >= 0 && f < M)
          x[u] = __ldg(scalars + (size_t)min(id, n_rows - 1) * M + f);
      }
#pragma unroll
      for (int u = 0; u < kFieldPasses; ++u) {
        if (p0 + u >= G) break;  // uniform across the CTA
        bool ok = false;
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          if (c >= C) break;  // uniform across the CTA
          const bool pass = !f_act[c] || (x[u] >= f_lo[c] && x[u] <= f_hi[c]);
          const unsigned all = (__ballot_sync(0xffffffffu, pass) >> gbase) & gmask;
          ok = ok || (all == gmask && s_cval[c] > 0.5f);
        }
        if (f == 0) s_ok[(p0 + u) * per_pass + first] = ok;
      }
    }
  }
  __syncthreads();

  // 3. compact the qualifying slots
  const int my_id = s_id[tid];
  const bool live = my_id >= 0 && (!apply_pred || s_ok[tid]);
  const unsigned bal = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_warp_live[warp] = __popc(bal);
  s_score[tid] = live ? 0.f : kNeg;
  __syncthreads();
  int n_live = 0, before = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp_live[w];
    if (w < warp) before += c;
    n_live += c;
  }
  if (live) s_live[before + __popc(bal & ((1u << lane) - 1u))] = tid;
  __syncthreads();

  // 4. score the qualifying rows: warp w takes list entries
  // (p * kF32RowsInFlight + r) * kWarps + w; every thread runs every pass
  const int n_pass = (n_live + kWarps * kF32RowsInFlight - 1) /
                     (kWarps * kF32RowsInFlight);
  for (int i = 0; i < n_vec; ++i) {
    const int d = cols.dim[i];
    const float* vec = static_cast<const float*>(cols.vec[i]);
    const float* sq = s_query + cols.qoff[i];
    const float w = s_w[i];
    for (int p = 0; p < n_pass; ++p) {
      int slot[kF32RowsInFlight];
      bool has[kF32RowsInFlight];
      const float* row[kF32RowsInFlight];
      float dot[kF32RowsInFlight], vv[kF32RowsInFlight];
#pragma unroll
      for (int r = 0; r < kF32RowsInFlight; ++r) {
        const int idx = (p * kF32RowsInFlight + r) * kWarps + warp;
        has[r] = idx < n_live;
        slot[r] = has[r] ? s_live[idx] : 0;
        const int idc = has[r] ? min(s_id[slot[r]], n_rows - 1) : 0;
        row[r] = vec + (size_t)idc * d;
        dot[r] = 0.f;
        vv[r] = 0.f;
      }
      if (cols.vec_ok[i]) {
        f32_row_dots_aligned<kL2, kF32RowsInFlight>(
            row, has, reinterpret_cast<const float4*>(sq), d >> 2, lane, dot,
            vv);
      } else {
        f32_row_dots_elems<kL2, kF32RowsInFlight>(row, has, sq, d, lane, dot,
                                                  vv);
      }
#pragma unroll
      for (int r = 0; r < kF32RowsInFlight; ++r) {
        const float dsum = warp_sum(dot[r]);
        const float vsum = kL2 ? warp_sum(vv[r]) : 0.f;
        if (lane == 0 && has[r]) {
          float s = dsum;
          if (kL2) {
            s = __fsub_rn(__fsub_rn(__fmul_rn(2.f, dsum), vsum), s_qn[i]);
          }
          s_score[slot[r]] = __fmaf_rn(w, s, s_score[slot[r]]);
        }
      }
    }
  }
  if (my_id < 0) s_id[tid] = kIdSentinel;
  __syncthreads();

  // 5. the block top-k: bitonic sort of the 256 slots, best (score desc,
  // id asc) first
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
    out_q[(size_t)b * nb + j] = n_live;
  }
}

cudaError_t launch_f32(bool l2, dim3 grid, size_t smem, cudaStream_t stream,
                       const int* cand, int S, int n_rows, int n_vec,
                       const Cols& cols, const float* weights,
                       const float* scalars, int M, const float* lo,
                       const float* hi, const float* act, const float* cval,
                       int C, int apply_pred, int bs, int k, float* out_s,
                       int* out_i, int* out_q) {
  auto kernel = l2 ? gather_score_kernel<true> : gather_score_kernel<false>;
  if (smem > 32 * 1024) {  // with the static arrays, past the default 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      cand, S, n_rows, n_vec, cols, weights, scalars, M, lo, hi, act, cval, C,
      apply_pred, bs, k, out_s, out_i, out_q);
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
    // a slot's scalars and scales are read by one group of at most 32 lanes
    if ((apply_pred ? M : 0) + n_vec > 32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(launch_int8(
        l2 != 0, grid, smem, st, cand, S, n_rows, n_vec, cols, weights,
        scalars, M, lo, hi, act, cval, C, apply_pred, bs, k, out_s, out_i,
        out_q));
  }
  if (apply_pred && M > 32) return static_cast<int>(cudaErrorInvalidValue);
  // fp32 runs query-major (blockIdx.x the query): the CTAs resident at one
  // time take the same blocks of every query, so a row that the queries'
  // IVF probes share is read again while it is still in L2
  return static_cast<int>(launch_f32(
      l2 != 0, dim3(B, S / bs), smem, st, cand, S, n_rows, n_vec, cols,
      weights, scalars, M, lo, hi, act, cval, C, apply_pred, bs, k, out_s,
      out_i, out_q));
}
