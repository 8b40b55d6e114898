// Row dot products against a query held in shared memory, shared by the
// port's kernels (gather_score.cu, masked_topk.cu).
//
// A table row is scored by a group of lanes with several rows in flight:
// every load of a step, for every row the group holds, is issued before any
// is used, so one round trip to HBM serves R rows. Each lane keeps a partial
// q.v (and v.v for l2) per row; warp_sum or group_sum reduces them. Every
// row is scored by the same code, lane mapping and order of explicitly
// rounded operations, whichever group or pass it lands in, so two reads of
// one row score bit-identically.
//
//   * int8 rows: 16-lane groups (kGroupLanes). A 768-byte row is three
//     16-byte loads a lane, so no lane idles. Each int8 value becomes a
//     float exactly by a byte permute and one subtraction (no I2F, which
//     issues at a fraction of the FMA rate); v.v is an exact integer
//     __dp4a. The query of an aligned row is staged transposed (float4 f of
//     16-byte chunk e at f*(d/16) + e), so a group's lanes read consecutive
//     float4s of shared memory with no bank conflict. Unaligned widths or
//     addresses read a byte a lane.
//   * fp32 rows: whole warps, float4 e on lane e % 32, six loads a lane per
//     step (a 768-float row is one step); a float a lane where 16-byte
//     loads are ruled out.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr int kGroupLanes = 16;    // lanes that score one int8 row
constexpr int kChunkLoads = 3;     // 16-byte loads a lane issues per int8 row and step
constexpr int kF32ChunkLoads = 6;  // float4 loads a lane issues per fp32 row and step

// The int8 value in byte c of `biased` (a word XOR 0x80808080, so each byte
// holds v + 128), exactly: placed in the low mantissa byte of 2^23 it reads
// 2^23 + v + 128.
__device__ __forceinline__ float i8_at(uint32_t biased, int c) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | c)) -
         8388736.f;
}

__device__ __forceinline__ void dot_word(int w, float4 q, float& dot) {
  const uint32_t u = static_cast<uint32_t>(w) ^ 0x80808080u;
  dot = fmaf(i8_at(u, 0), q.x, dot);
  dot = fmaf(i8_at(u, 1), q.y, dot);
  dot = fmaf(i8_at(u, 2), q.z, dot);
  dot = fmaf(i8_at(u, 3), q.w, dot);
}

// Sum over the 16 lanes of a group; every lane of the warp takes part.
template <typename V>
__device__ __forceinline__ V group_sum(V x) {
#pragma unroll
  for (int off = kGroupLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Lane l's partial q.v (and v.v) of R int8 rows of an aligned width: chunk
// e (16 bytes) of each row goes to lane e % 16, all of a step's loads issued
// before any is used. `q4` is the transposed query.
template <bool kL2, int R>
__device__ __forceinline__ void row_dots_aligned(
    const int8_t* const (&row)[R], const bool (&has)[R], const float4* q4,
    int n16, int l, float (&dot)[R], int (&vv)[R]) {
  for (int e0 = 0; e0 < n16; e0 += kGroupLanes * kChunkLoads) {
    int4 raw[R][kChunkLoads];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = 0; u < kChunkLoads; ++u) {
        const int e = e0 + u * kGroupLanes + l;
        raw[r][u] = make_int4(0, 0, 0, 0);
        if (has[r] && e < n16)
          raw[r][u] = __ldg(reinterpret_cast<const int4*>(row[r]) + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunkLoads; ++u) {
      const int e = e0 + u * kGroupLanes + l;
      if (e >= n16) continue;
      const float4 qa = q4[e], qb = q4[n16 + e], qc = q4[2 * n16 + e],
                   qd = q4[3 * n16 + e];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int4 v = raw[r][u];
        dot_word(v.x, qa, dot[r]);
        dot_word(v.y, qb, dot[r]);
        dot_word(v.z, qc, dot[r]);
        dot_word(v.w, qd, dot[r]);
        if (kL2) {
          vv[r] = __dp4a(v.x, v.x, vv[r]);
          vv[r] = __dp4a(v.y, v.y, vv[r]);
          vv[r] = __dp4a(v.z, v.z, vv[r]);
          vv[r] = __dp4a(v.w, v.w, vv[r]);
        }
      }
    }
  }
}

// The same for a width or address that rules out 16-byte loads: element e
// goes to lane e % 16, one byte a load; `q` in natural order.
template <bool kL2, int R>
__device__ __forceinline__ void row_dots_bytes(
    const int8_t* const (&row)[R], const bool (&has)[R], const float* q, int d,
    int l, float (&dot)[R], int (&vv)[R]) {
  for (int e = l; e < d; e += kGroupLanes) {
    const float qe = q[e];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int v = has[r] ? static_cast<int>(__ldg(row[r] + e)) : 0;
      dot[r] = fmaf(static_cast<float>(v), qe, dot[r]);
      if (kL2) vv[r] += v * v;
    }
  }
}

// Lane `lane`'s partial q.v (and v.v) of R fp32 rows of an aligned width:
// float4 e of each row goes to lane e % 32, all of a step's loads issued
// before any is used (a 768-float row is one step).
template <bool kL2, int R>
__device__ __forceinline__ void f32_row_dots_aligned(
    const float* const (&row)[R], const bool (&has)[R], const float4* q4,
    int n4, int lane, float (&dot)[R], float (&vv)[R]) {
  for (int e0 = 0; e0 < n4; e0 += 32 * kF32ChunkLoads) {
    float4 raw[R][kF32ChunkLoads];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = 0; u < kF32ChunkLoads; ++u) {
        const int e = e0 + u * 32 + lane;
        raw[r][u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (has[r] && e < n4)
          raw[r][u] = __ldg(reinterpret_cast<const float4*>(row[r]) + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kF32ChunkLoads; ++u) {
      const int e = e0 + u * 32 + lane;
      if (e >= n4) break;
      const float4 q = q4[e];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v = raw[r][u];
        dot[r] = __fmaf_rn(v.x, q.x, dot[r]);
        dot[r] = __fmaf_rn(v.y, q.y, dot[r]);
        dot[r] = __fmaf_rn(v.z, q.z, dot[r]);
        dot[r] = __fmaf_rn(v.w, q.w, dot[r]);
        if (kL2) {
          vv[r] = __fmaf_rn(v.x, v.x, vv[r]);
          vv[r] = __fmaf_rn(v.y, v.y, vv[r]);
          vv[r] = __fmaf_rn(v.z, v.z, vv[r]);
          vv[r] = __fmaf_rn(v.w, v.w, vv[r]);
        }
      }
    }
  }
}

// The same for a width or address that rules out 16-byte loads: element e
// goes to lane e % 32, one float a load.
template <bool kL2, int R>
__device__ __forceinline__ void f32_row_dots_elems(
    const float* const (&row)[R], const bool (&has)[R], const float* q, int d,
    int lane, float (&dot)[R], float (&vv)[R]) {
  for (int e0 = 0; e0 < d; e0 += 32 * kF32ChunkLoads) {
    float raw[R][kF32ChunkLoads];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = 0; u < kF32ChunkLoads; ++u) {
        const int e = e0 + u * 32 + lane;
        raw[r][u] = has[r] && e < d ? __ldg(row[r] + e) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kF32ChunkLoads; ++u) {
      const int e = e0 + u * 32 + lane;
      if (e >= d) break;
      const float qe = q[e];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dot[r] = __fmaf_rn(raw[r][u], qe, dot[r]);
        if (kL2) vv[r] = __fmaf_rn(raw[r][u], raw[r][u], vv[r]);
      }
    }
  }
}
