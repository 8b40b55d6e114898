// One warp's dot product of a table row with a query held in shared memory,
// shared by the port's kernels (gather_score.cu, masked_topk.cu).
//
// The 32 lanes of a warp read one row with 16-byte loads where the width
// and the row's address allow it (4 floats or 16 int8 values a lane per
// load, neighbouring lanes on neighbouring addresses), else one element a
// lane. Each lane keeps a partial q.v and v.v; warp_sum reduces them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
struct RowDot;

template <>
struct RowDot<float> {
  static __device__ __forceinline__ void run(const float* __restrict__ row,
                                             const float* q, int d, int lane,
                                             bool vec_ok, float& dot, float& vv) {
    if (vec_ok) {
      const float4* r4 = reinterpret_cast<const float4*>(row);
      const float4* q4 = reinterpret_cast<const float4*>(q);
      const int n4 = d >> 2;
#pragma unroll 4
      for (int e = lane; e < n4; e += 32) {
        const float4 v = __ldg(r4 + e);
        const float4 w = q4[e];
        dot += v.x * w.x + v.y * w.y + v.z * w.z + v.w * w.w;
        vv += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
    } else {
      for (int e = lane; e < d; e += 32) {
        const float v = __ldg(row + e);
        dot += v * q[e];
        vv += v * v;
      }
    }
  }
};

template <>
struct RowDot<int8_t> {
  static __device__ __forceinline__ void run(const int8_t* __restrict__ row,
                                             const float* q, int d, int lane,
                                             bool vec_ok, float& dot, float& vv) {
    if (vec_ok) {
      const int4* r16 = reinterpret_cast<const int4*>(row);
      const int n16 = d >> 4;
#pragma unroll 2
      for (int e = lane; e < n16; e += 32) {
        const int4 raw = __ldg(r16 + e);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        const float* w = q + e * 16;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          const float v = static_cast<float>(b[t]);
          dot += v * w[t];
          vv += v * v;
        }
      }
    } else {
      for (int e = lane; e < d; e += 32) {
        const float v = static_cast<float>(row[e]);
        dot += v * q[e];
        vv += v * v;
      }
    }
  }
};
