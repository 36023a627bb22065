// Shared helpers of the port's Hopper kernels: dtype conversion between the
// compute dtype (float or bfloat16) and f32, rounding to TF32, the warp
// sum, and the one-warp LayerNorm of a row already in shared memory (the
// fused feed-forward block, ffn_addln.cu; rows in device memory take
// layernorm_rows.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace t2l {

// Compute-dtype codes shared with the Python wrappers (ops/_cuda.py).
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's cast
}

// v rounded through the compute dtype and back (the TPU kernels' `.astype`).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// x rounded to TF32 (10 mantissa bits, ties away from zero), as
// cvt.rna.tf32.f32 rounds a finite value, in two integer operations (the
// conversion instruction issues at a fraction of their rate). The f32
// products on TF32 tensor cores split each operand into hi = tf32_rna(x)
// and lo = tf32_rna(x - hi) and sum lo.hi + hi.lo + hi.hi (3xTF32).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LayerNorm of one f32 row of width d by one whole warp (the row in shared
// memory): f32 statistics, biased variance,
// (v - mu) / sqrt(var + eps) * gamma + beta, stored in T.
template <typename T>
__device__ __forceinline__ void warp_layernorm_row(const float* row, int d,
                                                   const float* gamma,
                                                   const float* beta, float eps,
                                                   T* out) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += row[c];
  const float mu = warp_sum(s) / (float)d;
  float q = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = row[c] - mu;
    q += t * t;
  }
  const float var = warp_sum(q) / (float)d;
  const float inv = 1.0f / sqrtf(var + eps);
  for (int c = lane; c < d; c += 32)
    out[c] = from_f<T>((row[c] - mu) * inv * gamma[c] + beta[c]);
}

// Offset of the next 16-byte aligned region in a dynamic shared buffer.
__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

}  // namespace t2l
