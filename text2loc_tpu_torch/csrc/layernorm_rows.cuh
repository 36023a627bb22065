// The last stage of the tiled transformer-block chains (mha_tiled.cu,
// ffn_tiled.cu): out [m, d] in T = LayerNorm(s2 [m, d] f32) * gamma + beta,
// one warp per row (t2l::warp_layernorm_row: f32 statistics, biased
// variance).
#pragma once

#include "common.cuh"

namespace t2l {
namespace rows {

constexpr int kLnWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kLnWarps * 32)
    layernorm_rows_kernel(const float* __restrict__ s2, const float* __restrict__ gamma,
                          const float* __restrict__ beta, float eps, T* __restrict__ out,
                          int m, int d) {
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= m) return;  // whole warps
  warp_layernorm_row<T>(s2 + (size_t)row * d, d, gamma, beta, eps, out + (size_t)row * d);
}

template <typename T>
cudaError_t layernorm(const void* s2, const void* gamma, const void* beta, void* out, int m,
                      int d, float eps, cudaStream_t st) {
  if (m <= 0) return cudaSuccess;
  layernorm_rows_kernel<T><<<(m + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, st>>>(
      static_cast<const float*>(s2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), eps, static_cast<T*>(out), m, d);
  return cudaGetLastError();
}

}  // namespace rows
}  // namespace t2l
