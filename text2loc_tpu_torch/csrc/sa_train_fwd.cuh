// Training forward passes of one PointConv set-abstraction level with
// batch-statistic BatchNorm (the design note is in sa_train_fwd.cu): the
// BN1 statistics pass, the BN2 statistics pass (one kernel templated on the
// layer) and the output pass, each templated on ROUND_E: false takes e as
// recomputed (sa_train_fwd.cu), true rounds it to bf16 in every pass, the
// token "e" (sa_train_e_fwd.cu).
#pragma once

#include "sa_train_common.cuh"

namespace {

using namespace t2l::sa;

template <typename T, int LAYER, int CW, bool ROUND_E>
__global__ void __launch_bounds__(kThreads, CW <= 4 ? 2 : 1)
    sa_stats_kernel(Args a, float* part) {
  const Smem sm = carve(a, 0);
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = LAYER == 1 ? a.h1 : a.h2;
  const int cw = h / 32;
  float sum[CW], sq[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) sum[j] = sq[j] = 0.f;
  for (int n = blockIdx.x; n < a.n; n += gridDim.x) {
    for (int s0 = 0; s0 < a.s;) {
      const int taken = load_tile<T, ROUND_E>(a, n, s0, sm.rw, sm.cs, sm.es,
                                              LAYER == 2 ? sm.hs : nullptr);
      float z[kMaxRpt][CW];
      if (LAYER == 2) tile_z<T>(a, sm.hs, z);
#pragma unroll
      for (int i = 0; i < kMaxRpt; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j)
          if (i < a.rpt && j < cw) {
            const int r = g * a.rpt + i, c = lane + 32 * j;
            if (sm.rw.mf[r] > 0.f) {
              const float v = LAYER == 1 ? sm.es[(size_t)r * a.h1 + c] : z[i][j];
              sum[j] += v;
              sq[j] += v * v;
            }
          }
      s0 += taken;
      __syncthreads();  // the next tile overwrites es / hs
    }
  }
  float* out = part + (size_t)blockIdx.x * 2 * h;
  block_column_sums(sum, h, sm.red, out);
  block_column_sums(sq, h, sm.red, out + h);
}

template <typename T, int CW, bool ROUND_E>
__global__ void __launch_bounds__(kThreads, CW <= 4 ? 2 : 1)
    sa_out_kernel(Args a, float* out) {
  const Smem sm = carve(a, 0);
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = a.h2 / 32;
  const float* a2 = a.aux2 + kA * a.h2;
  const float* c2 = a.aux2 + kC * a.h2;
  for (int n = blockIdx.x; n < a.n; n += gridDim.x) {
    for (int s0 = 0; s0 < a.s;) {
      const int taken =
          load_tile<T, ROUND_E>(a, n, s0, sm.rw, sm.cs, sm.es, sm.hs);
      float z[kMaxRpt][CW];
      tile_z<T>(a, sm.hs, z);
#pragma unroll
      for (int i = 0; i < kMaxRpt; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j)
          if (i < a.rpt && j < cw) {
            const int r = g * a.rpt + i, c = lane + 32 * j;
            const float y = fmaf(z[i][j], a2[c], c2[c]);
            sm.ys[(size_t)r * a.h2 + c] = sm.rw.mm[r] > 0.f ? fmaxf(y, 0.f) : kNeg;
          }
      __syncthreads();
      tile_pool(a, sm.rw, sm.cs, sm.ys, sm.mx, sm.cnt, sm.any);
      for (int q = threadIdx.x; q < taken * a.h2; q += kThreads) {
        const int t = q / a.h2, c = q - t * a.h2;
        out[((size_t)n * a.s + sm.cs.sid[t]) * a.h2 + c] = sm.any[q] > 0.f ? sm.mx[q] : 0.f;
      }
      s0 += taken;
      __syncthreads();
    }
  }
}

template <typename T, int CW, bool ROUND_E>
int forward_pass_cw(int pass, const Args& a, void* out0, int blocks, size_t smem,
                    cudaStream_t st) {
  float* o = static_cast<float*>(out0);
  switch (pass) {
    case 1: return launch_pass(sa_stats_kernel<T, 1, CW, ROUND_E>, blocks, smem, st, a, o);
    case 2: return launch_pass(sa_stats_kernel<T, 2, CW, ROUND_E>, blocks, smem, st, a, o);
    case 3: return launch_pass(sa_out_kernel<T, CW, ROUND_E>, blocks, smem, st, a, o);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool ROUND_E>
int forward_pass(int pass, const Args& a, void* out0, int blocks, size_t smem,
                 cudaStream_t st) {
  const int cw = (a.h1 > a.h2 ? a.h1 : a.h2) / 32;
  if (cw <= 2) return forward_pass_cw<T, 2, ROUND_E>(pass, a, out0, blocks, smem, st);
  if (cw <= 4) return forward_pass_cw<T, 4, ROUND_E>(pass, a, out0, blocks, smem, st);
  return forward_pass_cw<T, 8, ROUND_E>(pass, a, out0, blocks, smem, st);
}

}  // namespace
