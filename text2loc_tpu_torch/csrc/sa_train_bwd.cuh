// Backward passes of the training set-abstraction level (the design note
// is in sa_train_bwd.cu), each templated on ROUND_E: false takes e as
// recomputed from u and sv (sa_train_bwd.cu), true rounds it to bf16 as the
// forward did, the token "e" (sa_train_e_bwd.cu).
#pragma once

#include "sa_train_common.cuh"

namespace {

using namespace t2l::sa;

template <typename T, int CW, bool ROUND_E>
__global__ void __launch_bounds__(kThreads, CW <= 4 ? 2 : 1)
    sa_bwd_stats_kernel(Args a, float* part) {
  const Smem sm = carve(a, 0);
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = a.h2 / 32;
  const float* m2 = a.aux2 + kMean * a.h2;
  const float* inv2 = a.aux2 + kInv * a.h2;
  float suma[CW], sumb[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) suma[j] = sumb[j] = 0.f;
  for (int n = blockIdx.x; n < a.n; n += gridDim.x) {
    for (int s0 = 0; s0 < a.s;) {
      const int taken =
          load_tile<T, ROUND_E>(a, n, s0, sm.rw, sm.cs, sm.es, sm.hs);
      float z[kMaxRpt][CW], dy[kMaxRpt][CW];
      tile_dy2<T>(a, n, sm.rw, sm.cs, sm.hs, sm.ys, sm.mx, sm.cnt, z, dy);
#pragma unroll
      for (int i = 0; i < kMaxRpt; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j)
          if (i < a.rpt && j < cw && sm.rw.ok[g * a.rpt + i]) {
            const int c = lane + 32 * j;
            suma[j] += dy[i][j];
            sumb[j] += dy[i][j] * ((z[i][j] - m2[c]) * inv2[c]);
          }
      s0 += taken;
      __syncthreads();  // the next tile overwrites the row data
    }
  }
  float* out = part + (size_t)blockIdx.x * 2 * a.h2;
  block_column_sums(suma, a.h2, sm.red, out);
  block_column_sums(sumb, a.h2, sm.red, out + a.h2);
}

// dW2 partial += round(h1)^T round(dz) over the tile's real rows. Warp g
// owns rows ib + 8g .. ib + 8g + 7 of dW2 for ib = 0, 64, ..., lane l the
// columns l + 32 j.
template <int CW>
__device__ __forceinline__ void tile_dw2(const Args& a, const Rows& rw, const float* hs,
                                         const float* ys, float* pw, bool zero) {
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = a.h2 / 32;
  const int rows = tile_rows(a);
  for (int ib = 0; ib < a.h1; ib += 64) {
    const int i0 = ib + 8 * g;
    if (i0 >= a.h1) continue;
    float acc[8][CW];
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[ii][j] = 0.f;
    if (!zero) {
      for (int r = 0; r < rows; ++r) {
        if (!rw.ok[r]) continue;
        const float4 ha = *reinterpret_cast<const float4*>(hs + (size_t)r * a.h1 + i0);
        const float4 hb = *reinterpret_cast<const float4*>(hs + (size_t)r * a.h1 + i0 + 4);
        const float hv[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          if (j < cw) {
            const float d = ys[(size_t)r * a.h2 + lane + 32 * j];
#pragma unroll
            for (int ii = 0; ii < 8; ++ii) acc[ii][j] = fmaf(hv[ii], d, acc[ii][j]);
          }
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
#pragma unroll
      for (int j = 0; j < CW; ++j)
        if (j < cw) {
          float* w = pw + (size_t)(i0 + ii) * a.h2 + lane + 32 * j;
          *w = zero ? 0.f : *w + acc[ii][j];
        }
  }
}

template <typename T, int CW, bool ROUND_E>
__global__ void __launch_bounds__(kThreads, CW <= 4 ? 2 : 1)
    sa_bwd_mid_kernel(Args a, float* part_a1, float* part_w, float* part_b) {
  const Smem sm = carve(a, 0);
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw1 = a.h1 / 32;
  float* pw = part_w + (size_t)blockIdx.x * a.h1 * a.h2;
  tile_dw2<CW>(a, sm.rw, sm.hs, sm.ys, pw, true);
  float suma[CW], sumb[CW], db2[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) suma[j] = sumb[j] = db2[j] = 0.f;
  for (int n = blockIdx.x; n < a.n; n += gridDim.x) {
    for (int s0 = 0; s0 < a.s;) {
      const int taken =
          load_tile<T, ROUND_E>(a, n, s0, sm.rw, sm.cs, sm.es, sm.hs);
      float acc[kMaxRpt][CW], d[kMaxRpt][CW];
      tile_dy2<T>(a, n, sm.rw, sm.cs, sm.hs, sm.ys, sm.mx, sm.cnt, acc, d);
      tile_dz<T>(a, sm.rw, acc, d, sm.ys, db2);
      tile_dy1<T>(a, sm.rw, sm.es, sm.ys, acc);  // acc := dy1
#pragma unroll
      for (int i = 0; i < kMaxRpt; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j)
          if (i < a.rpt && j < cw1 && sm.rw.ok[g * a.rpt + i]) {
            const int r = g * a.rpt + i, c = lane + 32 * j;
            suma[j] += acc[i][j];
            sumb[j] += acc[i][j] * yhat1_of(a, sm.es, r, c);
          }
      tile_dw2<CW>(a, sm.rw, sm.hs, sm.ys, pw, false);
      s0 += taken;
      __syncthreads();  // the next tile overwrites es / hs / ys
    }
  }
  float* out = part_a1 + (size_t)blockIdx.x * 2 * a.h1;
  block_column_sums(suma, a.h1, sm.red, out);
  block_column_sums(sumb, a.h1, sm.red, out + a.h1);
  block_column_sums(db2, a.h2, sm.red, part_b + (size_t)blockIdx.x * a.h2);
}

template <typename T, int CW, bool ROUND_E>
__global__ void __launch_bounds__(kThreads, CW <= 4 ? 2 : 1)
    sa_bwd_in_kernel(Args a, float* du, float* dsv) {
  const Smem sm = carve(a, 1);
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw1 = a.h1 / 32;
  const int rows = tile_rows(a);
  const float* x1 = a.aux1;
  for (int n = blockIdx.x; n < a.n; n += gridDim.x) {
    for (int i = threadIdx.x; i < a.p * a.h1; i += kThreads) sm.du[i] = 0.f;
    __syncthreads();
    for (int s0 = 0; s0 < a.s;) {
      const int taken =
          load_tile<T, ROUND_E>(a, n, s0, sm.rw, sm.cs, sm.es, sm.hs);
      float acc[kMaxRpt][CW], d[kMaxRpt][CW];
      tile_dy2<T>(a, n, sm.rw, sm.cs, sm.hs, sm.ys, sm.mx, sm.cnt, acc, d);
      float unused[CW] = {};
      tile_dz<T>(a, sm.rw, acc, d, sm.ys, unused);
      tile_dy1<T>(a, sm.rw, sm.es, sm.ys, acc);  // acc := dy1
      // de in place of e: each thread reads and writes only its own elements.
#pragma unroll
      for (int i = 0; i < kMaxRpt; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j)
          if (i < a.rpt && j < cw1) {
            const int r = g * a.rpt + i, c = lane + 32 * j;
            float de = 0.f;
            if (sm.rw.ok[r]) {
              const float corr =
                  x1[kCorrA * a.h1 + c] + yhat1_of(a, sm.es, r, c) * x1[kCorrB * a.h1 + c];
              de = x1[kA * a.h1 + c] * (acc[i][j] - sm.rw.mf[r] * corr);
            }
            sm.es[(size_t)r * a.h1 + c] = de;
          }
      __syncthreads();
      if (threadIdx.x < a.h1) {
        const int c = threadIdx.x;
        for (int r = 0; r < rows; ++r)
          if (sm.rw.ok[r])
            sm.du[(size_t)sm.rw.idx[r] * a.h1 + c] +=
                t2l::round_to<T>(sm.es[(size_t)r * a.h1 + c]);
      }
      for (int q = threadIdx.x; q < taken * a.h1; q += kThreads) {
        const int t = q / a.h1, c = q - t * a.h1;
        const int r0 = sm.cs.start[t], r1 = r0 + sm.cs.count[t];
        float sum = 0.f;
        for (int r = r0; r < r1; ++r) sum += sm.es[(size_t)r * a.h1 + c];
        dsv[((size_t)n * a.s + sm.cs.sid[t]) * a.h1 + c] = -sum;
      }
      s0 += taken;
      __syncthreads();
    }
    for (int i = threadIdx.x; i < a.p * a.h1; i += kThreads)
      du[(size_t)n * a.p * a.h1 + i] = sm.du[i];
    __syncthreads();
  }
}

template <typename T, int CW, bool ROUND_E>
int backward_pass_cw(int pass, const Args& a, float* o0, float* o1, float* o2, int blocks,
                     size_t smem, cudaStream_t st) {
  switch (pass) {
    case 1: return launch_pass(sa_bwd_stats_kernel<T, CW, ROUND_E>, blocks, smem, st, a, o0);
    case 2: return launch_pass(sa_bwd_mid_kernel<T, CW, ROUND_E>, blocks, smem, st, a, o0, o1, o2);
    case 3: return launch_pass(sa_bwd_in_kernel<T, CW, ROUND_E>, blocks, smem, st, a, o0, o1);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool ROUND_E>
int backward_pass(int pass, const Args& a, void* out0, void* out1, void* out2, int blocks,
                  size_t smem, cudaStream_t st) {
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  float* o2 = static_cast<float*>(out2);
  const int cw = (a.h1 > a.h2 ? a.h1 : a.h2) / 32;
  if (cw <= 2) return backward_pass_cw<T, 2, ROUND_E>(pass, a, o0, o1, o2, blocks, smem, st);
  if (cw <= 4) return backward_pass_cw<T, 4, ROUND_E>(pass, a, o0, o1, o2, blocks, smem, st);
  return backward_pass_cw<T, 8, ROUND_E>(pass, a, o0, o1, o2, blocks, smem, st);
}

}  // namespace
