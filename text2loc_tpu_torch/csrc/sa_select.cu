// One PointNet++ set-abstraction level with in-kernel "first" neighbour
// selection, one block per point cloud.
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_pointconv.py
// (_sa_select_kernel :304 / fused_sa_select :451, selection="first").
//
// Per cloud: u = feat @ W1 for the P points (f32 sums, then rounded to the
// compute dtype, as the TPU kernel rounds u before its one-hot gather) and
// sv = -ctr @ Wp per center; d2 = |c|^2 - 2 c.p + |p|^2 clamped at 0; the
// first <= K in-radius points in index order; h1 = relu((u[j] + sv) * a1 + b1)
// in the compute dtype; h2 = relu((h1 @ W2) * a2 + b2); the max over the
// selected slots (an empty row gives 0). a/b are the folded eval BatchNorm.
//
// What bounds it on the H100: the second layer, S * K * H1 * H2
// multiply-adds per cloud (about 2e11 over the three levels of a 64-cell
// gallery), plus the read of W2 (up to 256 x 256) for every center.
// What the design does about it: u is computed once per cloud and kept in
// shared memory, so neither the [S, K, C] neighbour features nor the
// [S, P] distances ever exist in device memory; the selection is a warp
// ballot with a popcount prefix (no sort, no top-k); the K rows of h1 for a
// center sit in shared memory as [H1][K] so that one thread per output
// channel reads four slots per 16-byte broadcast load and keeps the K
// partial sums in registers. W2 is read through L1/L2 (one coalesced row
// per step for the whole block). The products run on the FP32 pipes, not on
// the tensor cores: a later PR can move this layer to wgmma.
//
// The distance is computed with the _rn intrinsics in the same order as the
// plain PyTorch version (separate tensor ops), so the in-radius sets agree
// bit for bit on boundary points.
#include "common.cuh"

namespace {

constexpr int kMaxK = 32;  // slot stride; K <= 32 (torch-cluster's default)

template <typename T>
__global__ void sa_select_first_kernel(
    const T* __restrict__ feat, const float* __restrict__ pos,
    const float* __restrict__ ctr, const T* __restrict__ w1,
    const T* __restrict__ wp, const float* __restrict__ ab1,
    const T* __restrict__ w2, const float* __restrict__ ab2, T* __restrict__ out,
    int p, int s, int c, int h1, int h2, int k, int g_per, float r2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  size_t off = 0;
  float* u_s = reinterpret_cast<float*>(smem_raw + off);
  off = t2l::align16(off + sizeof(float) * (size_t)p * h1);
  float* pos_s = reinterpret_cast<float*>(smem_raw + off);
  off = t2l::align16(off + sizeof(float) * (size_t)p * 3);
  float* sv_s = reinterpret_cast<float*>(smem_raw + off);
  off = t2l::align16(off + sizeof(float) * (size_t)g_per * h1);
  float* h1_s = reinterpret_cast<float*>(smem_raw + off);  // [g][h1][kMaxK]
  off = t2l::align16(off + sizeof(float) * (size_t)g_per * h1 * kMaxK);
  int* nbr_s = reinterpret_cast<int*>(smem_raw + off);  // [g][kMaxK]
  off = t2l::align16(off + sizeof(int) * (size_t)g_per * kMaxK);
  int* cnt_s = reinterpret_cast<int*>(smem_raw + off);  // [g]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* feat_n = feat + (size_t)n * p * c;
  const float* pos_n = pos + (size_t)n * p * 3;
  const float* ctr_n = ctr + (size_t)n * s * 3;

  for (int i = tid; i < p * 3; i += nthreads) pos_s[i] = pos_n[i];
  // Hoisted first layer: u[j] = feat[j] @ W1, rounded to the compute dtype.
  for (int i = tid; i < p * h1; i += nthreads) {
    const int j = i / h1, cc = i - j * h1;
    const T* fr = feat_n + (size_t)j * c;
    float acc = 0.f;
    for (int ci = 0; ci < c; ++ci) acc += t2l::to_f(fr[ci]) * t2l::to_f(w1[(size_t)ci * h1 + cc]);
    u_s[i] = t2l::round_to<T>(acc);
  }
  __syncthreads();

  const int g_thr = tid / h2;  // center of the group this thread pools
  const int c2 = tid - g_thr * h2;
  const float a2 = ab2[c2], b2 = ab2[h2 + c2];
  const unsigned lt_mask = (1u << lane) - 1u;

  for (int s0 = 0; s0 < s; s0 += g_per) {
    // 1. Selection: warp g takes center s0 + g, the first K in-radius points.
    if (warp < g_per) {
      const int si = s0 + warp;
      int count = 0;
      if (si < s) {
        const float cx = ctr_n[3 * si], cy = ctr_n[3 * si + 1], cz = ctr_n[3 * si + 2];
        const float sc = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)),
                                   __fmul_rn(cz, cz));
        for (int base = 0; base < p && count < k; base += 32) {
          const int j = base + lane;
          bool in = false;
          if (j < p) {
            const float px = pos_s[3 * j], py = pos_s[3 * j + 1], pz = pos_s[3 * j + 2];
            const float sp = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                                       __fmul_rn(pz, pz));
            const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx, px), __fmul_rn(cy, py)),
                                          __fmul_rn(cz, pz));
            float d2 = __fadd_rn(__fsub_rn(sc, __fmul_rn(2.0f, cross)), sp);
            d2 = fmaxf(d2, 0.0f);
            in = d2 <= r2;
          }
          const unsigned ball = __ballot_sync(0xffffffffu, in);
          const int rank = count + __popc(ball & lt_mask);
          if (in && rank < k) nbr_s[warp * kMaxK + rank] = j;
          count += __popc(ball);
        }
      }
      if (lane == 0) cnt_s[warp] = count < k ? count : k;
    }
    // Center term sv = -ctr @ Wp (f32).
    for (int i = tid; i < g_per * h1; i += nthreads) {
      const int g = i / h1, cc = i - g * h1;
      const int si = s0 + g;
      float v = 0.f;
      if (si < s) {
        v = -(ctr_n[3 * si] * t2l::to_f(wp[cc]) +
              ctr_n[3 * si + 1] * t2l::to_f(wp[h1 + cc]) +
              ctr_n[3 * si + 2] * t2l::to_f(wp[2 * h1 + cc]));
      }
      sv_s[i] = v;
    }
    __syncthreads();

    // 2. Edge hidden: h1[g][cc][kk] = relu((u[nbr] + sv) * a1 + b1) in T.
    for (int i = tid; i < g_per * h1 * kMaxK; i += nthreads) {
      const int kk = i % kMaxK;
      const int gc = i / kMaxK;  // g * h1 + cc
      const int g = gc / h1, cc = gc - g * h1;
      float v = 0.f;
      if (kk < cnt_s[g]) {
        const int j = nbr_s[g * kMaxK + kk];
        v = u_s[j * h1 + cc] + sv_s[gc];
        v = fmaxf(v * ab1[cc] + ab1[h1 + cc], 0.0f);
        v = t2l::round_to<T>(v);
      }
      h1_s[i] = v;
    }
    __syncthreads();

    // 3. Second layer + folded BN + ReLU, max over the valid slots.
    const int si = s0 + g_thr;
    if (g_thr < g_per && si < s) {
      float acc[kMaxK];
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) acc[kk] = 0.f;
      const float4* hrow = reinterpret_cast<const float4*>(h1_s + (size_t)g_thr * h1 * kMaxK);
      for (int cc = 0; cc < h1; ++cc) {
        const float w = t2l::to_f(w2[(size_t)cc * h2 + c2]);
#pragma unroll
        for (int q = 0; q < kMaxK / 4; ++q) {
          const float4 hv = hrow[cc * (kMaxK / 4) + q];
          acc[4 * q] += hv.x * w;
          acc[4 * q + 1] += hv.y * w;
          acc[4 * q + 2] += hv.z * w;
          acc[4 * q + 3] += hv.w * w;
        }
      }
      const int nv = cnt_s[g_thr];
      float best = -1.0e30f;
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        const float hv = fmaxf(acc[kk] * a2 + b2, 0.0f);
        if (kk < nv) best = fmaxf(best, hv);
      }
      out[((size_t)n * s + si) * h2 + c2] = t2l::from_f<T>(nv > 0 ? best : 0.0f);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* feat, const void* pos, const void* ctr, const void* w1,
           const void* wp, const void* ab1, const void* w2, const void* ab2, void* out,
           int n, int p, int s, int c, int h1, int h2, int k, float r2,
           int threads, int g_per, size_t smem, cudaStream_t stream) {
  auto kern = sa_select_first_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<n, threads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(pos),
      static_cast<const float*>(ctr), static_cast<const T*>(w1),
      static_cast<const T*>(wp), static_cast<const float*>(ab1),
      static_cast<const T*>(w2), static_cast<const float*>(ab2),
      static_cast<T*>(out), p, s, c, h1, h2, k, g_per, r2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for one cloud (the wrapper checks
// it against the card's limit before launching).
size_t t2l_sa_select_smem(int p, int h1, int g_per) {
  size_t off = 0;
  off = t2l::align16(off + sizeof(float) * (size_t)p * h1);
  off = t2l::align16(off + sizeof(float) * (size_t)p * 3);
  off = t2l::align16(off + sizeof(float) * (size_t)g_per * h1);
  off = t2l::align16(off + sizeof(float) * (size_t)g_per * h1 * kMaxK);
  off = t2l::align16(off + sizeof(int) * (size_t)g_per * kMaxK);
  return off + sizeof(int) * (size_t)g_per;
}

// feat [n,p,c] T, pos [n,p,3] f32, ctr [n,s,3] f32, w1 [c,h1] T, wp [3,h1] T,
// ab1 [2,h1] f32, w2 [h1,h2] T, ab2 [2,h2] f32 -> out [n,s,h2] T. r2 is the
// squared radius as the caller rounds it to f32.
// threads = g_per * h2 (a multiple of 32).
int t2l_sa_select_first(const void* feat, const void* pos, const void* ctr,
                        const void* w1, const void* wp, const void* ab1,
                        const void* w2, const void* ab2, void* out, int n, int p,
                        int s, int c, int h1, int h2, int k, float r2,
                        int g_per, int dtype, void* stream) {
  const int threads = g_per * h2;
  const size_t smem = t2l_sa_select_smem(p, h1, g_per);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return launch<__nv_bfloat16>(feat, pos, ctr, w1, wp, ab1, w2, ab2, out, n, p, s,
                                 c, h1, h2, k, r2, threads, g_per, smem, st);
  return launch<float>(feat, pos, ctr, w1, wp, ab1, w2, ab2, out, n, p, s, c, h1,
                       h2, k, r2, threads, g_per, smem, st);
}

}  // extern "C"
