// One PointNet++ set-abstraction level at inference, one block per point
// cloud: a neighbour selection, then one pooling tail. This header holds
// the kernel template; each selection is instantiated in a source of its
// own (sa_select.cu, sa_select_bisect.cu, sa_gather.cu, sa_exact.cu,
// sa_all.cu), so that nvcc builds them in parallel.
//
// Replaces the TPU kernels of text2loc_tpu/ops/pallas_pointconv.py:
//   fused_sa_select :451 (_sa_select_kernel :304), selection "first" and
//     "bisect" (SA modes "first" and "full");
//   fused_sa_gather :242 (_sa_gather_kernel :188): neighbours given as
//     idx/mask (SA mode "gather");
//   fused_set_abstraction :116 (_sa_kernel :38): K masked-argmin rounds
//     (select_k, SA mode "exact") or every in-radius point (SA mode "all").
//
// Per cloud: u[j] for the P points in shared memory, sv = -ctr @ Wp per
// center; d2 = |c|^2 - 2 c.p + |p|^2 clamped at 0; the selection compacts
// each center's neighbours into a list in shared memory; the tail computes
// h1 = relu((u[j] + sv) * a1 + b1) in the compute dtype and
// h2 = relu((h1 @ W2) * a2 + b2) for tiles of 32 listed neighbours and keeps
// a running max (an empty row gives 0). a/b are the folded eval BatchNorm.
// u is feat @ W1 rounded to the compute dtype for first/bisect/gather (the
// TPU kernels round u before their one-hot gather), and x @ Wx + pos @ Wp in
// f32, not rounded, for exact/all (fused_set_abstraction's u).
//
// Selections, one warp per center:
//   first:  the first <= K in-radius points in index order (ballot and
//           popcount prefix);
//   bisect: d2 of P <= 256 points in registers (8 per lane); `iters` rounds
//           of mid = (lo + hi) * 0.5 with count(d2 <= mid) <= K by ballot and
//           popcount; then the TPU kernel's tie expansion (cnt_lo, the next
//           distance by a warp min, thr); then the first <= K points with
//           d2 <= thr in index order;
//   gather: the valid slots of the given idx/mask row;
//   exact:  K rounds of a warp argmin over the in-radius d2 (ties to the
//           lowest index), each taking its point out;
//   all:    every in-radius point in index order (up to P).
//
// What bounds it on the H100: the second layer, one H1 x H2 product per
// selected edge, on the FP32 pipes (about 2e11 multiply-adds over the three
// levels of a 64-cell gallery with K = 32, about four times that in "all"
// mode at SA1), plus the read of W2 (up to 256 x 256) for every center.
// What the design does about it: the TPU kernels compute all S x P pairs or
// build one-hot matrices for the MXU; here only the edges that count are
// computed, from compact lists, so "all" costs its in-radius edges and not
// S x P. u is computed once per cloud and kept in shared memory, so neither
// the [S, K, C] neighbour features nor the [S, P] distances exist in device
// memory; the K rows of h1 of a center sit in shared memory as [H1][32] so
// that one thread per output channel reads four slots per 16-byte broadcast
// load and keeps 32 partial sums in registers. A later PR can move the
// second layer to the tensor cores.
//
// The distance is computed with the _rn intrinsics in the same order as the
// plain PyTorch version (separate tensor ops), and the bisection with
// __fadd_rn / __fmul_rn, so the in-radius sets and the thresholds agree bit
// for bit on boundary points.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxK = 32;      // slots per tile; K <= 32 (torch-cluster's default)
constexpr int kLanePts = 8;    // points per lane in registers: P <= 256
constexpr float kInf = 3.0e38f;

enum Sel : int { kFirst = 0, kBisect = 1, kGather = 2, kExact = 3, kAll = 4 };

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// d2 of point j from a center (cx, cy, cz) with |c|^2 = sc, clamped at 0.
__device__ __forceinline__ float dist2(float sc, float cx, float cy, float cz,
                                       const float* pos_s, int j) {
  const float px = pos_s[3 * j], py = pos_s[3 * j + 1], pz = pos_s[3 * j + 2];
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx, px), __fmul_rn(cy, py)),
                                __fmul_rn(cz, pz));
  const float d2 = __fadd_rn(__fsub_rn(sc, __fmul_rn(2.0f, cross)), sq_norm(px, py, pz));
  return fmaxf(d2, 0.0f);
}

__device__ __forceinline__ int warp_count_le(const float (&d)[kLanePts], float t) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < kLanePts; ++i) n += __popc(__ballot_sync(0xffffffffu, d[i] <= t));
  return n;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Appends the points i * 32 + lane with take[i] set to `list`, in index
// order, keeping at most `cap`; returns the number of points taken.
__device__ __forceinline__ int warp_compact(const bool (&take)[kLanePts], int* list,
                                            int cap, int lane) {
  const unsigned lt_mask = (1u << lane) - 1u;
  int count = 0;
#pragma unroll
  for (int i = 0; i < kLanePts; ++i) {
    const unsigned ball = __ballot_sync(0xffffffffu, take[i]);
    const int rank = count + __popc(ball & lt_mask);
    if (take[i] && rank < cap) list[rank] = i * 32 + lane;
    count += __popc(ball);
  }
  return count < cap ? count : cap;
}

template <typename T, int SEL>
__global__ void sa_level_kernel(
    const T* __restrict__ feat, const float* __restrict__ pos,
    const float* __restrict__ ctr, const int* __restrict__ nidx,
    const unsigned char* __restrict__ nmask, const T* __restrict__ w1,
    const T* __restrict__ wp, const float* __restrict__ ab1,
    const T* __restrict__ w2, const float* __restrict__ ab2, T* __restrict__ out,
    int p, int s, int c, int h1, int h2, int k, int g_per, int cap, float r2,
    int iters) {
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
  int* nbr_s = reinterpret_cast<int*>(smem_raw + off);  // [g][cap]
  off = t2l::align16(off + sizeof(int) * (size_t)g_per * cap);
  int* cnt_s = reinterpret_cast<int*>(smem_raw + off);  // [g]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* feat_n = feat + (size_t)n * p * c;
  const float* ctr_n = ctr + (size_t)n * s * 3;

  if constexpr (SEL != kGather) {
    const float* pos_n = pos + (size_t)n * p * 3;
    for (int i = tid; i < p * 3; i += nthreads) pos_s[i] = pos_n[i];
  }
  if constexpr (SEL == kExact || SEL == kAll) {
    __syncthreads();
    // u[j] = x[j] @ Wx + pos[j] @ Wp in f32, not rounded.
    for (int i = tid; i < p * h1; i += nthreads) {
      const int j = i / h1, cc = i - j * h1;
      const T* fr = feat_n + (size_t)j * c;
      float acc = 0.f;
      for (int ci = 0; ci < c; ++ci) acc += t2l::to_f(fr[ci]) * t2l::to_f(w1[(size_t)ci * h1 + cc]);
      const float accp = pos_s[3 * j] * t2l::to_f(wp[cc]) +
                         pos_s[3 * j + 1] * t2l::to_f(wp[h1 + cc]) +
                         pos_s[3 * j + 2] * t2l::to_f(wp[2 * h1 + cc]);
      u_s[i] = acc + accp;
    }
  } else {
    // Hoisted first layer: u[j] = feat[j] @ W1, rounded to the compute dtype.
    for (int i = tid; i < p * h1; i += nthreads) {
      const int j = i / h1, cc = i - j * h1;
      const T* fr = feat_n + (size_t)j * c;
      float acc = 0.f;
      for (int ci = 0; ci < c; ++ci) acc += t2l::to_f(fr[ci]) * t2l::to_f(w1[(size_t)ci * h1 + cc]);
      u_s[i] = t2l::round_to<T>(acc);
    }
  }
  __syncthreads();

  const int g_thr = tid / h2;  // center of the group this thread pools
  const int c2 = tid - g_thr * h2;
  const float a2 = ab2[c2], b2 = ab2[h2 + c2];
  const unsigned lt_mask = (1u << lane) - 1u;

  for (int s0 = 0; s0 < s; s0 += g_per) {
    // 1. Selection: warp g takes center s0 + g.
    if (warp < g_per) {
      const int si = s0 + warp;
      int* list = nbr_s + warp * cap;
      int count = 0;
      if (si < s) {
        const float cx = ctr_n[3 * si], cy = ctr_n[3 * si + 1], cz = ctr_n[3 * si + 2];
        const float sc = sq_norm(cx, cy, cz);
        if constexpr (SEL == kFirst) {
          for (int base = 0; base < p && count < k; base += 32) {
            const int j = base + lane;
            const bool in = j < p && dist2(sc, cx, cy, cz, pos_s, j) <= r2;
            const unsigned ball = __ballot_sync(0xffffffffu, in);
            const int rank = count + __popc(ball & lt_mask);
            if (in && rank < k) list[rank] = j;
            count += __popc(ball);
          }
          count = count < k ? count : k;
        } else if constexpr (SEL == kGather) {
          const size_t row = ((size_t)n * s + si) * k;
          const bool valid = lane < k && nmask[row + lane] != 0;
          const unsigned ball = __ballot_sync(0xffffffffu, valid);
          if (valid) list[__popc(ball & lt_mask)] = nidx[row + lane];
          count = __popc(ball);
        } else {
          // In-radius d2 of this lane's points; kInf elsewhere.
          float d[kLanePts];
#pragma unroll
          for (int i = 0; i < kLanePts; ++i) {
            const int j = i * 32 + lane;
            float v = kInf;
            if (j < p) {
              const float dd = dist2(sc, cx, cy, cz, pos_s, j);
              if (dd <= r2) v = dd;
            }
            d[i] = v;
          }
          bool take[kLanePts];
          if constexpr (SEL == kBisect) {
            float lo = 0.f, hi = r2;
            for (int it = 0; it < iters; ++it) {
              const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
              if (warp_count_le(d, mid) <= k) lo = mid; else hi = mid;
            }
            float nx = kInf;
#pragma unroll
            for (int i = 0; i < kLanePts; ++i)
              if (d[i] > lo && d[i] < kInf) nx = fminf(nx, d[i]);
            nx = warp_min(nx);
            const float thr = warp_count_le(d, r2) <= k ? r2
                              : (warp_count_le(d, lo) < k ? nx : lo);
#pragma unroll
            for (int i = 0; i < kLanePts; ++i) take[i] = d[i] <= thr;
            count = warp_compact(take, list, k, lane);
          } else if constexpr (SEL == kAll) {
#pragma unroll
            for (int i = 0; i < kLanePts; ++i) take[i] = d[i] < kInf;
            count = warp_compact(take, list, cap, lane);
          } else {  // kExact
            for (int r = 0; r < k; ++r) {
              float bv = kInf;
              int bj = 0x7fffffff;
#pragma unroll
              for (int i = 0; i < kLanePts; ++i)
                if (d[i] < bv) { bv = d[i]; bj = i * 32 + lane; }
#pragma unroll
              for (int o = 16; o > 0; o >>= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
                const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
                if (ov < bv || (ov == bv && oj < bj)) { bv = ov; bj = oj; }
              }
              if (!(bv < kInf)) break;
              if (lane == 0) list[count] = bj;
              ++count;
              if ((bj & 31) == lane) {
#pragma unroll
                for (int i = 0; i < kLanePts; ++i)
                  if (i == (bj >> 5)) d[i] = kInf;
              }
            }
          }
        }
      }
      if (lane == 0) cnt_s[warp] = count;
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

    int most = 0;
    for (int g = 0; g < g_per; ++g) most = cnt_s[g] > most ? cnt_s[g] : most;
    const int tiles = most > kMaxK ? (most + kMaxK - 1) / kMaxK : 1;
    const int si = s0 + g_thr;
    const int nv = cnt_s[g_thr];
    float best = -1.0e30f;
    for (int t = 0; t < tiles; ++t) {
      // 2. Edge hidden: h1[g][cc][kk] = relu((u[nbr] + sv) * a1 + b1) in T.
      for (int i = tid; i < g_per * h1 * kMaxK; i += nthreads) {
        const int kk = i % kMaxK;
        const int gc = i / kMaxK;  // g * h1 + cc
        const int g = gc / h1, cc = gc - g * h1;
        const int slot = t * kMaxK + kk;
        float v = 0.f;
        if (slot < cnt_s[g]) {
          const int j = nbr_s[g * cap + slot];
          v = u_s[j * h1 + cc] + sv_s[gc];
          v = fmaxf(v * ab1[cc] + ab1[h1 + cc], 0.0f);
          v = t2l::round_to<T>(v);
        }
        h1_s[i] = v;
      }
      __syncthreads();

      // 3. Second layer + folded BN + ReLU, running max over the valid slots.
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
#pragma unroll
        for (int kk = 0; kk < kMaxK; ++kk) {
          const float hv = fmaxf(acc[kk] * a2 + b2, 0.0f);
          if (t * kMaxK + kk < nv) best = fmaxf(best, hv);
        }
      }
      __syncthreads();
    }
    if (g_thr < g_per && si < s)
      out[((size_t)n * s + si) * h2 + c2] = t2l::from_f<T>(nv > 0 ? best : 0.0f);
  }
}

template <typename T, int SEL>
int launch(const void* feat, const void* pos, const void* ctr, const void* nidx,
           const void* nmask, const void* w1, const void* wp, const void* ab1,
           const void* w2, const void* ab2, void* out, int n, int p, int s, int c,
           int h1, int h2, int k, float r2, int iters, int g_per, int cap, size_t smem,
           cudaStream_t stream) {
  auto kern = sa_level_kernel<T, SEL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<n, g_per * h2, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(pos),
      static_cast<const float*>(ctr), static_cast<const int*>(nidx),
      static_cast<const unsigned char*>(nmask), static_cast<const T*>(w1),
      static_cast<const T*>(wp), static_cast<const float*>(ab1),
      static_cast<const T*>(w2), static_cast<const float*>(ab2),
      static_cast<T*>(out), p, s, c, h1, h2, k, g_per, cap, r2, iters);
  return (int)cudaGetLastError();
}

// Dynamic shared memory the kernel needs for one cloud. cap: neighbour-list
// slots per center (K, or P for "all").
inline size_t sa_level_smem(int p, int h1, int g_per, int cap) {
  size_t off = 0;
  off = t2l::align16(off + sizeof(float) * (size_t)p * h1);
  off = t2l::align16(off + sizeof(float) * (size_t)p * 3);
  off = t2l::align16(off + sizeof(float) * (size_t)g_per * h1);
  off = t2l::align16(off + sizeof(float) * (size_t)g_per * h1 * kMaxK);
  off = t2l::align16(off + sizeof(int) * (size_t)g_per * cap);
  return off + sizeof(int) * (size_t)g_per;
}

}  // namespace

// The C entry point of one selection SEL, `t2l_sa_level_<name>`:
// feat [n,p,c] T (concat(x, pos) for first/bisect/gather with w1 [c,h1]; x
// for exact/all with w1 = Wx [c,h1]); pos [n,p,3] f32 (unused by gather);
// ctr [n,s,3] f32; nidx [n,s,k] int32 and nmask [n,s,k] bool (gather only);
// wp [3,h1] T; ab1 [2,h1] f32; w2 [h1,h2] T; ab2 [2,h2] f32 -> out [n,s,h2] T.
// r2: the squared radius as the caller rounds it to f32; iters: bisection
// rounds; cap: neighbour-list slots per center. Threads per block:
// g_per * h2 (a multiple of 32). Returns cudaGetLastError() after the launch.
#define T2L_SA_LEVEL_ENTRY(NAME, SEL)                                                  \
  extern "C" int t2l_sa_level_##NAME(                                                  \
      const void* feat, const void* pos, const void* ctr, const void* nidx,            \
      const void* nmask, const void* w1, const void* wp, const void* ab1,              \
      const void* w2, const void* ab2, void* out, int n, int p, int s, int c, int h1,  \
      int h2, int k, float r2, int iters, int g_per, int cap, int dtype,               \
      void* stream) {                                                                  \
    const size_t smem = sa_level_smem(p, h1, g_per, cap);                              \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                               \
    if (dtype == t2l::kBF16)                                                           \
      return launch<__nv_bfloat16, SEL>(feat, pos, ctr, nidx, nmask, w1, wp, ab1, w2,  \
                                        ab2, out, n, p, s, c, h1, h2, k, r2, iters,    \
                                        g_per, cap, smem, st);                         \
    return launch<float, SEL>(feat, pos, ctr, nidx, nmask, w1, wp, ab1, w2, ab2, out,  \
                              n, p, s, c, h1, h2, k, r2, iters, g_per, cap, smem, st); \
  }
