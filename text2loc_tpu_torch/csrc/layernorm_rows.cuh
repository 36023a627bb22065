// The port's row LayerNorm over device memory:
//   out [m, d] in T = LayerNorm(row) * gamma + beta,
// with f32 statistics in two passes (the mean, then the mean of squared
// deviations: the biased variance), rsqrt, the affine, and the store in T.
// A loader gives the f32 row: x + res in T, summed in f32 (add_ln.cu, the
// add+LayerNorm block), or the f32 pre-norm sums s2 of the tiled chains'
// last stage (mha_tiled.cu, ffn_tiled.cu).
//
// What bounds it on the H100: bytes. A row is read once and written once
// for about ten FLOPs an element (at the intra stack's 25,344 rows of
// D = 1024: 156 MB of the chains' f32 s2 in and bf16 out, 0.047 ms at
// 3.35 TB/s). What the design does about it: a row is loaded once, in
// 16-byte vectors, into registers, and the mean, the squared deviations and
// the affine all run from there, so that the registers bound the rows in
// flight; gamma and beta are copied once a block into shared memory
// (16-byte cp.async, while the first row's loads are in flight) and read
// from there for every row that the block's warps walk in a grid-stride
// loop, on as many blocks as stay resident on every SM (in registers they
// would triple a lane's registers at D = 1024 and halve the resident warps,
// the rows in flight).
//
// Layout of a width d in T (V = 16 / sizeof(T) values a vector, a chunk):
// a row of 16 chunks (D = 128 in bf16) is a half-warp's, with half-warp
// shuffles, two rows a warp; a wider row is a whole warp's, up to eight
// chunks a lane (lane l holds chunks l, l + 32, ...; the last ones masked
// where the chunks do not fill the lanes). A row past one warp's eight
// chunks a lane (D > 1024 in f32, D > 2048 in bf16) is spread over W = 2,
// 4 or 8 warps of a block, eight chunks a lane (lane l of the row's W x 32
// holds chunks l, l + 32 W, ...): the wide layout, to D = 8192 in f32 and
// 16384 in bf16. Its warps meet in shared memory for each of the two
// statistics; its gamma and beta (up to 128 KB) are staged in dynamic
// shared memory, as the narrow layouts stage theirs in static arrays, so
// that a row's bytes stay HBM's alone (read from L2 instead, gamma and
// beta would add 4 or 8 bytes of L2 reads to each 6 or 8 bytes of HBM
// traffic an element), at the cost of one resident block an SM past
// D = 14336 in bf16. Blocks are kWarps warps; the launch bounds guarantee
// blocks_per_sm resident blocks by the registers, and the grid counts on
// that many (past D = 14336 in bf16 the second block of an SM waits).
// ops/cuda_ln.row_plan computes the same layout and grid on the host;
// t2l_add_ln checks the plan it is given, and the chains' stage, whose C
// entries take no plan, computes the grid here by the same rule.
#pragma once

#include <atomic>

#include "common.cuh"
#include "gemm_tc.cuh"

namespace t2l {
namespace rows {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunks = 8;  // chunks a lane

// Resident blocks per SM that the launch bounds ask for, by the chunks a
// lane loads and the f32 values it keeps of its row (v a chunk): at most
// 42, 51, 64, 85 or 128 registers a thread.
__host__ __device__ constexpr int blocks_per_sm(int chunks, int v) {
  return chunks * v <= 8    ? 6
         : chunks * v <= 16 ? 5
         : chunks * v <= 32 ? (chunks <= 4 ? 4 : 3)
                            : 2;
}

struct Layout {
  int lanes;   // lanes of a row: 16 or 32; 0 where the width is refused
  int chunks;  // 16-byte chunks a lane: 1, 2, 4 or 8
  int warps;   // warps of a row: 1, or 2, 4 or 8 in the wide layout
};

// d in an element type of `tsize` bytes: a multiple of a vector, 16 to
// kWarps x 32 x kMaxChunks = 2048 chunks.
inline Layout layout(int d, int tsize) {
  const int v = 16 / tsize;
  const int n = d / v;
  if (d <= 0 || d % v || n < 16 || n > kWarps * 32 * kMaxChunks) return {0, 0, 0};
  if (n == 16) return {16, 1, 1};
  if (n <= 32 * kMaxChunks) {
    int c = 1;
    while (32 * c < n) c *= 2;
    return {32, c, 1};
  }
  int w = 2;
  while (32 * kMaxChunks * w < n) w *= 2;
  return {32, kMaxChunks, w};
}

// The wide layout's dynamic shared memory: gamma and beta in f32.
inline int wide_smem(int d) { return 2 * d * (int)sizeof(float); }

// Rows a block takes at a time: one a warp (two where a half-warp owns a
// row), one every W warps in the wide layout.
inline int rows_a_block(const Layout& l) { return kWarps * (32 / l.lanes) / l.warps; }

// Blocks of a call: the rows once, at most blocks_per_sm blocks on every
// SM (in the wide layout past D = 14336 in bf16 only one block's gamma and
// beta fit an SM: the second block of each SM waits for the first).
inline int grid(int m, int d, int tsize, int sms) {
  const Layout l = layout(d, tsize);
  if (l.lanes == 0 || m <= 0) return 0;
  const int rows = rows_a_block(l);
  const int need = (m + rows - 1) / rows;
  const int cap = sms * blocks_per_sm(l.chunks, 16 / tsize);
  return need < cap ? need : cap;
}

// 16-byte vectors of T to and from f32.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x, v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
// N f32 values from 16-byte vectors (device or shared memory).
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
  }
}

// The loaders: the V values of row `row` from column `col` as f32.
// x + res in T, summed in f32.
template <typename T>
struct SumRows {
  static constexpr int V = 16 / sizeof(T);
  const T* x;
  const T* res;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float (&v)[V]) const {
    const size_t o = (size_t)row * ld + col;
    float r[V];
    load_vec(x + o, v);
    load_vec(res + o, r);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] += r[i];
  }
};
// f32 rows, for an output in T.
template <typename T>
struct F32Rows {
  static constexpr int V = 16 / sizeof(T);
  const float* s;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float (&v)[V]) const {
    load_f32<V>(s + (size_t)row * ld + col, v);
  }
};

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Lane l's chunks l, l + L, ... of the row (zeros past m or past the n
// chunks of the row).
template <int L, int C, int V, class Load>
__device__ __forceinline__ void fetch_row(const Load& load, int row, int m, int l, int n,
                                          float (&v)[C][V]) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (row < m && j * L + l < n) {
      load(row, (j * L + l) * V, v[j]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[j][i] = 0.f;
    }
  }
}

template <typename T, int L, int C, class Load>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(C, 16 / sizeof(T)))
    layernorm_rows_kernel(Load load, const float* __restrict__ gamma,
                          const float* __restrict__ beta, float eps, T* __restrict__ out, int m,
                          int d) {
  constexpr int V = 16 / sizeof(T), R = 32 / L;
  __shared__ __align__(16) float gs[L * C * V], bs[L * C * V];
  const int lane = threadIdx.x & 31, l = lane % L;
  const int n = d / V;
  // r0, the warp's first row, is the same in every lane: the shuffles see
  // whole warps; a lane past m or past the row's chunks holds zeros.
  const int stride = gridDim.x * kWarps * R;
  const int first = (blockIdx.x * kWarps + (int)(threadIdx.x >> 5)) * R;
  // gamma and beta go to shared memory by cp.async (no registers), while
  // the first row's loads are in flight; then each iteration normalises
  // its row and loads the next.
  for (int i = 4 * (int)threadIdx.x; i < d; i += 4 * kThreads) {
    gemm::cp_async16(gs + i, gamma + i, 16);
    gemm::cp_async16(bs + i, beta + i, 16);
  }
  gemm::cp_async_commit();
  float v[C][V];
  fetch_row<L>(load, first + lane / L, m, l, n, v);
  gemm::cp_async_wait<0>();
  __syncthreads();
  for (int r0 = first; r0 < m; r0 += stride) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) s += v[j][i];
    const float mu = group_sum<L>(s) / (float)d;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j * L + l < n) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float t = v[j][i] - mu;
          q += t * t;
        }
      }
    }
    const float inv = rsqrtf(group_sum<L>(q) / (float)d + eps);
    const int row = r0 + lane / L;
    if (row < m) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (j * L + l < n) {
          const int col = (j * L + l) * V;
          float g[V], b[V], o[V];
          load_f32<V>(gs + col, g);
          load_f32<V>(bs + col, b);
#pragma unroll
          for (int i = 0; i < V; ++i) o[i] = (v[j][i] - mu) * inv * g[i] + b[i];
          store_vec(out + (size_t)row * d + col, o);
        }
      }
    }
    fetch_row<L>(load, row + stride, m, l, n, v);
  }
}

// The wide layout: a row over W warps, eight chunks a lane. The rows walk
// in a loop that is the block's (every warp takes as many turns), so that
// the row's warps can meet at the block's barriers; a group of W warps
// whose row lies past m computes on zeros and stores nothing.
template <typename T, int W, class Load>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kMaxChunks, 16 / sizeof(T)))
    layernorm_wide_kernel(Load load, const float* __restrict__ gamma,
                          const float* __restrict__ beta, float eps, T* __restrict__ out, int m,
                          int d) {
  constexpr int V = 16 / sizeof(T), C = kMaxChunks, L = 32 * W, G = kWarps / W;
  extern __shared__ __align__(16) float gb[];  // gamma [d], then beta [d]
  __shared__ float part_s[kWarps], part_q[kWarps];
  float* gs = gb;
  float* bs = gb + d;
  const int warp = (int)(threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int g = warp / W;                  // the block's row of this warp
  const int l = (warp % W) * 32 + lane;    // the lane within the row's W warps
  const int n = d / V;
  const int stride = gridDim.x * G;
  for (int i = 4 * (int)threadIdx.x; i < d; i += 4 * kThreads) {
    gemm::cp_async16(gs + i, gamma + i, 16);
    gemm::cp_async16(bs + i, beta + i, 16);
  }
  gemm::cp_async_commit();
  float v[C][V];
  fetch_row<L>(load, (int)blockIdx.x * G + g, m, l, n, v);
  gemm::cp_async_wait<0>();
  __syncthreads();
  for (int r0 = (int)blockIdx.x * G; r0 < m; r0 += stride) {
    const int row = r0 + g;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) s += v[j][i];
    s = group_sum<32>(s);
    if (lane == 0) part_s[warp] = s;
    __syncthreads();
    s = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) s += part_s[g * W + k];
    const float mu = s / (float)d;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j * L + l < n) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float t = v[j][i] - mu;
          q += t * t;
        }
      }
    }
    q = group_sum<32>(q);
    if (lane == 0) part_q[warp] = q;
    __syncthreads();
    q = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) q += part_q[g * W + k];
    const float inv = rsqrtf(q / (float)d + eps);
    if (row < m) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (j * L + l < n) {
          const int col = (j * L + l) * V;
          float gv[V], bv[V], o[V];
          load_f32<V>(gs + col, gv);
          load_f32<V>(bs + col, bv);
#pragma unroll
          for (int i = 0; i < V; ++i) o[i] = (v[j][i] - mu) * inv * gv[i] + bv[i];
          store_vec(out + (size_t)row * d + col, o);
        }
      }
    }
    fetch_row<L>(load, row + stride, m, l, n, v);
  }
}

// The wide kernel of W warps a row may take the shared memory of its widest
// row (W x 32 lanes x kMaxChunks chunks) on every device: set once a device
// (a bit a device, for the first 64), not at every launch.
template <typename T, int W, class Load>
cudaError_t launch_wide(const Load& load, const float* gamma, const float* beta, T* out, int m,
                        int d, float eps, int blocks, cudaStream_t st) {
  auto kern = layernorm_wide_kernel<T, W, Load>;
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wide_smem(W * 32 * kMaxChunks * (16 / (int)sizeof(T))));
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  kern<<<blocks, kThreads, wide_smem(d), st>>>(load, gamma, beta, eps, out, m, d);
  return cudaGetLastError();
}

// out [m, d] in T from the loader's rows on `blocks` blocks. gamma, beta
// and out 16-byte aligned (as the loader's rows).
template <typename T, class Load>
cudaError_t launch(const Load& load, const float* gamma, const float* beta, T* out, int m,
                   int d, float eps, int blocks, cudaStream_t st) {
  const Layout l = layout(d, sizeof(T));
  if (l.lanes == 0 || reinterpret_cast<uintptr_t>(gamma) % 16 ||
      reinterpret_cast<uintptr_t>(beta) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  if (blocks < 1) return cudaErrorInvalidValue;
  if (l.warps > 1) {
    switch (l.warps) {
      case 2:
        return launch_wide<T, 2>(load, gamma, beta, out, m, d, eps, blocks, st);
      case 4:
        return launch_wide<T, 4>(load, gamma, beta, out, m, d, eps, blocks, st);
      default:
        return launch_wide<T, 8>(load, gamma, beta, out, m, d, eps, blocks, st);
    }
  }
  if (l.lanes == 16) {
    layernorm_rows_kernel<T, 16, 1, Load><<<blocks, kThreads, 0, st>>>(load, gamma, beta, eps,
                                                                       out, m, d);
  } else {
    switch (l.chunks) {
      case 1:
        layernorm_rows_kernel<T, 32, 1, Load><<<blocks, kThreads, 0, st>>>(load, gamma, beta,
                                                                           eps, out, m, d);
        break;
      case 2:
        layernorm_rows_kernel<T, 32, 2, Load><<<blocks, kThreads, 0, st>>>(load, gamma, beta,
                                                                           eps, out, m, d);
        break;
      case 4:
        layernorm_rows_kernel<T, 32, 4, Load><<<blocks, kThreads, 0, st>>>(load, gamma, beta,
                                                                           eps, out, m, d);
        break;
      default:
        layernorm_rows_kernel<T, 32, 8, Load><<<blocks, kThreads, 0, st>>>(load, gamma, beta,
                                                                           eps, out, m, d);
    }
  }
  return cudaGetLastError();
}

// The tiled chains' last stage: out [m, d] in T = LayerNorm(s2 [m, d] f32).
template <typename T>
cudaError_t layernorm(const void* s2, const void* gamma, const void* beta, void* out, int m,
                      int d, float eps, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(s2) % 16) return cudaErrorInvalidValue;
  return launch<T>(F32Rows<T>{static_cast<const float*>(s2), d},
                   static_cast<const float*>(gamma), static_cast<const float*>(beta),
                   static_cast<T*>(out), m, d, eps, grid(m, d, sizeof(T), gemm::sm_count()), st);
}

}  // namespace rows
}  // namespace t2l
