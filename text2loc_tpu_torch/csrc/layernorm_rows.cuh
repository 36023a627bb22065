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
// where the chunks do not fill the lanes). Blocks are kWarps warps; the
// launch bounds guarantee blocks_per_sm resident blocks.
// ops/cuda_ln.row_plan computes the same layout and grid on the host;
// t2l_add_ln checks the plan it is given, and the chains' stage, whose C
// entries take no plan, computes the grid here by the same rule.
#pragma once

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
};

// d in an element type of `tsize` bytes: a multiple of a vector, 16 to
// 256 chunks.
inline Layout layout(int d, int tsize) {
  const int v = 16 / tsize;
  const int n = d / v;
  if (d <= 0 || d % v || n < 16 || n > 32 * kMaxChunks) return {0, 0};
  if (n == 16) return {16, 1};
  int c = 1;
  while (32 * c < n) c *= 2;
  return {32, c};
}

// Blocks of a call: one row a warp (two where a half-warp owns a row)
// over the rows, at most blocks_per_sm on every SM.
inline int grid(int m, int d, int tsize, int sms) {
  const Layout l = layout(d, tsize);
  if (l.lanes == 0 || m <= 0) return 0;
  const int rows_a_block = kWarps * (32 / l.lanes);
  const int need = (m + rows_a_block - 1) / rows_a_block;
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
