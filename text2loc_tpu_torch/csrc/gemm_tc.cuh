// Row-tiled f32 GEMMs of the port's tiled transformer-block chains
// (mha_tiled.cu, ffn_tiled.cu; their bf16 products run on wgmma,
// gemm_wgmma.cuh), and the tensor-core and copy helpers that the fused
// blocks and the SA tiles share (cp.async, ldmatrix, mma.sync, the
// epilogues):
//   C[M, N] = epilogue(A[M, K] . B[K, N]),
// A and B row-major (the port keeps weights [in, out]), f32 sums.
//
// f32: register-tiled FP32 FMAs (8x8 outputs a thread), double-buffered
// shared tiles. No TF32: f32 operands are never rounded.
//
// The ragged edge: rows of A at or past M are loaded as zeros and their
// outputs are not stored. N must be a multiple of the tile width (64 or
// 128) and K of 8; the blocks' D and F are multiples of 128, as the TPU
// kernels ask.
//
// An epilogue is a functor called as epi(row, col, v0, v1) with the f32
// sums of the two adjacent columns col, col + 1 of one row.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace t2l {
namespace gemm {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16x16, row) . b (16x8, col), bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// C = round_T((acc + bias[c]) * (c < nscale ? scale : 1)).
template <typename T>
struct EpiBiasScale {
  T* c;
  int ldc;
  const float* bias;
  int nscale;
  float scale;
  __device__ __forceinline__ void operator()(int r, int col, float v0, float v1) const {
    const float s0 = col < nscale ? scale : 1.f, s1 = col + 1 < nscale ? scale : 1.f;
    store2<T>(c + (size_t)r * ldc + col, (v0 + bias[col]) * s0, (v1 + bias[col + 1]) * s1);
  }
};

// C = round_T(relu(acc + bias[c])): the feed-forward hidden, relu'd in f32
// and then rounded (a NaN stays NaN, as jnp.maximum keeps it).
template <typename T>
struct EpiBiasRelu {
  T* c;
  int ldc;
  const float* bias;
  __device__ __forceinline__ void operator()(int r, int col, float v0, float v1) const {
    v0 += bias[col];
    v1 += bias[col + 1];
    store2<T>(c + (size_t)r * ldc + col, v0 < 0.f ? 0.f : v0, v1 < 0.f ? 0.f : v1);
  }
};

// C (f32) = (f32(res) + acc) + bias[c]: the residual sum before a LayerNorm.
template <typename T>
struct EpiResidual {
  float* c;
  int ldc;
  const float* bias;
  const T* res;
  int ldr;
  __device__ __forceinline__ void operator()(int r, int col, float v0, float v1) const {
    const T* rr = res + (size_t)r * ldr + col;
    store2<float>(c + (size_t)r * ldc + col, (to_f(rr[0]) + v0) + bias[col],
                  (to_f(rr[1]) + v1) + bias[col + 1]);
  }
};

// ---------------------------------------------------------------- f32, FMAs

template <int BM, int BN, class Epi>
__global__ void __launch_bounds__((BM / 8) * (BN / 8))
    gemm_f32_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B,
                    int ldb, int M, int K, int mtile0, Epi epi) {
  constexpr int BK = 8, TX = BN / 8, THREADS = (BM / 8) * (BN / 8);
  constexpr int AV = BM * BK / 4 / THREADS, BV = BK * BN / 4 / THREADS;
  static_assert(AV >= 1 && BV >= 1, "tile");
  __shared__ __align__(16) float As[2][BK][BM];  // A tile transposed: [k][m]
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = (mtile0 + blockIdx.y) * BM, n0 = blockIdx.x * BN;
  float4 ra[AV], rb[BV];

  auto gload = [&](int k0) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int c = tid + v * THREADS, r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      ra[v] = m0 + r < M ? *reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * lda +
                                                            k0 + kc)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int c = tid + v * THREADS, r = c / (BN / 4), nc = (c % (BN / 4)) * 4;
      rb[v] = *reinterpret_cast<const float4*>(B + (size_t)(k0 + r) * ldb + n0 + nc);
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int c = tid + v * THREADS, r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      As[buf][kc + 0][r] = ra[v].x;
      As[buf][kc + 1][r] = ra[v].y;
      As[buf][kc + 2][r] = ra[v].z;
      As[buf][kc + 3][r] = ra[v].w;
    }
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int c = tid + v * THREADS, r = c / (BN / 4), nc = (c % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(&Bs[buf][r][nc]) = rb[v];
    }
  };

  // A thread's outputs: rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3}, the
  // same split over the columns (conflict-free float4 reads of the tiles).
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  gload(0);
  sstore(0);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < K; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < K;
    if (more) gload(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][BN / 2 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) sstore(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * (BN / 2) + tx * 4;
      epi(r, col, acc[i][h * 4 + 0], acc[i][h * 4 + 1]);
      epi(r, col + 2, acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
    }
  }
}

// ------------------------------------------------------------------ launch

constexpr int kMaxGridY = 65535;

inline int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// The launcher covers the rows in chunks of at most kMaxGridY tiles
// (grid.y's limit); grid.x walks the column tiles, so the blocks in flight
// share A's rows.
template <int BM, int BN, class Epi>
cudaError_t launch_f32(const float* A, int lda, const float* B, int ldb, int M, int N,
                       int K, const Epi& epi, cudaStream_t st) {
  const int mtiles = (M + BM - 1) / BM;
  for (int t0 = 0; t0 < mtiles; t0 += kMaxGridY) {
    const dim3 grid(N / BN, mtiles - t0 < kMaxGridY ? mtiles - t0 : kMaxGridY);
    gemm_f32_kernel<BM, BN, Epi>
        <<<grid, (BM / 8) * (BN / 8), 0, st>>>(A, lda, B, ldb, M, K, t0, epi);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The large tile where its blocks fill every SM, else the small one.
template <class Epi>
cudaError_t run(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                const Epi& epi, cudaStream_t st) {
  if (M <= 0) return cudaSuccess;
  if (K % 8 || N % 64) return cudaErrorInvalidValue;
  const long big = (long)((M + 127) / 128) * (N / 128);
  if (N % 128 == 0 && big >= sm_count())
    return launch_f32<128, 128>(A, lda, B, ldb, M, N, K, epi, st);
  return launch_f32<64, 64>(A, lda, B, ldb, M, N, K, epi, st);
}

}  // namespace gemm
}  // namespace t2l
