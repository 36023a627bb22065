// The tensor-core and copy helpers that the fused blocks (ffn_addln.cu,
// mha_addln.cu through fused_block.cuh), the SA tiles and the tiled chains
// share: cp.async, ldmatrix, mma.sync, the paired stores, the fused
// feed-forward block's epilogues and the SM count. The tiled chains'
// products themselves run on wgmma (gemm_wgmma.cuh), in bf16 and, as
// 3xTF32, in f32.
//
// An epilogue here is a functor called as epi(row, col, v0, v1) with the
// f32 sums of the two adjacent columns col, col + 1 of one row.
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

// ------------------------------------------------------------------ launch

inline int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

}  // namespace gemm
}  // namespace t2l
