// Fused residual add + LayerNorm of rows of width D:
//   out = LayerNorm(x + res) * scale + bias
// with x and res summed in f32, f32 statistics (two passes: the mean, then
// the mean of squared deviations, i.e. the biased variance), rsqrt, the
// affine, and the store in x's dtype.
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_ln.py:36
// fused_add_layernorm (_addln_kernel :26), which the JAX package runs after
// the stock attention and feed-forward blocks in eval.
//
// What bounds it on the H100: bytes. Each element is read twice (x, res)
// and written once for about ten FLOPs, far below the card's ~20 FLOPs per
// byte at f32. What the design does about it: the row routine of
// layernorm_rows.cuh (rows in registers, 16-byte vectors, gamma and beta
// staged once a block in shared memory for a grid-stride loop over the
// rows), with no padding of the row count (the TPU kernel pads rows to its
// 512-row tile). The plan
// (rows a warp, blocks) is ops/cuda_ln.row_plan's; this file checks it.
#include "common.cuh"
#include "layernorm_rows.cuh"

namespace {

namespace rows = t2l::rows;

template <typename T>
int launch(const void* x, const void* res, const void* scale, const void* bias, void* out,
           int rows_, int d, float eps, int rows_per_warp, int blocks, cudaStream_t st) {
  const rows::Layout l = rows::layout(d, sizeof(T));
  if (l.lanes == 0 || rows_per_warp != 32 / l.lanes || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(res) % 16)
    return (int)cudaErrorInvalidValue;
  const int per_block = rows::rows_a_block(l);
  if (rows_ > 0 && blocks > (rows_ + per_block - 1) / per_block) return (int)cudaErrorInvalidValue;
  return (int)rows::launch<T>(
      rows::SumRows<T>{static_cast<const T*>(x), static_cast<const T*>(res), d},
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<T*>(out),
      rows_, d, eps, blocks, st);
}

}  // namespace

extern "C" {

// x, res, out [rows, d] in the dtype (f32 or bf16), scale / bias [d] f32,
// all 16-byte aligned; d a multiple of 16 bytes of the dtype, 16 to 2048
// of them (the wrapper takes every multiple of 128 among them: D <= 8192
// in f32, 16384 in bf16). rows_per_warp and blocks: ops/cuda_ln.row_plan's,
// refused unless rows_per_warp is the layout's and blocks at least 1 and
// no more than the rows fill (a block's rows: rows_a_block).
int t2l_add_ln(const void* x, const void* res, const void* scale, const void* bias,
               void* out, int rows, int d, float eps, int rows_per_warp, int blocks, int dtype,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return launch<__nv_bfloat16>(x, res, scale, bias, out, rows, d, eps, rows_per_warp, blocks,
                                 st);
  return launch<float>(x, res, scale, bias, out, rows, d, eps, rows_per_warp, blocks, st);
}

// The blocks that the tiled chains' LayerNorm stage launches for m rows of
// width d (layernorm_rows.cuh grid() on this device), for the tests that
// hold ops/cuda_ln.row_plan to it; 0 where the width is refused.
int t2l_ln_rows_blocks(int m, int d, int dtype) {
  return t2l::rows::grid(m, d, dtype == t2l::kBF16 ? 2 : 4, t2l::gemm::sm_count());
}

}  // extern "C"
