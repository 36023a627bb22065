// Post-LN feed-forward block above d = 256, as a chain of tiled kernels over
// all rows:
//   out = LayerNorm(x + relu(x @ W1 + b1) @ W2 + b2) * gamma + beta
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_ffn.py
// (_ffn_addln_kernel :31 / fused_ffn_addlayernorm :47) where the
// one-block-per-16-rows kernel (ffn_addln.cu) does not pay or does not fit:
// d > 256 (the E=1024 language trunk, F = 4096, under fused_ffn="all"), or
// a width whose hidden rows exceed a block's shared memory.
//
// Numerics follow the TPU kernel and ffn_addln.cu: both products sum in
// f32; the hidden is relu'd in f32 and rounded to the compute dtype T; the
// residual sum (f32(x) + h W2) + b2 and the LayerNorm statistics are f32;
// the output is in T.
//
// What bounds it on the H100: at the intra stack's shape (1584 sentences x
// 16 tokens = 25,344 rows, D = 1024, F = 4096) the block is 4 R D F = 425
// GFLOP: 0.43 ms at the bf16 tensor-core peak of 989 TFLOP/s, 6.35 ms at
// the FP32 peak of 67, against about 0.04 ms to read x and the weights and
// write the output once. It is bound by operations.
// What the design does about it: both products run as row-tiled GEMMs over
// all rows at once (gemm_tc.cuh: mma.sync bf16 tensor cores with cp.async
// staging; in f32 register-tiled FP32 FMAs, no TF32), so each weight tile
// is reused by a whole row tile of 128 instead of being re-read from L2 by
// every 16 rows, and the products run on the tensor cores in bf16. The price
// is the hidden's round trip through HBM (R x F in T, about 0.12 ms in bf16
// at the intra shape), which the TPU kernel keeps in VMEM, and the f32
// pre-norm rows s2 (R x D).
// The chain, all on the caller's stream:
//   (a) h = round_T(relu(x W1 + b1)), the GEMM with EpiBiasRelu;
//   (b) s2 = (f32(x) + h W2) + b2, f32, the GEMM with the residual epilogue
//       (K = F);
//   (c) out = LayerNorm(s2) in T, one warp per row (layernorm_rows.cuh).
// wgmma, TMA, persistent tiles and keeping h on chip are later work.
#include "common.cuh"
#include "gemm_tc.cuh"
#include "layernorm_rows.cuh"

namespace {

template <typename T>
cudaError_t gemm_relu(const void* x, const void* w1, const void* b1, void* h, int m, int d,
                      int f, cudaStream_t st) {
  return t2l::gemm::run(static_cast<const T*>(x), d, static_cast<const T*>(w1), f, m, f, d,
                        t2l::gemm::EpiBiasRelu<T>{static_cast<T*>(h), f,
                                                  static_cast<const float*>(b1)},
                        st);
}

template <typename T>
cudaError_t block(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* gamma, const void* beta, void* out, void* h,
                  void* s2, int m, int d, int f, float eps, cudaStream_t st) {
  cudaError_t e = gemm_relu<T>(x, w1, b1, h, m, d, f, st);
  if (e == cudaSuccess)
    e = t2l::gemm::run(static_cast<const T*>(h), f, static_cast<const T*>(w2), d, m, d, f,
                       t2l::gemm::EpiResidual<T>{static_cast<float*>(s2), d,
                                                 static_cast<const float*>(b2),
                                                 static_cast<const T*>(x), d},
                       st);
  if (e == cudaSuccess) e = t2l::rows::layernorm<T>(s2, gamma, beta, out, m, d, eps, st);
  return e;
}

}  // namespace

extern "C" {

// The whole block. x [rows, d] T, w1 [d, f] T, b1 [f] f32, w2 [f, d] T,
// b2/gamma/beta [d] f32 -> out [rows, d] T. Scratch: h [rows, f] T,
// s2 [rows, d] f32. d and f multiples of 128.
int t2l_ffn_addln_tiled(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* gamma, const void* beta, void* out,
                        void* h, void* s2, int rows, int d, int f, float eps, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)block<__nv_bfloat16>(x, w1, b1, w2, b2, gamma, beta, out, h, s2, rows, d, f,
                                     eps, st);
  return (int)block<float>(x, w1, b1, w2, b2, gamma, beta, out, h, s2, rows, d, f, eps, st);
}

// Stage (a) alone, for the tests that hold it against its plain version:
// h [rows, f] T = round_T(relu(x w1 + b1)). Stages (b) and (c) are the
// attention chain's residual GEMM and LayerNorm entries (mha_tiled.cu),
// the same templates.
int t2l_ffn_tiled_gemm_relu(const void* x, const void* w1, const void* b1, void* h, int rows,
                            int d, int f, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16) return (int)gemm_relu<__nv_bfloat16>(x, w1, b1, h, rows, d, f, st);
  return (int)gemm_relu<float>(x, w1, b1, h, rows, d, f, st);
}

}  // extern "C"
