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
// What the design does about it: both products run over all rows at once,
// so each weight tile is reused by every row tile instead of being re-read
// from L2 by every 16 rows, on wgmma (gemm_wgmma.cuh: a TMA ring of
// k-slices feeding two consumer warpgroups, persistent 128 x 128 output
// tiles, each epilogue overlapping the next tile's loads). In bf16 on the
// weights as the caller holds them, [in, out], by the transposed-B form;
// in f32 as 3xTF32 (1.29 ms a product at the TF32 peak of 495 TFLOP/s), on
// the transposed split of W1 and W2 that the block's entry writes first,
// per call, by tf32_split.cu's kernel (hi and lo, the wrapper's scratch), A
// split in registers, never TF32 alone. The price is the hidden's round
// trip through HBM (R x F in T, about 0.12 ms in bf16 at the intra shape),
// which the TPU kernel keeps in VMEM, the f32 pre-norm rows s2 (R x D), and
// in f32 the split (32 MB read, 64 MB written at D = 1024, F = 4096).
// The chain, all on the caller's stream:
//   (a) h = round_T(relu(x W1 + b1)), the product with the bias + relu
//       epilogue (N = F: one tensor map over W1 [D, F], or over W1^T's
//       split [F, D] in f32);
//   (b) s2 = (f32(x) + h W2) + b2, f32, the product with the residual
//       epilogue (K = F: 64 k-slices a tile through the ring in bf16, 128
//       in f32);
//   (c) out = LayerNorm(s2) in T, the row routine of layernorm_rows.cuh
//       (rows in registers, 16-byte vectors), which the attention chain's
//       last stage and add_ln.cu share.
#include <type_traits>

#include "common.cuh"
#include "gemm_wgmma.cuh"
#include "layernorm_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;

// (a): h [m, f] = round_T(relu(x [m, d] w1 [d, f] + b1)); in f32 the
// product reads w1t_hi / w1t_lo, W1^T's split [f, d], instead of w1.
template <typename T>
cudaError_t gemm_relu(const void* x, const void* w1, const void* w1t_hi, const void* w1t_lo,
                      const void* b1, void* h, int m, int d, int f, cudaStream_t st) {
  const T* X = static_cast<const T*>(x);
  const t2l::wg::EpiBiasRelu<T> epi{static_cast<T*>(h), f, static_cast<const float*>(b1)};
  if constexpr (std::is_same<T, bf16>::value) {
    const T* W = static_cast<const T*>(w1);
    return t2l::wg::run(X, d, m, d, &W, f, 1, f, epi, st);
  } else {
    return t2l::wg::run_f32(X, d, m, d, static_cast<const float*>(w1t_hi),
                            static_cast<const float*>(w1t_lo), d, f, epi, st);
  }
}

// (b) and (c): s2 [m, d] f32 = (f32(x) + h [m, f] w2 [f, d]) + b2, then
// out [m, d] T = LayerNorm(s2); in f32 the product reads w2t_hi / w2t_lo,
// W2^T's split [d, f], instead of w2.
template <typename T>
cudaError_t out_addln(const void* x, const void* h, const void* w2, const void* w2t_hi,
                      const void* w2t_lo, const void* b2, const void* gamma, const void* beta,
                      void* out, void* s2, int m, int d, int f, float eps, cudaStream_t st) {
  const T* H = static_cast<const T*>(h);
  const t2l::wg::EpiResidual<T> epi{static_cast<float*>(s2), d, static_cast<const float*>(b2),
                                    static_cast<const T*>(x), d};
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    const T* W = static_cast<const T*>(w2);
    e = t2l::wg::run(H, f, m, f, &W, d, 1, d, epi, st);
  } else {
    e = t2l::wg::run_f32(H, f, m, f, static_cast<const float*>(w2t_hi),
                         static_cast<const float*>(w2t_lo), f, d, epi, st);
  }
  if (e == cudaSuccess) e = t2l::rows::layernorm<T>(s2, gamma, beta, out, m, d, eps, st);
  return e;
}

// wt_hi / wt_lo: t2l_tf32_split_t's output for (w1, w2), W1^T [f, d] then
// W2^T [d, f] (f32 only).
template <typename T>
cudaError_t block(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* wt_hi, const void* wt_lo, const void* gamma,
                  const void* beta, void* out, void* h, void* s2, int m, int d, int f,
                  float eps, cudaStream_t st) {
  const float* hi = static_cast<const float*>(wt_hi);
  const float* lo = static_cast<const float*>(wt_lo);
  const size_t w2_at = (size_t)f * d;
  cudaError_t e = gemm_relu<T>(x, w1, hi, lo, b1, h, m, d, f, st);
  if (e == cudaSuccess)
    e = out_addln<T>(x, h, w2, hi ? hi + w2_at : nullptr, lo ? lo + w2_at : nullptr, b2, gamma,
                     beta, out, s2, m, d, f, eps, st);
  return e;
}

}  // namespace

extern "C" {

// The whole block. x [rows, d] T, w1 [d, f] T, b1 [f] f32, w2 [f, d] T,
// b2/gamma/beta [d] f32 -> out [rows, d] T. Scratch: h [rows, f] T, s2
// [rows, d] f32; in f32 wt_hi and wt_lo [2 f d] f32 each (NULL in bf16),
// into which the block first writes the split of (w1, w2)
// (t2l_tf32_split_t, its one launch of that kernel) for its products to
// read. d and f multiples of 128; every pointer 16-byte aligned.
int t2l_ffn_addln_tiled(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* wt_hi, void* wt_lo, const void* gamma,
                        const void* beta, void* out, void* h, void* s2, int rows, int d, int f,
                        float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)block<bf16>(x, w1, b1, w2, b2, nullptr, nullptr, gamma, beta, out, h, s2, rows,
                            d, f, eps, st);
  if (wt_hi == nullptr || wt_lo == nullptr) return (int)cudaErrorInvalidValue;
  const int e = t2l_tf32_split_t(w1, d, f, w2, f, d, nullptr, 0, 0, nullptr, 0, 0, 2, wt_hi,
                                 wt_lo, stream);
  if (e != 0) return e;
  return (int)block<float>(x, w1, b1, w2, b2, wt_hi, wt_lo, gamma, beta, out, h, s2, rows, d,
                           f, eps, st);
}

// The stages alone, for the tests that hold each against its plain
// version; the block runs the same functions. (a):
// h [rows, f] T = round_T(relu(x w1 + b1)); in f32 the product reads
// w1t_hi / w1t_lo, W1^T's split [f, d].
int t2l_ffn_tiled_gemm_relu(const void* x, const void* w1, const void* w1t_hi,
                            const void* w1t_lo, const void* b1, void* h, int rows, int d, int f,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)gemm_relu<bf16>(x, w1, nullptr, nullptr, b1, h, rows, d, f, st);
  if (w1t_hi == nullptr || w1t_lo == nullptr) return (int)cudaErrorInvalidValue;
  return (int)gemm_relu<float>(x, w1, w1t_hi, w1t_lo, b1, h, rows, d, f, st);
}

// (b) and (c): out [rows, d] T = LayerNorm((f32(x) + h w2) + b2), through
// the scratch s2 [rows, d] f32; in f32 the product reads w2t_hi / w2t_lo,
// W2^T's split [d, f].
int t2l_ffn_tiled_out_addln(const void* x, const void* h, const void* w2, const void* w2t_hi,
                            const void* w2t_lo, const void* b2, const void* gamma,
                            const void* beta, void* out, void* s2, int rows, int d, int f,
                            float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)out_addln<bf16>(x, h, w2, nullptr, nullptr, b2, gamma, beta, out, s2, rows, d,
                                f, eps, st);
  if (w2t_hi == nullptr || w2t_lo == nullptr) return (int)cudaErrorInvalidValue;
  return (int)out_addln<float>(x, h, w2, w2t_hi, w2t_lo, b2, gamma, beta, out, s2, rows, d, f,
                               eps, st);
}

}  // extern "C"
