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
// from L2 by every 16 rows. In bf16 they run on wgmma (gemm_wgmma.cuh: a
// TMA ring of k-slices feeding two consumer warpgroups, persistent 128 x
// 128 output tiles, each epilogue overlapping the next tile's loads; the
// weights as the caller holds them, [in, out], by the transposed-B form);
// in f32 on register-tiled FP32 FMAs (gemm_tc.cuh, no TF32: wgmma takes a
// transposed B only in 16-bit types). The price is the hidden's round trip
// through HBM (R x F in T, about 0.12 ms in bf16 at the intra shape), which
// the TPU kernel keeps in VMEM, and the f32 pre-norm rows s2 (R x D).
// The chain, all on the caller's stream:
//   (a) h = round_T(relu(x W1 + b1)), the product with the bias + relu
//       epilogue (N = F: one tensor map over W1 [D, F]);
//   (b) s2 = (f32(x) + h W2) + b2, f32, the product with the residual
//       epilogue (K = F: 64 k-slices a tile through the ring);
//   (c) out = LayerNorm(s2) in T, the row routine of layernorm_rows.cuh
//       (rows in registers, 16-byte vectors), which the attention chain's
//       last stage and add_ln.cu share.
#include <type_traits>

#include "common.cuh"
#include "gemm_tc.cuh"
#include "gemm_wgmma.cuh"
#include "layernorm_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;

// (a): h [m, f] = round_T(relu(x [m, d] w1 [d, f] + b1)).
template <typename T>
cudaError_t gemm_relu(const void* x, const void* w1, const void* b1, void* h, int m, int d,
                      int f, cudaStream_t st) {
  const T* X = static_cast<const T*>(x);
  const T* W = static_cast<const T*>(w1);
  const float* b = static_cast<const float*>(b1);
  if constexpr (std::is_same<T, bf16>::value)
    return t2l::wg::run(X, d, m, d, &W, f, 1, f, t2l::wg::EpiBiasRelu<T>{static_cast<T*>(h), f, b},
                        st);
  else
    return t2l::gemm::run(X, d, W, f, m, f, d,
                          t2l::gemm::EpiBiasRelu<T>{static_cast<T*>(h), f, b}, st);
}

// (b) and (c): s2 [m, d] f32 = (f32(x) + h [m, f] w2 [f, d]) + b2, then
// out [m, d] T = LayerNorm(s2).
template <typename T>
cudaError_t out_addln(const void* x, const void* h, const void* w2, const void* b2,
                      const void* gamma, const void* beta, void* out, void* s2, int m, int d,
                      int f, float eps, cudaStream_t st) {
  const T* H = static_cast<const T*>(h);
  const T* W = static_cast<const T*>(w2);
  float* S = static_cast<float*>(s2);
  const float* b = static_cast<const float*>(b2);
  const T* X = static_cast<const T*>(x);
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value)
    e = t2l::wg::run(H, f, m, f, &W, d, 1, d, t2l::wg::EpiResidual<T>{S, d, b, X, d}, st);
  else
    e = t2l::gemm::run(H, f, W, d, m, d, f, t2l::gemm::EpiResidual<T>{S, d, b, X, d}, st);
  if (e == cudaSuccess) e = t2l::rows::layernorm<T>(s2, gamma, beta, out, m, d, eps, st);
  return e;
}

template <typename T>
cudaError_t block(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* gamma, const void* beta, void* out, void* h,
                  void* s2, int m, int d, int f, float eps, cudaStream_t st) {
  cudaError_t e = gemm_relu<T>(x, w1, b1, h, m, d, f, st);
  if (e == cudaSuccess) e = out_addln<T>(x, h, w2, b2, gamma, beta, out, s2, m, d, f, eps, st);
  return e;
}

}  // namespace

extern "C" {

// The whole block. x [rows, d] T, w1 [d, f] T, b1 [f] f32, w2 [f, d] T,
// b2/gamma/beta [d] f32 -> out [rows, d] T. Scratch: h [rows, f] T,
// s2 [rows, d] f32. d and f multiples of 128; every pointer 16-byte
// aligned.
int t2l_ffn_addln_tiled(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* gamma, const void* beta, void* out,
                        void* h, void* s2, int rows, int d, int f, float eps, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)block<bf16>(x, w1, b1, w2, b2, gamma, beta, out, h, s2, rows, d, f, eps, st);
  return (int)block<float>(x, w1, b1, w2, b2, gamma, beta, out, h, s2, rows, d, f, eps, st);
}

// The stages alone, for the tests that hold each against its plain
// version; the block runs the same functions. (a):
// h [rows, f] T = round_T(relu(x w1 + b1)).
int t2l_ffn_tiled_gemm_relu(const void* x, const void* w1, const void* b1, void* h, int rows,
                            int d, int f, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16) return (int)gemm_relu<bf16>(x, w1, b1, h, rows, d, f, st);
  return (int)gemm_relu<float>(x, w1, b1, h, rows, d, f, st);
}

// (b) and (c): out [rows, d] T = LayerNorm((f32(x) + h w2) + b2), through
// the scratch s2 [rows, d] f32.
int t2l_ffn_tiled_out_addln(const void* x, const void* h, const void* w2, const void* b2,
                            const void* gamma, const void* beta, void* out, void* s2, int rows,
                            int d, int f, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)out_addln<bf16>(x, h, w2, b2, gamma, beta, out, s2, rows, d, f, eps, st);
  return (int)out_addln<float>(x, h, w2, b2, gamma, beta, out, s2, rows, d, f, eps, st);
}

}  // extern "C"
