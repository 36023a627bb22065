// Post-LN multi-head attention block above d = 256, as a chain of tiled
// kernels over all rows of the batch:
//   out = LayerNorm(x + MHA(x, kv) @ Wo + bo) * gamma + beta
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_mha.py
// (_mha_block_kernel :44 / fused_mha_addlayernorm :137) where the
// one-block-per-sample kernel (mha_addln.cu) does not pay or does not fit:
// d > 256, or a sample that needs more shared memory than a block has.
//
// Numerics follow the TPU kernel and mha_addln.cu: projections sum in f32;
// q = (x Wq + bq) / sqrt(dh), k, v rounded to the compute dtype T; the key
// mask as an additive -1e9 bias, added to the f32 score as mha_addln.cu
// adds it (so an all-masked sample attends uniformly over its own keys);
// softmax in f32 and rounded to T; the attention output rounded to T; the
// residual sum and the LayerNorm statistics in f32.
//
// What bounds it on the H100: at the intra stack's shape (1584 sentences x
// 16 tokens = 25,344 rows, D = 1024, 4 heads) the block is four D x D
// products over every row, about 214 GFLOP: 0.217 ms at the bf16
// tensor-core peak of 989 TFLOP/s, against about 0.03 ms to read x and write
// the output once. It is bound by operations.
// What the design does about it: the products run as row-tiled GEMMs over
// all rows at once (gemm_tc.cuh: mma.sync bf16 tensor cores with cp.async
// staging; in f32 register-tiled FP32 FMAs, no TF32), so each weight tile
// is reused by every row tile instead of being streamed through L2 once per
// sample. The price is HBM traffic for q/k/v, the attention output and the
// pre-norm sum s2 between the kernels, about 0.1 ms at E=1024 in bf16.
// The chain, all on the caller's stream:
//   (a) qkv = round_T((x [Wq|Wk|Wv] + b) * colscale), the q columns scaled
//       by 1/sqrt(dh): one GEMM for self-attention; for cross-attention
//       x Wq and kv [Wk|Wv];
//   (b) per (sample, head): scores + key bias, f32 softmax rounded to T,
//       o = round_T(p v), with q, k and v of the head in shared memory;
//   (c) s2 = (f32(x) + o Wo) + bo, f32, the GEMM with a residual epilogue;
//   (d) out = LayerNorm(s2) in T, one warp per row (layernorm_rows.cuh).
// wgmma, TMA, persistent tiles and fusing (c) with (d) are later work.
#include <math.h>

#include "common.cuh"
#include "gemm_tc.cuh"
#include "layernorm_rows.cuh"

namespace {

constexpr int kCoreThreads = 256;

// Shared bytes of the attention core: q, k, v of one head in T, then the
// [lq, lk] f32 probabilities.
__host__ __device__ inline size_t core_p_offset(int lq, int lk, int dh, size_t tsize) {
  return t2l::align16(tsize * (size_t)(lq + 2 * lk) * dh);
}
inline size_t core_smem(int lq, int lk, int dh, size_t tsize) {
  return core_p_offset(lq, lk, dh, tsize) + sizeof(float) * (size_t)lq * lk;
}

// One block per (sample, head). q rows of stride ldq, k and v rows of
// stride ldkv, o rows of stride ldo; the head's columns start at h * dh.
template <typename T>
__global__ void __launch_bounds__(kCoreThreads)
    attention_core_kernel(const T* __restrict__ q, int ldq, const T* __restrict__ k,
                          const T* __restrict__ v, int ldkv,
                          const float* __restrict__ kbias, T* __restrict__ o, int ldo,
                          int lq, int lk, int dh, int heads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [lq][dh]
  T* ks = qs + lq * dh;                    // [lk][dh]
  T* vs = ks + lk * dh;                    // [lk][dh]
  float* ps = reinterpret_cast<float*>(smem_raw + core_p_offset(lq, lk, dh, sizeof(T)));

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const T* qb = q + (size_t)b * lq * ldq + h * dh;
  const T* kb_ = k + (size_t)b * lk * ldkv + h * dh;
  const T* vb = v + (size_t)b * lk * ldkv + h * dh;
  const float* kbias_b = kbias + (size_t)b * lk;

  for (int i = tid; i < lq * dh; i += blockDim.x) qs[i] = qb[(size_t)(i / dh) * ldq + i % dh];
  for (int i = tid; i < lk * dh; i += blockDim.x) {
    const size_t g = (size_t)(i / dh) * ldkv + i % dh;
    ks[i] = kb_[g];
    vs[i] = vb[g];
  }
  __syncthreads();

  // Scores, one warp per (query, key) pair, plus the additive key bias.
  for (int pair = warp; pair < lq * lk; pair += nwarps) {
    const int qi = pair / lk, kj = pair - qi * lk;
    const T* qr = qs + qi * dh;
    const T* kr = ks + kj * dh;
    float acc = 0.f;
    for (int e = lane; e < dh; e += 32) acc += t2l::to_f(qr[e]) * t2l::to_f(kr[e]);
    acc = t2l::warp_sum(acc);
    if (lane == 0) ps[pair] = acc + kbias_b[kj];
  }
  __syncthreads();

  // Softmax over the keys (f32), rounded to T.
  for (int row = tid; row < lq; row += blockDim.x) {
    float* pr = ps + (size_t)row * lk;
    float m = -INFINITY;
    for (int j = 0; j < lk; ++j) m = fmaxf(m, pr[j]);
    float sum = 0.f;
    for (int j = 0; j < lk; ++j) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    for (int j = 0; j < lk; ++j) pr[j] = t2l::round_to<T>(pr[j] / sum);
  }
  __syncthreads();

  T* ob = o + (size_t)b * lq * ldo + h * dh;
  for (int i = tid; i < lq * dh; i += blockDim.x) {
    const int qi = i / dh, c = i - qi * dh;
    const float* pr = ps + (size_t)qi * lk;
    float acc = 0.f;
    for (int j = 0; j < lk; ++j) acc += pr[j] * t2l::to_f(vs[j * dh + c]);
    ob[(size_t)qi * ldo + c] = t2l::from_f<T>(acc);
  }
}

template <typename T>
cudaError_t gemm(const void* a, int lda, const void* b, int ldb, const void* bias, void* c,
                 int ldc, const void* res, int ldr, int m, int n, int k, int nscale,
                 float scale, cudaStream_t st) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  const float* bs = static_cast<const float*>(bias);
  if (res == nullptr)
    return t2l::gemm::run(A, lda, B, ldb, m, n, k,
                          t2l::gemm::EpiBiasScale<T>{static_cast<T*>(c), ldc, bs, nscale,
                                                     scale},
                          st);
  return t2l::gemm::run(A, lda, B, ldb, m, n, k,
                        t2l::gemm::EpiResidual<T>{static_cast<float*>(c), ldc, bs,
                                                  static_cast<const T*>(res), ldr},
                        st);
}

template <typename T>
cudaError_t core(const void* q, int ldq, const void* k, const void* v, int ldkv,
                 const void* kbias, void* o, int b, int lq, int lk, int d, int heads,
                 cudaStream_t st) {
  if (b <= 0) return cudaSuccess;
  const int dh = d / heads;
  const size_t smem = core_smem(lq, lk, dh, sizeof(T));
  auto kern = attention_core_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<b * heads, kCoreThreads, smem, st>>>(
      static_cast<const T*>(q), ldq, static_cast<const T*>(k), static_cast<const T*>(v),
      ldkv, static_cast<const float*>(kbias), static_cast<T*>(o), d, lq, lk, dh, heads);
  return cudaGetLastError();
}

template <typename T>
cudaError_t block(const void* x, const void* kv, const void* kbias, const void* wqkv,
                  const void* bqkv, const void* wo, const void* bo, const void* gamma,
                  const void* beta, void* out, void* qkv, void* o, void* s2, int b, int lq,
                  int lk, int d, int heads, float scale, float eps, int self_attn,
                  cudaStream_t st) {
  const int m = b * lq, mk = b * lk;
  const float* bias = static_cast<const float*>(bqkv);
  T* buf = static_cast<T*>(qkv);
  const T* w = static_cast<const T*>(wqkv);
  cudaError_t e;
  const T *qp, *kp, *vp;
  int ldq, ldkv;
  if (self_attn) {  // qkv [m, 3d]
    e = gemm<T>(x, d, w, 3 * d, bias, buf, 3 * d, nullptr, 0, m, 3 * d, d, d, scale, st);
    qp = buf, kp = buf + d, vp = buf + 2 * d, ldq = ldkv = 3 * d;
  } else {  // q [m, d], then k|v [mk, 2d]
    T* kvp = buf + (size_t)m * d;
    e = gemm<T>(x, d, w, 3 * d, bias, buf, d, nullptr, 0, m, d, d, d, scale, st);
    if (e == cudaSuccess)
      e = gemm<T>(kv, d, w + d, 3 * d, bias + d, kvp, 2 * d, nullptr, 0, mk, 2 * d, d, 0,
                  1.f, st);
    qp = buf, kp = kvp, vp = kvp + d, ldq = d, ldkv = 2 * d;
  }
  if (e == cudaSuccess) e = core<T>(qp, ldq, kp, vp, ldkv, kbias, o, b, lq, lk, d, heads, st);
  if (e == cudaSuccess) e = gemm<T>(o, d, wo, d, bo, s2, d, x, d, m, d, d, 0, 1.f, st);
  if (e == cudaSuccess) e = t2l::rows::layernorm<T>(s2, gamma, beta, out, m, d, eps, st);
  return e;
}

}  // namespace

extern "C" {

size_t t2l_mha_tiled_core_smem(int lq, int lk, int d, int heads, int dtype) {
  return core_smem(lq, lk, d / heads, dtype == t2l::kBF16 ? 2 : 4);
}

// The whole block. x [b,lq,d] T, kv [b,lk,d] T (ignored when self_attn),
// kbias [b,lk] f32, wqkv [d,3d] T ([Wq|Wk|Wv], [in, out]), bqkv [3d] f32,
// wo [d,d] T, bo/gamma/beta [d] f32 -> out [b,lq,d] T. Scratch: qkv
// (b*lq*3d T when self_attn, else b*lq*d + b*lk*2d), o [b*lq, d] T,
// s2 [b*lq, d] f32.
int t2l_mha_addln_tiled(const void* x, const void* kv, const void* kbias, const void* wqkv,
                        const void* bqkv, const void* wo, const void* bo,
                        const void* gamma, const void* beta, void* out, void* qkv, void* o,
                        void* s2, int b, int lq, int lk, int d, int heads, float scale,
                        float eps, int self_attn, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)block<__nv_bfloat16>(x, kv, kbias, wqkv, bqkv, wo, bo, gamma, beta, out,
                                     qkv, o, s2, b, lq, lk, d, heads, scale, eps,
                                     self_attn, st);
  return (int)block<float>(x, kv, kbias, wqkv, bqkv, wo, bo, gamma, beta, out, qkv, o, s2,
                           b, lq, lk, d, heads, scale, eps, self_attn, st);
}

// The stages one at a time, for the tests that hold each against its plain
// version. (a)/(c): res NULL gives c = round_T((a b + bias) * colscale),
// else c (f32) = (f32(res) + a b) + bias.
int t2l_mha_tiled_gemm(const void* a, int lda, const void* b, int ldb, const void* bias,
                       void* c, int ldc, const void* res, int ldr, int m, int n, int k,
                       int nscale, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)gemm<__nv_bfloat16>(a, lda, b, ldb, bias, c, ldc, res, ldr, m, n, k, nscale,
                                    scale, st);
  return (int)gemm<float>(a, lda, b, ldb, bias, c, ldc, res, ldr, m, n, k, nscale, scale,
                          st);
}

// (b): q rows of stride ldq, k and v rows of stride ldkv -> o [b*lq, d].
int t2l_mha_tiled_core(const void* q, int ldq, const void* k, const void* v, int ldkv,
                       const void* kbias, void* o, int b, int lq, int lk, int d, int heads,
                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)core<__nv_bfloat16>(q, ldq, k, v, ldkv, kbias, o, b, lq, lk, d, heads, st);
  return (int)core<float>(q, ldq, k, v, ldkv, kbias, o, b, lq, lk, d, heads, st);
}

// (d): out [m, d] T = LayerNorm(s2 [m, d] f32).
int t2l_mha_tiled_ln(const void* s2, const void* gamma, const void* beta, void* out, int m,
                     int d, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)t2l::rows::layernorm<__nv_bfloat16>(s2, gamma, beta, out, m, d, eps, st);
  return (int)t2l::rows::layernorm<float>(s2, gamma, beta, out, m, d, eps, st);
}

}  // extern "C"
