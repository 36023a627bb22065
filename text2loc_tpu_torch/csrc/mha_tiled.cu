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
//       where they do not fit, per (sample, head, tile of query rows) with
//       k and v streamed in key chunks (the key-tiled core), so every
//       length runs;
//   (c) s2 = (f32(x) + o Wo) + bo, f32, the GEMM with a residual epilogue;
//   (d) out = LayerNorm(s2) in T, one warp per row (layernorm_rows.cuh).
// wgmma, TMA, persistent tiles and fusing (c) with (d) are later work.
#include <math.h>

#include "common.cuh"
#include "gemm_tc.cuh"
#include "layernorm_rows.cuh"

namespace {

constexpr int kCoreThreads = 256;
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory one block may use

// Shared bytes of the one-block attention core: q, k, v of one head in T,
// then the [lq, lk] f32 probabilities.
__host__ __device__ inline size_t core_p_offset(int lq, int lk, int dh, size_t tsize) {
  return t2l::align16(tsize * (size_t)(lq + 2 * lk) * dh);
}
inline size_t core_smem(int lq, int lk, int dh, size_t tsize) {
  return core_p_offset(lq, lk, dh, tsize) + sizeof(float) * (size_t)lq * lk;
}

// The key-tiled core's carve-up for rq query rows and key chunks of ck
// rows: q [rq][dh] and a chunk of k and of v [ck][dh] in T, the chunk's f32
// scores [rq][ck], the f32 output sums [rq][dh], each row's max and sum of
// exponentials. None of it grows with Lq or Lk.
struct KeysSmem {
  size_t k, v, p, acc, m, l, total;
};
__host__ __device__ inline KeysSmem keys_layout(int rq, int ck, int dh, size_t tsize) {
  KeysSmem s;
  s.k = t2l::align16(tsize * (size_t)rq * dh);
  s.v = s.k + t2l::align16(tsize * (size_t)ck * dh);
  s.p = s.v + t2l::align16(tsize * (size_t)ck * dh);
  s.acc = s.p + t2l::align16(sizeof(float) * (size_t)rq * ck);
  s.m = s.acc + t2l::align16(sizeof(float) * (size_t)rq * dh);
  s.l = s.m + t2l::align16(sizeof(float) * (size_t)rq);
  s.total = s.l + t2l::align16(sizeof(float) * (size_t)rq);
  return s;
}

// Shared bytes of the core's layout as the caller planned it
// (ops/cuda_mha.py core_layout): the one-block core for rq = 0, else the
// key-tiled core with rq query rows and key chunks of ck rows; 0 where the
// layout is malformed or exceeds a block's shared memory.
inline size_t core_layout_smem(int lq, int lk, int dh, size_t tsize, int rq, int ck) {
  if (rq < 0 || (rq > 0 && ck <= 0)) return 0;
  const size_t need =
      rq == 0 ? core_smem(lq, lk, dh, tsize) : keys_layout(rq, ck, dh, tsize).total;
  return need <= kSmemLimit ? need : 0;
}

// The score of query row qi of qs against key row kj of ks plus the key
// bias, by one warp (lane-strided sums, then the butterfly), as the
// one-block core forms it; every lane holds the result.
template <typename T>
__device__ __forceinline__ float score(const T* qr, const T* kr, int dh, float bias) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int e = lane; e < dh; e += 32) acc += t2l::to_f(qr[e]) * t2l::to_f(kr[e]);
  return t2l::warp_sum(acc) + bias;
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
    const float sc = score(qs + qi * dh, ks + kj * dh, dh, kbias_b[kj]);
    if (lane == 0) ps[pair] = sc;
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

// The key-tiled core, for a head whose q, k, v and probabilities exceed a
// block's shared memory: one block per (sample, head, tile of rq query
// rows), k and v streamed through shared memory in chunks of ck keys. The
// function is the one-block core's: the f32 score plus the key bias, the
// f32 softmax normalised and then rounded to T, o = round_T(p v). Online
// softmax would round the unnormalised p, a different function, so the
// block sweeps the key chunks three times: the rows' max; their sums of
// exp(s - max), in key order (the one-block core's sum); then p =
// round_T(exp(s - max) / sum) and the output sums, carried in f32 from one
// chunk to the next in key order. An all-masked sample attends uniformly
// over its own keys, as in the one-block core.
template <typename T>
__global__ void __launch_bounds__(kCoreThreads)
    attention_core_keys_kernel(const T* __restrict__ q, int ldq, const T* __restrict__ k,
                               const T* __restrict__ v, int ldkv,
                               const float* __restrict__ kbias, T* __restrict__ o, int ldo,
                               int lq, int lk, int dh, int heads, int rq, int ck) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const KeysSmem lay = keys_layout(rq, ck, dh, sizeof(T));
  T* qs = reinterpret_cast<T*>(smem_raw);              // [rq][dh]
  T* ks = reinterpret_cast<T*>(smem_raw + lay.k);      // [ck][dh]
  T* vs = reinterpret_cast<T*>(smem_raw + lay.v);      // [ck][dh]
  float* ps = reinterpret_cast<float*>(smem_raw + lay.p);     // [rq][ck]
  float* acc = reinterpret_cast<float*>(smem_raw + lay.acc);  // [rq][dh]
  float* ms = reinterpret_cast<float*>(smem_raw + lay.m);     // [rq]
  float* ls = reinterpret_cast<float*>(smem_raw + lay.l);     // [rq]

  const int qtiles = (lq + rq - 1) / rq;
  const int qt = blockIdx.x % qtiles, bh = blockIdx.x / qtiles;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * rq, nr = min(rq, lq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const T* qb = q + ((size_t)b * lq + q0) * ldq + h * dh;
  const T* kb_ = k + (size_t)b * lk * ldkv + h * dh;
  const T* vb = v + (size_t)b * lk * ldkv + h * dh;
  const float* kbias_b = kbias + (size_t)b * lk;

  for (int i = tid; i < nr * dh; i += blockDim.x) {
    qs[i] = qb[(size_t)(i / dh) * ldq + i % dh];
    acc[i] = 0.f;
  }
  for (int row = tid; row < nr; row += blockDim.x) {
    ms[row] = -INFINITY;
    ls[row] = 0.f;
  }
  for (int sweep = 0; sweep < 3; ++sweep) {
    for (int c0 = 0; c0 < lk; c0 += ck) {
      const int nk = min(ck, lk - c0);
      __syncthreads();  // the chunk before is consumed
      for (int i = tid; i < nk * dh; i += blockDim.x) {
        const size_t g = (size_t)(c0 + i / dh) * ldkv + i % dh;
        ks[i] = kb_[g];
        if (sweep == 2) vs[i] = vb[g];
      }
      __syncthreads();
      for (int pair = warp; pair < nr * nk; pair += nwarps) {
        const int qi = pair / nk, kj = pair - qi * nk;
        const float sc = score(qs + qi * dh, ks + kj * dh, dh, kbias_b[c0 + kj]);
        if (lane == 0) ps[qi * ck + kj] = sc;
      }
      __syncthreads();
      for (int row = tid; row < nr; row += blockDim.x) {
        float* pr = ps + (size_t)row * ck;
        if (sweep == 0) {
          float m = ms[row];
          for (int j = 0; j < nk; ++j) m = fmaxf(m, pr[j]);
          ms[row] = m;
        } else if (sweep == 1) {
          float sum = ls[row];
          for (int j = 0; j < nk; ++j) sum += expf(pr[j] - ms[row]);
          ls[row] = sum;
        } else {
          for (int j = 0; j < nk; ++j) pr[j] = t2l::round_to<T>(expf(pr[j] - ms[row]) / ls[row]);
        }
      }
      if (sweep == 2) {
        __syncthreads();
        for (int i = tid; i < nr * dh; i += blockDim.x) {
          const int qi = i / dh, c = i - qi * dh;
          const float* pr = ps + (size_t)qi * ck;
          float a = acc[i];
          for (int j = 0; j < nk; ++j) a += pr[j] * t2l::to_f(vs[j * dh + c]);
          acc[i] = a;
        }
      }
    }
  }
  __syncthreads();
  T* ob = o + ((size_t)b * lq + q0) * ldo + h * dh;
  for (int i = tid; i < nr * dh; i += blockDim.x)
    ob[(size_t)(i / dh) * ldo + i % dh] = t2l::from_f<T>(acc[i]);
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
                 const void* kbias, void* o, int b, int lq, int lk, int d, int heads, int rq,
                 int ck, cudaStream_t st) {
  const int dh = d / heads;
  const size_t smem = core_layout_smem(lq, lk, dh, sizeof(T), rq, ck);
  if (smem == 0) return cudaErrorInvalidValue;
  if (b <= 0 || lq <= 0) return cudaSuccess;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* kb = static_cast<const float*>(kbias);
  T* op = static_cast<T*>(o);
  if (rq == 0) {
    auto kern = attention_core_kernel<T>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kern<<<b * heads, kCoreThreads, smem, st>>>(qp, ldq, kp, vp, ldkv, kb, op, d, lq, lk, dh,
                                                heads);
    return cudaGetLastError();
  }
  auto kern = attention_core_keys_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int qtiles = (lq + rq - 1) / rq;
  kern<<<b * heads * qtiles, kCoreThreads, smem, st>>>(qp, ldq, kp, vp, ldkv, kb, op, d, lq, lk,
                                                       dh, heads, rq, ck);
  return cudaGetLastError();
}

template <typename T>
cudaError_t block(const void* x, const void* kv, const void* kbias, const void* wqkv,
                  const void* bqkv, const void* wo, const void* bo, const void* gamma,
                  const void* beta, void* out, void* qkv, void* o, void* s2, int b, int lq,
                  int lk, int d, int heads, int rq, int ck, float scale, float eps,
                  int self_attn, cudaStream_t st) {
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
  if (e == cudaSuccess) e = core<T>(qp, ldq, kp, vp, ldkv, kbias, o, b, lq, lk, d, heads, rq, ck, st);
  if (e == cudaSuccess) e = gemm<T>(o, d, wo, d, bo, s2, d, x, d, m, d, d, 0, 1.f, st);
  if (e == cudaSuccess) e = t2l::rows::layernorm<T>(s2, gamma, beta, out, m, d, eps, st);
  return e;
}

}  // namespace

extern "C" {

// Shared bytes of the attention core's layout (rq = 0: the one-block core,
// else the key-tiled core's query rows rq and key chunk ck); 0 where the
// kernels refuse it.
size_t t2l_mha_tiled_core_smem(int lq, int lk, int d, int heads, int rq, int ck, int dtype) {
  return core_layout_smem(lq, lk, d / heads, dtype == t2l::kBF16 ? 2 : 4, rq, ck);
}

// The whole block. x [b,lq,d] T, kv [b,lk,d] T (ignored when self_attn),
// kbias [b,lk] f32, wqkv [d,3d] T ([Wq|Wk|Wv], [in, out]), bqkv [3d] f32,
// wo [d,d] T, bo/gamma/beta [d] f32 -> out [b,lq,d] T. Scratch: qkv
// (b*lq*3d T when self_attn, else b*lq*d + b*lk*2d), o [b*lq, d] T,
// s2 [b*lq, d] f32. (rq, ck): the attention core's layout, as
// t2l_mha_tiled_core_smem takes it.
int t2l_mha_addln_tiled(const void* x, const void* kv, const void* kbias, const void* wqkv,
                        const void* bqkv, const void* wo, const void* bo,
                        const void* gamma, const void* beta, void* out, void* qkv, void* o,
                        void* s2, int b, int lq, int lk, int d, int heads, int rq, int ck,
                        float scale, float eps, int self_attn, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)block<__nv_bfloat16>(x, kv, kbias, wqkv, bqkv, wo, bo, gamma, beta, out,
                                     qkv, o, s2, b, lq, lk, d, heads, rq, ck, scale, eps,
                                     self_attn, st);
  return (int)block<float>(x, kv, kbias, wqkv, bqkv, wo, bo, gamma, beta, out, qkv, o, s2,
                           b, lq, lk, d, heads, rq, ck, scale, eps, self_attn, st);
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

// (b): q rows of stride ldq, k and v rows of stride ldkv -> o [b*lq, d],
// with the core's layout (rq, ck).
int t2l_mha_tiled_core(const void* q, int ldq, const void* k, const void* v, int ldkv,
                       const void* kbias, void* o, int b, int lq, int lk, int d, int heads,
                       int rq, int ck, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)core<__nv_bfloat16>(q, ldq, k, v, ldkv, kbias, o, b, lq, lk, d, heads, rq, ck,
                                    st);
  return (int)core<float>(q, ldq, k, v, ldkv, kbias, o, b, lq, lk, d, heads, rq, ck, st);
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
