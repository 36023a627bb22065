// Post-LN multi-head attention block, one block per sample:
//   out = LayerNorm(x + MHA(x, kv) @ Wo + bo) * gamma + beta
// with the q/k/v and output projections inside the kernel.
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_mha.py
// (_mha_block_kernel :44 / fused_mha_addlayernorm :137).
//
// Numerics follow the TPU kernel: projections sum in f32; q = (x Wq + bq) /
// sqrt(dh), k, v rounded to the compute dtype before the score and AV
// products; key mask as an additive -1e9 bias; softmax in f32 and rounded
// before AV; the attention output rounded before the out-projection; the
// residual sum and the LayerNorm statistics in f32.
//
// What bounds it on the H100: at the CCT's shapes (D = 128, L = 16 and 6) a
// sample is a few hundred thousand multiply-adds, so launch and the weight
// reads dominate; at the intra stack's D = 1024 (16 tokens, 1584 sentences)
// the four D x D projections are 67 M multiply-adds per sample and the
// block streams 8 MB of bf16 weights through L2 for each sample.
// What the design does about it: all intermediates (q, k, v, scores, the
// attention output and the pre-norm sum) live in shared memory, so a block
// reads x, kv and the weights and writes only the normalized rows; every
// projection keeps eight rows of partial sums in registers per weight load,
// so each weight element is read from L2 once per eight rows; the products
// run on the FP32 pipes (a later PR can tile the projections for wgmma and
// put several samples in a block to reuse the weights).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 8;  // rows of partial sums per weight load

// dst[r][c] = round_T((sum_d src[r][d] * W[d][c] + bias[c]) * scale)
template <typename T>
__device__ void project_rows(const T* src, int rows, int d, const T* __restrict__ w,
                             const float* __restrict__ bias, float scale, T* dst) {
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float b = bias[c];
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        const float wv = t2l::to_f(w[(size_t)dd * d + c]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < rows) acc[r] += t2l::to_f(src[(r0 + r) * d + dd]) * wv;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r0 + r < rows) dst[(r0 + r) * d + c] = t2l::from_f<T>((acc[r] + b) * scale);
    }
  }
}

struct Layout {
  size_t xs, kvs, qs, ks, vs, ps, s2, total;
};

__host__ __device__ inline Layout make_layout(int lq, int lk, int d, int heads,
                                              int self_attn, size_t tsize) {
  Layout l;
  size_t off = 0;
  l.xs = off;
  off = t2l::align16(off + tsize * (size_t)lq * d);
  l.kvs = self_attn ? l.xs : off;
  if (!self_attn) off = t2l::align16(off + tsize * (size_t)lk * d);
  l.qs = off;
  off = t2l::align16(off + tsize * (size_t)lq * d);
  l.ks = off;
  off = t2l::align16(off + tsize * (size_t)lk * d);
  l.vs = off;
  off = t2l::align16(off + tsize * (size_t)lk * d);
  l.ps = off;
  off = t2l::align16(off + sizeof(float) * (size_t)heads * lq * lk);
  l.s2 = off;
  off = t2l::align16(off + sizeof(float) * (size_t)lq * d);
  l.total = off;
  return l;
}

template <typename T>
__global__ void mha_addln_kernel(
    const T* __restrict__ x, const T* __restrict__ kv, const float* __restrict__ kbias,
    const T* __restrict__ wq, const float* __restrict__ bq, const T* __restrict__ wk,
    const float* __restrict__ bk, const T* __restrict__ wv, const float* __restrict__ bv,
    const T* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ gamma, const float* __restrict__ beta, T* __restrict__ out,
    int lq, int lk, int d, int heads, float scale, float eps, int self_attn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = make_layout(lq, lk, d, heads, self_attn, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem_raw + L.xs);
  T* kvs = reinterpret_cast<T*>(smem_raw + L.kvs);
  T* qs = reinterpret_cast<T*>(smem_raw + L.qs);  // q, later the attention output
  T* ks = reinterpret_cast<T*>(smem_raw + L.ks);
  T* vs = reinterpret_cast<T*>(smem_raw + L.vs);
  float* ps = reinterpret_cast<float*>(smem_raw + L.ps);  // [heads][lq][lk]
  float* s2 = reinterpret_cast<float*>(smem_raw + L.s2);  // [lq][d]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int dh = d / heads;
  const T* xb = x + (size_t)b * lq * d;
  const T* kvb = kv + (size_t)b * lk * d;
  const float* kb = kbias + (size_t)b * lk;

  for (int i = tid; i < lq * d; i += nthreads) xs[i] = xb[i];
  if (!self_attn)
    for (int i = tid; i < lk * d; i += nthreads) kvs[i] = kvb[i];
  __syncthreads();

  project_rows<T>(xs, lq, d, wq, bq, scale, qs);
  project_rows<T>(kvs, lk, d, wk, bk, 1.0f, ks);
  project_rows<T>(kvs, lk, d, wv, bv, 1.0f, vs);
  __syncthreads();

  // Scores per head, plus the additive key bias.
  for (int i = tid; i < heads * lq * lk; i += nthreads) {
    const int h = i / (lq * lk);
    const int rem = i - h * lq * lk;
    const int qi = rem / lk, kj = rem - qi * lk;
    const T* qr = qs + qi * d + h * dh;
    const T* kr = ks + kj * d + h * dh;
    float acc = 0.f;
    for (int e = 0; e < dh; ++e) acc += t2l::to_f(qr[e]) * t2l::to_f(kr[e]);
    ps[i] = acc + kb[kj];
  }
  __syncthreads();

  // Softmax over the keys (f32), rounded to the compute dtype.
  for (int row = tid; row < heads * lq; row += nthreads) {
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

  // Attention output, written over q (no longer needed).
  for (int i = tid; i < lq * d; i += nthreads) {
    const int qi = i / d, col = i - qi * d;
    const int h = col / dh;
    const float* pr = ps + ((size_t)h * lq + qi) * lk;
    float acc = 0.f;
    for (int j = 0; j < lk; ++j) acc += pr[j] * t2l::to_f(vs[j * d + col]);
    qs[i] = t2l::from_f<T>(acc);
  }
  __syncthreads();

  // Out-projection and residual: s2 = (x + o @ Wo) + bo, in f32.
  for (int c = tid; c < d; c += nthreads) {
    const float bias_c = bo[c];
    for (int r0 = 0; r0 < lq; r0 += kRows) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        const float wv_ = t2l::to_f(wo[(size_t)dd * d + c]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < lq) acc[r] += t2l::to_f(qs[(r0 + r) * d + dd]) * wv_;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r0 + r < lq)
          s2[(r0 + r) * d + c] = (t2l::to_f(xs[(r0 + r) * d + c]) + acc[r]) + bias_c;
    }
  }
  __syncthreads();

  const int warp = tid >> 5, nwarps = nthreads >> 5;
  T* ob = out + (size_t)b * lq * d;
  for (int r = warp; r < lq; r += nwarps)
    t2l::warp_layernorm_row<T>(s2 + (size_t)r * d, d, gamma, beta, eps, ob + (size_t)r * d);
}

template <typename T>
int launch(const void* x, const void* kv, const void* kbias, const void* wq,
           const void* bq, const void* wk, const void* bk, const void* wv,
           const void* bv, const void* wo, const void* bo, const void* gamma,
           const void* beta, void* out, int b, int lq, int lk, int d, int heads,
           float scale, float eps, int self_attn, cudaStream_t stream) {
  const size_t smem = make_layout(lq, lk, d, heads, self_attn, sizeof(T)).total;
  auto kern = mha_addln_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<b, 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(kv),
      static_cast<const float*>(kbias), static_cast<const T*>(wq),
      static_cast<const float*>(bq), static_cast<const T*>(wk),
      static_cast<const float*>(bk), static_cast<const T*>(wv),
      static_cast<const float*>(bv), static_cast<const T*>(wo),
      static_cast<const float*>(bo), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), lq, lk, d, heads, scale,
      eps, self_attn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t t2l_mha_addln_smem(int lq, int lk, int d, int heads, int self_attn, int dtype) {
  return make_layout(lq, lk, d, heads, self_attn, dtype == t2l::kBF16 ? 2 : 4).total;
}

// x [b,lq,d] T, kv [b,lk,d] T (ignored when self_attn: kv is x), kbias [b,lk]
// f32 additive key bias, wq/wk/wv/wo [d,d] T ([in, out]), biases/gamma/beta
// [d] f32 -> out [b,lq,d] T.
int t2l_mha_addln(const void* x, const void* kv, const void* kbias, const void* wq,
                  const void* bq, const void* wk, const void* bk, const void* wv,
                  const void* bv, const void* wo, const void* bo, const void* gamma,
                  const void* beta, void* out, int b, int lq, int lk, int d,
                  int heads, float scale, float eps, int self_attn, int dtype,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return launch<__nv_bfloat16>(x, kv, kbias, wq, bq, wk, bk, wv, bv, wo, bo, gamma,
                                 beta, out, b, lq, lk, d, heads, scale, eps, self_attn,
                                 st);
  return launch<float>(x, kv, kbias, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, out,
                       b, lq, lk, d, heads, scale, eps, self_attn, st);
}

}  // extern "C"
