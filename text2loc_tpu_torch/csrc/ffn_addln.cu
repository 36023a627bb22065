// Post-LN feed-forward block over a tile of rows:
//   out = LayerNorm(x + relu(x @ W1 + b1) @ W2 + b2) * gamma + beta
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_ffn.py
// (_ffn_addln_kernel :31 / fused_ffn_addlayernorm :47).
//
// Numerics follow the TPU kernel: both products sum in f32, the hidden is
// relu'd in f32 and rounded to the compute dtype, the residual sum and the
// LayerNorm statistics are f32, the output is in the compute dtype.
//
// What bounds it on the H100: 2 * D * F multiply-adds per row (D = 128 or
// 256, F = 512 or 1024) against D * 2 bytes in and out, so the block is
// bound by arithmetic and by re-reading W1 and W2 (up to 1 MB in bf16) from
// L2 for every tile of rows.
// What the design does about it: the [rows, F] hidden never leaves shared
// memory (stored in the compute dtype, which is what the second product
// reads), neither does the pre-norm sum, and each weight element is read once
// per tile of 16 rows with the 16 partial sums in registers. The products run
// on the FP32 pipes; a later PR can tile them for wgmma.
#include "common.cuh"

namespace {

constexpr int kTileRows = 16;

struct Layout {
  size_t xs, hs, s2, total;
};

__host__ __device__ inline Layout make_layout(int d, int f, size_t tsize) {
  Layout l;
  size_t off = 0;
  l.xs = off;
  off = t2l::align16(off + tsize * (size_t)kTileRows * d);
  l.hs = off;
  off = t2l::align16(off + tsize * (size_t)kTileRows * f);
  l.s2 = off;
  off = t2l::align16(off + sizeof(float) * (size_t)kTileRows * d);
  l.total = off;
  return l;
}

template <typename T>
__global__ void ffn_addln_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                                 const float* __restrict__ b1, const T* __restrict__ w2,
                                 const float* __restrict__ b2,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta, T* __restrict__ out,
                                 int rows, int d, int f, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = make_layout(d, f, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem_raw + L.xs);
  T* hs = reinterpret_cast<T*>(smem_raw + L.hs);
  float* s2 = reinterpret_cast<float*>(smem_raw + L.s2);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int row0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, rows - row0);
  const T* xb = x + (size_t)row0 * d;

  for (int i = tid; i < kTileRows * d; i += nthreads)
    xs[i] = i < nrows * d ? xb[i] : t2l::from_f<T>(0.f);
  __syncthreads();

  // Hidden: relu(x @ W1 + b1), rounded to the compute dtype.
  for (int c = tid; c < f; c += nthreads) {
    float acc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[r] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      const float w = t2l::to_f(w1[(size_t)dd * f + c]);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) acc[r] += t2l::to_f(xs[r * d + dd]) * w;
    }
    const float bias = b1[c];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) hs[r * f + c] = t2l::from_f<T>(fmaxf(acc[r] + bias, 0.f));
  }
  __syncthreads();

  // Output product and residual: s2 = (x + h @ W2) + b2, in f32.
  for (int c = tid; c < d; c += nthreads) {
    float acc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[r] = 0.f;
    for (int ff = 0; ff < f; ++ff) {
      const float w = t2l::to_f(w2[(size_t)ff * d + c]);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) acc[r] += t2l::to_f(hs[r * f + ff]) * w;
    }
    const float bias = b2[c];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) s2[r * d + c] = (t2l::to_f(xs[r * d + c]) + acc[r]) + bias;
  }
  __syncthreads();

  const int warp = tid >> 5, nwarps = nthreads >> 5;
  for (int r = warp; r < nrows; r += nwarps)
    t2l::warp_layernorm_row<T>(s2 + (size_t)r * d, d, gamma, beta, eps,
                               out + (size_t)(row0 + r) * d);
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* gamma, const void* beta, void* out, int rows,
           int d, int f, float eps, cudaStream_t stream) {
  const size_t smem = make_layout(d, f, sizeof(T)).total;
  auto kern = ffn_addln_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (rows + kTileRows - 1) / kTileRows;
  kern<<<blocks, 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), rows, d, f, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t t2l_ffn_addln_smem(int d, int f, int dtype) {
  return make_layout(d, f, dtype == t2l::kBF16 ? 2 : 4).total;
}

// x [rows,d] T, w1 [d,f] T, b1 [f] f32, w2 [f,d] T, b2/gamma/beta [d] f32
// -> out [rows,d] T.
int t2l_ffn_addln(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* gamma, const void* beta, void* out,
                  int rows, int d, int f, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, gamma, beta, out, rows, d, f, eps,
                                 st);
  return launch<float>(x, w1, b1, w2, b2, gamma, beta, out, rows, d, f, eps, st);
}

}  // extern "C"
