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
// byte at f32. What the design does about it: one warp per row, the whole
// row in registers (D / 32 values per lane), so x and res are read once and
// the output written once, with no shared memory and no padding of the row
// count (the TPU kernel pads rows to its 512-row tile).
#include "common.cuh"

namespace {

using t2l::from_f;
using t2l::to_f;
using t2l::warp_sum;

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T, int VPL>  // VPL: values per lane, D = 32 * VPL
__global__ void __launch_bounds__(kThreads)
    add_ln_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  T* __restrict__ out, int rows, float eps) {
  constexpr int D = 32 * VPL;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const size_t base = (size_t)row * D;
  float v[VPL];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + 32 * j;
    v[j] = to_f<T>(x[base + c]) + to_f<T>(res[base + c]);
    s += v[j];
  }
  const float mu = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const float t = v[j] - mu;
    q += t * t;
  }
  const float inv = rsqrtf(warp_sum(q) / (float)D + eps);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + 32 * j;
    out[base + c] = from_f<T>((v[j] - mu) * inv * scale[c] + bias[c]);
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* scale, const void* bias, void* out,
           int rows, int d, float eps, cudaStream_t st) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const float* gp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  switch (d) {
    case 128: add_ln_kernel<T, 4><<<blocks, kThreads, 0, st>>>(xp, rp, gp, bp, op, rows, eps); break;
    case 256: add_ln_kernel<T, 8><<<blocks, kThreads, 0, st>>>(xp, rp, gp, bp, op, rows, eps); break;
    case 512: add_ln_kernel<T, 16><<<blocks, kThreads, 0, st>>>(xp, rp, gp, bp, op, rows, eps); break;
    case 1024: add_ln_kernel<T, 32><<<blocks, kThreads, 0, st>>>(xp, rp, gp, bp, op, rows, eps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, res, out [rows, d] in the dtype (f32 or bf16), scale / bias [d] f32;
// d in {128, 256, 512, 1024}.
int t2l_add_ln(const void* x, const void* res, const void* scale, const void* bias,
               void* out, int rows, int d, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return launch<__nv_bfloat16>(x, res, scale, bias, out, rows, d, eps, st);
  return launch<float>(x, res, scale, bias, out, rows, d, eps, st);
}

}  // extern "C"
