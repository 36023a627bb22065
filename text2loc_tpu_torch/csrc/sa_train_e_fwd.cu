// Training forward of one PointConv set-abstraction level with e rounded to
// bf16 (the token "e"): the passes of sa_train_fwd.cu (kernels in
// sa_train_fwd.cuh) with e = bf16(round(u[idx]) - sv) in every pass, so the
// BN1 statistics, h1 and z are all taken of the rounded e.
//
// Replaces the TPU kernels text2loc_tpu/ops/pallas_sa_train.py
// (_k_stats1e :383, _k_stats2e :409, _k_oute :426; driven by _forward_e
// :740 at cache_dtype=bfloat16, token "e").
//
// What bounds it on the H100: as the recompute forward, the second edge
// layer on the FP32 pipes. What the design does about it: the TPU kernel
// writes the rounded e to an HBM cache in its first pass to spare the later
// passes a one-hot MXU gather; here the recompute passes load u[idx] through
// L2, so each pass rounds its own e instead (one cvt per element) and no
// [N, S*K, H1] cache is written or read.
#include "sa_train_fwd.cuh"

extern "C" {

size_t t2l_sa_train_smem(int with_du, int p, int k, int h1, int h2, int rpt);

// As t2l_sa_train_fwd (sa_train_fwd.cu), with e rounded to bf16.
int t2l_sa_train_e_fwd(int pass, const void* u, const void* sv, const void* idx,
                       const void* mm, const void* mf, const void* w2, const void* aux1,
                       const void* aux2, void* out0, int n, int p, int s, int k, int h1,
                       int h2, int rpt, int blocks, int dtype, void* stream) {
  Args a{static_cast<const float*>(u), static_cast<const float*>(sv),
         static_cast<const int*>(idx), static_cast<const uint8_t*>(mm),
         static_cast<const uint8_t*>(mf), w2, nullptr,
         static_cast<const float*>(aux1), static_cast<const float*>(aux2), nullptr,
         n, p, s, k, h1, h2, rpt};
  const size_t smem = t2l_sa_train_smem(0, p, k, h1, h2, rpt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16) return forward_pass<__nv_bfloat16, true>(pass, a, out0, blocks, smem, st);
  return forward_pass<float, true>(pass, a, out0, blocks, smem, st);
}

}  // extern "C"
