// Backward of the training set-abstraction level with e rounded to bf16
// (the token "e"; the forward is sa_train_e_fwd.cu): the three passes of
// sa_train_bwd.cu (kernels in sa_train_bwd.cuh) with e recomputed and
// rounded as the forward rounds it. The gradients flow through the rounding
// unchanged (du is the scatter of de, dsv = -sum_k de), as in the JAX
// kernel.
//
// Replaces the TPU kernels text2loc_tpu/ops/pallas_sa_train.py
// (_k_bwd_statse :469, _k_bwd_mide :504, _k_bwd_ine :544; driven by
// _backward_e :825 at cache_dtype=bfloat16, token "e").
//
// What bounds it on the H100: as the recompute backward, the products on
// the FP32 pipes; the rounding adds one cvt per element of e per pass.
#include "sa_train_bwd.cuh"

extern "C" {

size_t t2l_sa_train_smem(int with_du, int p, int k, int h1, int h2, int rpt);

// As t2l_sa_train_bwd (sa_train_bwd.cu), with e rounded to bf16.
int t2l_sa_train_e_bwd(int pass, const void* u, const void* sv, const void* idx,
                       const void* mm, const void* mf, const void* w2, const void* w2t,
                       const void* aux1, const void* aux2, const void* dout, void* out0,
                       void* out1, void* out2, int n, int p, int s, int k, int h1, int h2,
                       int rpt, int blocks, int dtype, void* stream) {
  Args a{static_cast<const float*>(u), static_cast<const float*>(sv),
         static_cast<const int*>(idx), static_cast<const uint8_t*>(mm),
         static_cast<const uint8_t*>(mf), w2, w2t,
         static_cast<const float*>(aux1), static_cast<const float*>(aux2),
         static_cast<const float*>(dout), n, p, s, k, h1, h2, rpt};
  const size_t smem = t2l_sa_train_smem(pass == 3, p, k, h1, h2, rpt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return backward_pass<__nv_bfloat16, true>(pass, a, out0, out1, out2, blocks, smem, st);
  return backward_pass<float, true>(pass, a, out0, out1, out2, blocks, smem, st);
}

}  // extern "C"
