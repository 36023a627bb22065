// Backward of the training set-abstraction level with e rounded to bf16
// (the token "e"; the forward is sa_train_e_fwd.cu): the three passes of
// sa_train_bwd.cu (kernels in sa_train_bwd.cuh) with e recomputed and
// rounded as the forward rounds it, wherever a pass forms it. The
// gradients flow through the rounding unchanged (du is the scatter of de,
// dsv = -sum_k de), as in the JAX kernel.
//
// Replaces the TPU kernels text2loc_tpu/ops/pallas_sa_train.py
// (_k_bwd_statse :469, _k_bwd_mide :504, _k_bwd_ine :544; driven by
// _backward_e :825 at cache_dtype=bfloat16, token "e").
//
// What bounds it on the H100, and the design: those of sa_train_bwd.cu;
// the rounding adds one cvt per element of e where it is formed.
#include "sa_train_bwd.cuh"

extern "C" {

// As t2l_sa_train_bwd (sa_train_bwd.cu), with e rounded to bf16; shared
// memory as t2l_sa_train_bwd_smem gives it.
int t2l_sa_train_e_bwd(int pass, const void* u, const void* sv, const void* idx,
                       const void* mm, const void* mf, const void* w2, const void* w2t,
                       const void* aux1, const void* aux2, const void* dout, void* out0,
                       void* out1, void* out2, int n, int p, int s, int k, int h1, int h2,
                       int rows, int resident, int blocks, int dtype, void* stream) {
  return t2l::sat::entry<true>(pass, u, sv, idx, mm, mf, w2, w2t, aux1, aux2, dout, out0,
                               out1, out2, n, p, s, k, h1, h2, rows, resident, blocks, dtype,
                               stream, nullptr);
}

// As t2l_sa_train_bwd_occupancy (sa_train_bwd.cu).
int t2l_sa_train_e_bwd_occupancy(int pass, int p, int k, int h1, int h2, int rows,
                                 int resident, int dtype, void* out) {
  return t2l::sat::entry<true>(pass, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                               0, p, 0, k, h1, h2, rows, resident, 0, dtype, nullptr,
                               static_cast<int*>(out));
}

}  // extern "C"
