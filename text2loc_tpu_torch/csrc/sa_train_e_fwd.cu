// Training forward of one PointConv set-abstraction level with e rounded to
// bf16 (the token "e"): the passes of sa_train_fwd.cu (kernels in
// sa_train_fwd.cuh) with e = bf16(round(u[idx]) - sv) in every pass, so the
// BN1 statistics, h1 and z are all taken of the rounded e.
//
// Replaces the TPU kernels text2loc_tpu/ops/pallas_sa_train.py
// (_k_stats1e :383, _k_stats2e :409, _k_oute :426; driven by _forward_e
// :740 at cache_dtype=bfloat16, token "e").
//
// What bounds it on the H100, and the design: those of sa_train_fwd.cu.
// The TPU kernel writes the rounded e to an HBM cache in its first pass to
// spare the later passes a one-hot MXU gather; here every pass loads u[idx]
// through L2 and rounds its own e (one cvt per element), so no [N, S*K, H1]
// cache is written or read.
#include "sa_train_fwd.cuh"

extern "C" {

// As t2l_sa_train_fwd (sa_train_fwd.cu), with e rounded to bf16; shared
// memory as t2l_sa_train_fwd_smem gives it.
int t2l_sa_train_e_fwd(int pass, const void* u, const void* sv, const void* idx,
                       const void* mm, const void* mf, const void* w2, const void* aux1,
                       const void* aux2, void* out0, int n, int p, int s, int k, int h1,
                       int h2, int rows, int resident, int blocks, int dtype, void* stream) {
  return t2l::sat::fwd_entry<true>(pass, u, sv, idx, mm, mf, w2, aux1, aux2, out0, n, p, s,
                                   k, h1, h2, rows, resident, blocks, dtype, stream, nullptr);
}

// As t2l_sa_train_fwd_occupancy (sa_train_fwd.cu).
int t2l_sa_train_e_fwd_occupancy(int pass, int p, int k, int h1, int h2, int rows,
                                 int resident, int dtype, void* out) {
  return t2l::sat::fwd_entry<true>(pass, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, nullptr, 0, p, 0, k, h1, h2,
                                   rows, resident, 0, dtype, nullptr, static_cast<int*>(out));
}

}  // extern "C"
