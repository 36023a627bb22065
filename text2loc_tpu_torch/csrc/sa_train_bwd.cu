// Hand-derived backward of the training set-abstraction level (the
// forward is sa_train_fwd.cu): three passes over the recomputed edge
// pipeline, given dout [N, S, H2].
//
// Replaces the TPU kernels text2loc_tpu/ops/pallas_sa_train.py
// (_k_bwd_stats :246, _k_bwd_mid :272, _k_bwd_in :324; driven by
// _backward :978, and the cached-edge _backward_e :825 at cache dtype f32).
//
//   dh2 = dout * eq / cnt        (neighbour-max ties share evenly)
//   dy2 = dh2 * [y2 > 0]
//   dz  = a2 * (dy2 - maskf * (A2/n + yhat2 * B2/n)),  A = sum dy, B = sum dy*yhat
//   dh1 = dz @ W2^T,  dy1 = dh1 * [y1 > 0]
//   de  = a1 * (dy1 - maskf * (A1/n + yhat1 * B1/n))
//   du[n, idx] += de,  dsv = -sum_k de,  dW2 = sum h1^T dz,  db2 = sum dz
//   dgamma = B, dbeta = A
// The correction sums run over ALL edges; only maskf edges receive them.
//
// What bounds it on the H100: the products, 2 * E * H1 * H2 FLOPs for each
// of z (recomputed by all three passes), dh1 (two passes) and dW2, on the
// FP32 pipes; bytes are a few hundred MB at the coarse step's shapes.
// What the design does about it: as the forward, every edge quantity lives
// only in shared memory and registers. Pass 1 sums A2/B2, pass 2 sums
// A1/B1, db2 and dW2 (each block owns a [H1, H2] partial in device memory,
// read-modified-written only by its own threads, so no atomics), pass 3
// scatters de into the block's cloud's du held in shared memory: thread c
// walks the tile's edges in index order, so the scatter is deterministic.
// Partials are summed by t2l_sa_train_reduce (sa_train_fwd.cu) in a fixed
// order.
#include "sa_train_bwd.cuh"

extern "C" {

size_t t2l_sa_train_smem(int with_du, int p, int k, int h1, int h2, int rpt);

// pass 1: out0 [blocks, 2, h2] partial (sum dy2, sum dy2 * yhat2)
// pass 2: out0 [blocks, 2, h1] partial (sum dy1, sum dy1 * yhat1),
//         out1 [blocks, h1, h2] partial dW2, out2 [blocks, h2] partial db2
// pass 3: out0 du [n, p, h1] f32, out1 dsv [n, s, h1] f32
// The inputs as t2l_sa_train_fwd's, plus w2t [h2, h1] in the compute dtype
// and dout [n, s, h2] f32; aux rows 4-5 hold the correction sums / n of
// the passes before.
int t2l_sa_train_bwd(int pass, const void* u, const void* sv, const void* idx,
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
    return backward_pass<__nv_bfloat16, false>(pass, a, out0, out1, out2, blocks, smem, st);
  return backward_pass<float, false>(pass, a, out0, out1, out2, blocks, smem, st);
}

}  // extern "C"
