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
// Pass 1 sums A2/B2 (z), pass 2 A1/B1, db2 and dW2 (z, dh1, dW2), pass 3
// forms de and scatters it (z, dh1).
//
// What bounds it on the H100: the six products of 2 * E * H1 * H2 FLOPs
// each (z in every pass, dh1 in two, dW2 in one) over the valid edges E;
// the bytes (u, sv, indices, masks, dout, du, dsv: about 0.1 GB at the
// coarse step's shapes) are far below that on the tensor cores. The design
// before this one ran the products on the FP32 pipes with W2 read from L2
// by every warp on every k-step, a read-modify-write of the block's whole
// [H1, H2] dW2 partial after every tile, 8 warps per SM and a du scatter on
// H1 threads; its time followed the tile count, not the edges.
// What this design does about it (kernels in sa_train_bwd.cuh):
// - the products run on mma.sync: bf16 m16n8k16 on the bf16 operands, f32
//   as 3xTF32 (hi/lo split, three m16n8k8 TF32 products, f32 sums; no f32
//   operand is rounded to TF32 alone);
// - W2 and W2^T sit in shared memory for the whole kernel where they fit,
//   else stream in 32-row chunks through a two-stage cp.async ring;
// - a persistent grid (the blocks one wave of SMs holds) accumulates dW2
//   in the mma fragments over all of a block's tiles and writes it once;
//   at widths above 128 (256 x 256 would take the whole register file) the
//   fragments are added into the block's partial after each tile, in
//   chunks of 4 row tiles;
// - the kernels are instantiated per width class, so a narrow level holds
//   fewer accumulators, runs 2 blocks per SM and takes 128-row tiles;
// - the neighbour max takes one thread per (center, column) over the
//   tile's values in shared memory; the column sums reduce across a
//   warp's lanes (a column lies in one warp); e is recomputed from u and
//   sv where dh1's ReLU needs it;
// - pass 3 spreads the du scatter over all 256 threads, each (point,
//   column) owned by one thread that adds the tile's rows in row order.
// Per-block partials are summed by t2l_sa_train_reduce (sa_train_fwd.cu) in
// block order: two runs give bit-equal results, and no float atomics are
// used. Measured on the H100 (PERF.md §5), the products no longer take most
// of the time: the tile loads, the neighbour max and the e epilogue,
// latency-bound between barriers at one block per SM for the wide levels,
// and at H=256 the per-tile dW2 read-modify-write cost more.
#include "sa_train_bwd.cuh"

extern "C" {

// Dynamic shared memory of one block of a backward pass (1-3) at tile
// height rows, with W2 resident (1) or streamed (0); dtype 0 f32, 1 bf16.
// The largest size_t where the level's kernels take no such tile height.
size_t t2l_sa_train_bwd_smem(int pass, int p, int h1, int h2, int rows, int resident,
                             int dtype) {
  if (rows > t2l::sat::max_rows(h1, h2)) return ~static_cast<size_t>(0);  // no such tile
  return t2l::sat::bwd_layout(pass, p, h1, h2, rows, resident, dtype == t2l::kBF16 ? 2 : 4,
                              nullptr, nullptr);
}

// pass 1: out0 [blocks, 2, h2] partial (sum dy2, sum dy2 * yhat2)
// pass 2: out0 [blocks, 2, h1] partial (sum dy1, sum dy1 * yhat1),
//         out1 [blocks, h1, h2] partial dW2, out2 [blocks, h2] partial db2
// pass 3: out0 du [n, p, h1] f32, out1 dsv [n, s, h1] f32
// u [n,p,h1] f32, sv [n,s,h1] f32, idx [n,s,k] int32, mm/mf [n,s,k] bool,
// w2 [h1,h2] and w2t [h2,h1] in the compute dtype, aux1 [8,h1], aux2
// [8,h2] f32 (rows 4-5: the correction sums / n of the passes before),
// dout [n,s,h2] f32. rows: the tile height (a multiple of 16 in [k, 128],
// at most 64 where a width exceeds 128);
// resident: W2 held in shared memory (else streamed).
int t2l_sa_train_bwd(int pass, const void* u, const void* sv, const void* idx,
                     const void* mm, const void* mf, const void* w2, const void* w2t,
                     const void* aux1, const void* aux2, const void* dout, void* out0,
                     void* out1, void* out2, int n, int p, int s, int k, int h1, int h2,
                     int rows, int resident, int blocks, int dtype, void* stream) {
  return t2l::sat::entry<false>(pass, u, sv, idx, mm, mf, w2, w2t, aux1, aux2, dout, out0,
                                out1, out2, n, p, s, k, h1, h2, rows, resident, blocks,
                                dtype, stream, nullptr);
}

// Blocks of the pass's kernel that one SM holds at once -> *out.
int t2l_sa_train_bwd_occupancy(int pass, int p, int k, int h1, int h2, int rows,
                               int resident, int dtype, void* out) {
  return t2l::sat::entry<false>(pass, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, 0, p, 0, k, h1, h2, rows, resident, 0, dtype,
                                nullptr, static_cast<int*>(out));
}


}  // extern "C"
