// Training forward of one PointConv set-abstraction level with batch-
// statistic BatchNorm: the BN1 statistics pass, the BN2 statistics pass and
// the output pass, plus the fixed-order reduction of per-block partial
// sums (which the backward's passes use too).
//
// Replaces the TPU kernels text2loc_tpu/ops/pallas_sa_train.py
// (_k_stats1 :163, _k_stats2 :182, _k_out :200; driven by _forward :625,
// and the cached-edge _forward_e :740 at cache dtype f32, which computes
// the same function).
//
// What bounds it on the H100: the second edge layer, 2 * E * H1 * H2 FLOPs
// in each pass that needs z (the BN2 statistics pass and the output pass)
// over the valid edges E; the bytes (u, sv, indices, masks and the output,
// about 0.1 GB at the coarse step's shapes) are far below that on the
// tensor cores. The design before this one ran z on the FP32 pipes, every
// warp reading W2 from L2 on every k-step, in 64-row tiles of 8 centers.
// What this design does about it (kernels in sa_train_fwd.cuh, tiles in
// sa_train_tiles.cuh):
// - z runs on mma.sync on the backward's tiles: bf16 m16n8k16 on the bf16
//   operands, f32 as 3xTF32 (no f32 operand rounded to TF32 alone), so the
//   forward's z and the backward's agree bit for bit;
// - W2 sits in shared memory for the whole kernel where it fits, else
//   streams in 32-row chunks through a two-stage cp.async ring;
// - tiles of up to 128 rows and 16 centers; the host picks each pass's
//   tile height and W2 layout, and a persistent grid of the blocks one wave
//   of SMs holds, from the occupancy query (ops/cuda_sa_train._plan);
// - the kernels are instantiated per width class, so a narrow level holds
//   fewer accumulators and more blocks per SM;
// - the BN1 pass, which has no product, walks each cloud's maskf edges
//   directly, float4 loads of u[idx] and sv, without tiles.
// Per-block partials are summed by t2l_sa_train_reduce in block order: two
// runs give bit-equal results, and no float atomics are used.
#include "sa_train_fwd.cuh"

namespace {

__global__ void sa_reduce_kernel(const float* __restrict__ part, int nblk, int len,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(size_t)b * len + i];
  out[i] = s;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of a forward pass (1-3) at tile
// height rows, with W2 resident (1) or streamed (0); dtype 0 f32, 1 bf16.
// Pass 1 takes no tiles and no dynamic shared memory (0). The largest
// size_t where the level's kernels take no such tile height.
size_t t2l_sa_train_fwd_smem(int pass, int p, int h1, int h2, int rows, int resident,
                             int dtype) {
  (void)p;
  if (pass != 1 && rows > t2l::sat::max_rows(h1, h2)) return ~static_cast<size_t>(0);
  return t2l::sat::fwd_layout(pass, h1, h2, rows, resident, dtype == t2l::kBF16 ? 2 : 4,
                              nullptr, nullptr);
}

// pass 1: BN1 sums -> out0 [blocks, 2, h1] (sum e, sum e^2 over maskf edges)
// pass 2: BN2 sums -> out0 [blocks, 2, h2] (sum z, sum z^2 over maskf edges)
// pass 3: the level's output -> out0 [n, s, h2] f32
// u [n,p,h1] f32, sv [n,s,h1] f32, idx [n,s,k] int32, mm/mf [n,s,k] bool,
// w2 [h1,h2] in the compute dtype, aux1 [8,h1], aux2 [8,h2] f32. rows: the
// tile height (passes 2-3: a multiple of 16 in [k, 128], at most 64 where a
// width exceeds 128); resident: W2 held in shared memory (else streamed).
int t2l_sa_train_fwd(int pass, const void* u, const void* sv, const void* idx,
                     const void* mm, const void* mf, const void* w2, const void* aux1,
                     const void* aux2, void* out0, int n, int p, int s, int k, int h1,
                     int h2, int rows, int resident, int blocks, int dtype, void* stream) {
  return t2l::sat::fwd_entry<false>(pass, u, sv, idx, mm, mf, w2, aux1, aux2, out0, n, p, s,
                                    k, h1, h2, rows, resident, blocks, dtype, stream,
                                    nullptr);
}

// Blocks of the pass's kernel that one SM holds at once -> *out.
int t2l_sa_train_fwd_occupancy(int pass, int p, int k, int h1, int h2, int rows,
                               int resident, int dtype, void* out) {
  return t2l::sat::fwd_entry<false>(pass, nullptr, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr, 0, p, 0, k, h1, h2,
                                    rows, resident, 0, dtype, nullptr, static_cast<int*>(out));
}

// out[i] = sum over b < nblk of part[b, i], in order of b.
int t2l_sa_train_reduce(const void* part, int nblk, int len, void* out, void* stream) {
  const int threads = 256;
  sa_reduce_kernel<<<(len + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(part),
                                                          nblk, len, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
