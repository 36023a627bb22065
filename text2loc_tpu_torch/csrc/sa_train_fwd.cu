// Training forward of one PointConv set-abstraction level with batch-
// statistic BatchNorm: the BN1 statistics pass, the BN2 statistics pass
// (one kernel templated on the layer) and the output pass, plus the
// fixed-order reduction of per-block partial sums.
//
// Replaces the TPU kernels text2loc_tpu/ops/pallas_sa_train.py
// (_k_stats1 :163, _k_stats2 :182, _k_out :200; driven by _forward :625,
// and the cached-edge _forward_e :740 at cache dtype f32, which computes
// the same function).
//
// What bounds it on the H100: the second edge layer, 2 * E * H1 * H2 FLOPs
// per pass that needs z (the BN2 statistics pass and the output pass), run
// here on the FP32 pipes (67 TFLOP/s); bytes (u, sv, indices, masks and
// the output, ~0.1 GB at the coarse step's shapes) are far below that.
// What the design does about it: the [N, S, K, H] edge tensors never exist
// in device memory. Each block recomputes e = u[idx] - sv (a direct indexed
// load: no one-hot matmul), h1 and z for a tile of up to 64 edges in shared
// memory, with a register-tiled product (8 rows x up to 8 columns per
// thread, W2 read through L1/L2). Statistics are per-block partials summed
// by t2l_sa_train_reduce in a fixed order, so two runs agree bit for bit.
// A later PR can move the products to wgmma.
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

// Dynamic shared memory of one block of a pass (the wrapper picks the tile
// height rpt so that it fits); with_du: the input-gradient pass.
size_t t2l_sa_train_smem(int with_du, int p, int k, int h1, int h2, int rpt) {
  return t2l::sa::smem_layout(with_du, p, k, h1, h2, rpt, nullptr, nullptr);
}

// pass 1: BN1 sums -> out0 [blocks, 2, h1] (sum e, sum e^2 over maskf edges)
// pass 2: BN2 sums -> out0 [blocks, 2, h2] (sum z, sum z^2 over maskf edges)
// pass 3: the level's output -> out0 [n, s, h2] f32
// u [n,p,h1] f32, sv [n,s,h1] f32, idx [n,s,k] int32, mm/mf [n,s,k] bool,
// w2 [h1,h2] in the compute dtype, aux1 [8,h1], aux2 [8,h2] f32.
int t2l_sa_train_fwd(int pass, const void* u, const void* sv, const void* idx,
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
  if (dtype == t2l::kBF16) return forward_pass<__nv_bfloat16, false>(pass, a, out0, blocks, smem, st);
  return forward_pass<float, false>(pass, a, out0, blocks, smem, st);
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
