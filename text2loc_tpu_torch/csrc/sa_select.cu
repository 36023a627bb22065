// The inference SA level with "first" selection (SA mode "first", the
// serve's and the evaluation's default) on the tensor cores; the kernel is
// in sa_select_tc.cuh.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_sa_select :451
// (_sa_select_kernel :304), selection="first".
//
// What bounds it on the H100: the second layer, one H1 x H2 product per
// selected edge (2 E H1 H2 FLOPs over the E valid edges; 94 GFLOP at the
// gallery's SA3 in a 64-cell build), then u = feat @ W1 per point; the
// bytes (points, features, centers and the output) are far below that on
// the tensor cores. The design before this one held 32 slots per center
// whatever its count, one center per round at SA3, and ran both layers on
// the FP32 pipes with W2 read from L2 for every center. What this design
// does about it:
// - the products run on mma.sync (bf16 m16n8k16; f32 as 3xTF32 on hi / lo
//   splits, no operand rounded to TF32 alone), through the tile machinery
//   of the training level (sa_train_tiles.cuh);
// - only valid edges become rows: the edges of up to 16 consecutive centers
//   packed into tiles of R rows, a center never split, and the product runs
//   over the used rows' m16 tiles only;
// - every warp selects at once, a group of up to 128 centers in one go;
//   the group's rows are cut into tiles once, so a tile costs four
//   barriers besides the ring's;
// - u is computed once per cloud on the tensor cores and kept in shared
//   memory in the compute dtype; h1 rows are built straight into the
//   padded A layout the fragments load from;
// - W2 sits in shared memory for the whole kernel or streams through the
//   cp.async ring, in slices of 256 output columns; a persistent grid of
//   the blocks one wave of SMs holds. The host picks the plan (tile rows,
//   resident, blocks per SM: ops/cuda_pointconv.first_plan, from the
//   occupancy query); the C side only checks it.
// The distance keeps the _rn intrinsics in the plain version's order (dist2
// of sa_level.cuh), so the in-radius sets agree bit for bit.
#include "sa_select_tc.cuh"

namespace {

t2l::sas::Args args_of(const void* feat, const void* pos, const void* ctr, const void* w1,
                       const void* wp, const void* ab1, const void* w2, const void* ab2,
                       void* out, int n, int p, int s, int c, int h1, int h2, int k,
                       float r2, int rows, int resident) {
  return t2l::sas::Args{feat, static_cast<const float*>(pos),
                        static_cast<const float*>(ctr), w1, wp,
                        static_cast<const float*>(ab1), w2, static_cast<const float*>(ab2),
                        out, n, p, s, c, h1, h2, k, r2, rows, resident};
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the plan (rows, resident) for a
// level of P points, S centers, C = C+3 input channels, H1, H2, K; dtype 0
// f32, 1 bf16. The largest size_t where the kernel does not take the shape or
// the plan.
size_t t2l_sa_select_layout(int p, int s, int c, int h1, int h2, int k, int rows,
                            int resident, int dtype) {
  const t2l::sas::Args a = args_of(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, 0, p, s, c, h1, h2, k, 0.f,
                                   rows, resident);
  if (t2l::sas::check_args(a)) return ~static_cast<size_t>(0);
  return t2l::sas::layout(p, s, c, h1, h2, k, rows, resident, dtype == t2l::kBF16 ? 2 : 4,
                          nullptr, nullptr);
}

// Blocks of the plan's kernel that one SM holds at once -> *out.
int t2l_sa_select_occupancy(int p, int s, int c, int h1, int h2, int k, int rows,
                            int resident, int dtype, void* out) {
  const t2l::sas::Args a = args_of(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, 0, p, s, c, h1, h2, k, 0.f,
                                   rows, resident);
  return t2l::sas::entry(a, 0, dtype, nullptr, static_cast<int*>(out));
}

// feat [n,p,c] T = concat(x, pos); pos [n,p,3] f32; ctr [n,s,3] f32; w1
// [c,h1] T and its position rows wp [3,h1] T; ab1 [2,h1] f32; w2 [h1,h2] T;
// ab2 [2,h2] f32 -> out [n,s,h2] T. r2: the squared radius as the caller
// rounds it to f32; rows, resident: the plan; blocks: the persistent grid.
// Returns cudaGetLastError() after the launch.
int t2l_sa_select_first(const void* feat, const void* pos, const void* ctr, const void* w1,
                        const void* wp, const void* ab1, const void* w2, const void* ab2,
                        void* out, int n, int p, int s, int c, int h1, int h2, int k,
                        float r2, int rows, int resident, int blocks, int dtype,
                        void* stream) {
  const t2l::sas::Args a = args_of(feat, pos, ctr, w1, wp, ab1, w2, ab2, out, n, p, s, c,
                                   h1, h2, k, r2, rows, resident);
  return t2l::sas::entry(a, blocks, dtype, static_cast<cudaStream_t>(stream), nullptr);
}

}  // extern "C"
