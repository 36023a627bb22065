// The inference SA level with "first" selection (SA mode "first", the
// serve's and the evaluation's default) on the tensor cores; the kernel
// template is in sa_select_tc.cuh, which sa_select_bisect.cu ("bisect"),
// sa_gather.cu ("gather"), sa_exact.cu ("exact") and sa_all.cu ("all")
// instantiate too. This note holds the design of all five.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_sa_select :451
// (_sa_select_kernel :304), selection="first".
//
// What bounds it on the H100: the second layer, one H1 x H2 product per
// selected edge (2 E H1 H2 FLOPs over the E valid edges; 94 GFLOP at the
// gallery's SA3 in a 64-cell build), then u = feat @ W1 per point; the
// bytes (points, features, centers and the output) are far below that on
// the tensor cores. The design this one replaced held 32 slots per center
// whatever its count, one center per round at SA3, and ran both layers on
// the FP32 pipes with W2 read from L2 for every center. What this design
// does about it:
// - the products run on mma.sync (bf16 m16n8k16; f32 as 3xTF32 on hi / lo
//   splits, no operand rounded to TF32 alone), through the tile machinery
//   of the training level (sa_train_tiles.cuh);
// - only valid edges become rows, packed into tiles of R rows, and the
//   product runs over the used rows' m16 tiles only: "first", "bisect",
//   "gather" and "exact" cut the tiles at center boundaries (at most K = 32
//   rows a center); "all" (up to P rows a center, 153 at the gallery's SA1)
//   cuts them every R rows and carries a split center's partial max to the
//   next tile;
// - every warp selects at once, a group of up to 128 centers in one go
//   ("all": every center of the cloud counted at once, then groups of the
//   centers whose rows fit the row map); the group's rows are cut into
//   tiles once, so a tile costs four barriers besides the ring's;
// - u is computed once per cloud on the tensor cores and kept in shared
//   memory, in the compute dtype ("exact", "all": in f32, as the TPU kernel
//   keeps x @ Wx + pos @ Wp); h1 rows are built straight into the padded A
//   layout the fragments load from;
// - W2 sits in shared memory for the whole kernel or streams through the
//   cp.async ring, in slices of 256 output columns; a persistent grid of
//   the blocks one wave of SMs holds. The host picks the plan (tile rows,
//   resident, blocks per SM, and for "all" the row map's budget:
//   ops/cuda_pointconv.tile_plan, from the occupancy query); the C side
//   only checks it.
// The distance keeps the _rn intrinsics in the plain version's order (dist2
// of sa_select_tc.cuh), so the in-radius sets agree bit for bit.
#include "sa_select_tc.cuh"

T2L_SA_TILE_ENTRY(first, t2l::sas::kFirst)
