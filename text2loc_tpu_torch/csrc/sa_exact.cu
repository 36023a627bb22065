// The inference SA level with K masked-argmin rounds (SA mode "exact"): the
// K nearest in-radius points, ties to the lowest index, then the
// tensor-core tiles of sa_select_tc.cuh (u = x @ Wx + pos @ Wp in f32, as
// "all"); sa_select.cu holds the design note.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_set_abstraction :116
// (_sa_kernel :38), select_k=True.
#include "sa_select_tc.cuh"

T2L_SA_TILE_ENTRY(exact, t2l::sas::kExact)
