// The inference SA level over every in-radius point (SA mode "all"): u =
// x @ Wx + pos @ Wp in f32, every in-radius point an edge, then the
// tensor-core tiles of sa_select_tc.cuh, cut every R rows with a split
// center's partial max carried across tiles; sa_select.cu holds the
// design note.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_set_abstraction :116
// (_sa_kernel :38), select_k=False.
#include "sa_select_tc.cuh"

T2L_SA_TILE_ENTRY(all, t2l::sas::kAll)
