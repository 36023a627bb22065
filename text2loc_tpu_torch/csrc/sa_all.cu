// The inference SA level over every in-radius point (SA mode "all"), pooled
// in tiles of 32 neighbours by the tail of sa_level.cuh (u = x @ Wx +
// pos @ Wp in f32), which holds the kernel and its design notes.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_set_abstraction :116
// (_sa_kernel :38), select_k=False.
#include "sa_level.cuh"

T2L_SA_LEVEL_ENTRY(all, kAll)
