// The inference SA level with K masked-argmin rounds (SA mode "exact"): the
// K nearest in-radius points, ties to the lowest index, then the pooling
// tail of sa_level.cuh (u = x @ Wx + pos @ Wp in f32), which holds the
// kernel and its design notes.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_set_abstraction :116
// (_sa_kernel :38), select_k=True.
#include "sa_level.cuh"

T2L_SA_LEVEL_ENTRY(exact, kExact)
