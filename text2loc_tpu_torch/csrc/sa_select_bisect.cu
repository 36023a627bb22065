// The inference SA level with "bisect" selection (SA mode "full"): the <= K
// nearest in-radius points by `iters` rounds of threshold bisection with
// the TPU kernel's tie expansion, then the pooling tail of sa_level.cuh,
// which holds the kernel and its design notes.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_sa_select :451
// (_sa_select_kernel :304), selection="bisect".
#include "sa_level.cuh"

T2L_SA_LEVEL_ENTRY(bisect, kBisect)
