// The inference SA level with "bisect" selection (SA mode "full"): the <= K
// nearest in-radius points by `iters` rounds of threshold bisection with
// the TPU kernel's tie expansion, the first <= K of them in index order,
// then the tensor-core tiles of sa_select_tc.cuh (u = feat @ W1 rounded to
// the compute dtype, as "first"); sa_select.cu holds the design note.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_sa_select :451
// (_sa_select_kernel :304), selection="bisect".
#include "sa_select_tc.cuh"

T2L_SA_TILE_ENTRY(bisect, t2l::sas::kBisect)
