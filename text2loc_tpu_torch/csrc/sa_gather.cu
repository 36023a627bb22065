// The inference SA level over precomputed neighbours (SA mode "gather"):
// the valid slots of a ball query's idx/mask, in slot order, then the
// tensor-core tiles of sa_select_tc.cuh (u = feat @ W1 rounded to the
// compute dtype, as "first"); sa_select.cu holds the design note.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_sa_gather :242
// (_sa_gather_kernel :188).
#include "sa_select_tc.cuh"

T2L_SA_TILE_ENTRY(gather, t2l::sas::kGather)
