// The inference SA level over precomputed neighbours (SA mode "gather"):
// the valid slots of a ball query's idx/mask, then the pooling tail of
// sa_level.cuh, which holds the kernel and its design notes.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_sa_gather :242
// (_sa_gather_kernel :188).
#include "sa_level.cuh"

T2L_SA_LEVEL_ENTRY(gather, kGather)
