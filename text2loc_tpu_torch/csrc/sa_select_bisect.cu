// The inference SA level with "bisect" selection (SA mode "full"): the <= K
// nearest in-radius points by `iters` rounds of threshold bisection with
// the TPU kernel's tie expansion, then the pooling tail of sa_level.cuh,
// which holds the kernel and its design notes.
//
// Replaces text2loc_tpu/ops/pallas_pointconv.py fused_sa_select :451
// (_sa_select_kernel :304), selection="bisect".
#include "sa_level.cuh"

// Dynamic shared memory of one block (the wrapper checks it against the
// card's limit before launching); shared by every selection of
// sa_level.cuh (bisect, exact).
extern "C" size_t t2l_sa_level_smem(int p, int h1, int g_per) {
  return sa_level_smem(p, h1, g_per);
}

T2L_SA_LEVEL_ENTRY(bisect, kBisect)
