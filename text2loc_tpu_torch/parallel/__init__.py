"""Data parallelism over torch.distributed (port of text2loc_tpu/parallel):

* `mesh`      - the Mesh of a process group, batch sharding, the
                autograd-aware collectives the DP paths share;
* `train`     - data-parallel train steps: each rank's rows, global-batch
                losses and BatchNorm statistics, gradients all-reduced;
* `retrieval` - the gallery sharded over the ranks, a local top-k per rank
                and a merge of the gathered candidates.
"""

from text2loc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_batch,
    shard_batch_multihost,
)
