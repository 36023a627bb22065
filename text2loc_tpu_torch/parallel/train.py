"""Data-parallel train steps over a Mesh (port of
text2loc_tpu/parallel/train.py).

Each rank runs the single-device step of training/steps.py on its rows of
the global batch (parallel/mesh.shard_batch), with the mesh bound: the
draws, the BatchNorm and training SA statistics and the losses are the
global batch's, and the parameter gradients are summed over the ranks in
one flat all-reduce before every rank takes the same Adam step. So a DP
step equals the single-device step on the global batch, up to the order
of f32 sums.

The training SA levels run as the model was built: through ops/sa_train.py
(the CUDA kernels on the card) with their statistics all-reduced between
the passes, or, for a model built with fused_train="0", on the plain train
branch with the global MaskedBatchNorm. That is the port's form of the JAX
package's TEXT2LOC_FUSED_SA_TRAIN_DP=0.
"""

from __future__ import annotations

from typing import Callable

import torch

from text2loc_tpu_torch.parallel.mesh import Mesh, all_reduce_, broadcast_
from text2loc_tpu_torch.training import steps as steps_lib


def make_dp_coarse_train_step(model, embedder, cfg, optimizer, generator,
                              mesh: Mesh) -> Callable:
    """The coarse step over `mesh`: step(this rank's rows of a
    gather_coarse batch) -> {"loss": the global loss}. Global-batch InfoNCE:
    each rank scores its queries against every rank's cells. Call with the
    state replicated (replicate_state) and `generator` seeded alike on
    every rank."""
    return steps_lib.make_coarse_train_step(model, embedder, cfg, optimizer, generator,
                                            mesh=mesh)


def make_dp_fine_train_step(model, embedder, cfg, optimizer, generator,
                            mesh: Mesh) -> Callable:
    """The fine step over `mesh` (the MSE's mean over the global batch):
    step(this rank's rows of a gather_fine batch) -> {"loss",
    "pose_error"}, both global."""
    return steps_lib.make_fine_train_step(model, embedder, cfg, optimizer, generator,
                                          mesh=mesh)


def _tensors(state: steps_lib.TrainState) -> list:
    """(name, tensor) of everything a rank's training state holds in
    tensors: the model's parameters and buffers, then Adam's state per
    parameter."""
    out = list(state.model.state_dict().items())
    adam = state.optimizer.adam
    for i, p in enumerate(p for g in adam.param_groups for p in g["params"]):
        for k, v in sorted(adam.state.get(p, {}).items()):
            if isinstance(v, torch.Tensor):
                out.append((f"adam.{i}.{k}", v))
    return out


def replicate_state(state: steps_lib.TrainState, mesh: Mesh) -> steps_lib.TrainState:
    """Make every rank hold rank 0's training state: the model's parameters
    and buffers, Adam's state and step counts, and the schedule's position,
    broadcast from rank 0; then check that every rank holds the same values
    (a per-tensor checksum, all-reduced as its max and min). Returns
    `state`, updated in place."""
    import torch.distributed as dist

    obj = [{"schedule": state.optimizer.schedule.state_dict(),
            "adam": state.optimizer.adam.state_dict()} if mesh.rank == 0 else None]
    dist.broadcast_object_list(obj, src=0, group=mesh.group,
                               device=mesh.device if mesh.backend == "nccl" else None)
    if mesh.rank != 0:
        # The structure (param groups, step counts, which parameters hold
        # moments) comes with the object; the tensors' values follow.
        state.optimizer.adam.load_state_dict(obj[0]["adam"])
        state.optimizer.schedule.load_state_dict(obj[0]["schedule"])
    named = _tensors(state)
    with torch.no_grad():
        for _, t in named:
            broadcast_(t, mesh)
        sums = torch.stack([t.detach().double().sum() for _, t in named]).to(mesh.device)
        hi = all_reduce_(sums.clone(), mesh, op=dist.ReduceOp.MAX)
        lo = -all_reduce_(-sums, mesh, op=dist.ReduceOp.MAX)
    differ = [name for (name, _), a, b in zip(named, hi.tolist(), lo.tolist()) if a != b]
    if differ:
        raise RuntimeError(f"ranks hold different training state after the broadcast: "
                           f"{differ[:5]}")
    return state
