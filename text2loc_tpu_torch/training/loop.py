"""What both trainers share (training/coarse.py, training/fine.py): the
model they train, the epoch loop over prefetched host batches with each
step's host seconds, checkpoints with resume, host copies of the best
state, and the data-parallel setup: under a mesh every rank builds the same
host batches from the seed and steps on its rows, rank 0 alone prints,
logs and writes checkpoints (the other ranks wait for each write), and
every rank reads a resumed checkpoint."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from text2loc_tpu_torch.data.prefetch import maybe_prefetch
from text2loc_tpu_torch.parallel.mesh import Mesh, barrier, shard_batch
from text2loc_tpu_torch.utils.checkpoint import CheckpointManager
from text2loc_tpu_torch.utils.profiling import block_on


def trainer_device(mesh, device) -> torch.device:
    """The device a trainer runs on: the mesh's, else `device`. A mesh
    that is not a parallel.mesh.Mesh raises."""
    if mesh is None:
        return torch.device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    return mesh.device


def is_main(mesh) -> bool:
    """Whether this process prints, logs and writes: rank 0, or no mesh."""
    return mesh is None or mesh.rank == 0


def local_rows(batches, mesh):
    """The host batches, each cut to this rank's rows under a mesh."""
    for batch in batches:
        yield batch if mesh is None else shard_batch(batch, mesh)


def save_checkpoint(ckpt, epoch: int, state, metric: float, mesh) -> None:
    """ckpt.save on rank 0 (or without a mesh); every rank waits for it."""
    if is_main(mesh):
        ckpt.save(epoch, state, metric)
    if mesh is not None:
        barrier(mesh)


def train_model(cfg, kind: str, device, model, fused_train, seed: int, pointnet_ckpt,
                verbose: bool = True):
    """The model a trainer trains, on `device`: `model`, or a fresh one of
    `kind` with seeded random weights (torch.Generator seeded with `seed`),
    the training SA tokens `fused_train` (None: the stage default) and, for
    its evaluations, the inference SA mode the JAX package picks per
    backend ("first" on the card, "off" on the CPU); then the pretrained
    PointNet of `pointnet_ckpt` grafted into its object tower."""
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.torch_checkpoint import load_pretrained_pointnet

    if model is None:
        sa_mode = "first" if device.type == "cuda" else "off"
        model = init_weights(build_model(cfg, kind, sa_mode=sa_mode, fused_train=fused_train),
                             torch.Generator().manual_seed(seed))
    elif fused_train is not None:
        raise ValueError("fused_train is fixed when the model is built; pass one or the "
                         "other")
    if pointnet_ckpt:
        load_pretrained_pointnet(model, pointnet_ckpt)
        if verbose:
            print(f"grafted pretrained PointNet from {pointnet_ckpt}", flush=True)
    return model.to(device)


def open_checkpoints(workdir, name: str, mode: str, resume: bool, state,
                     verbose: bool = True):
    """(CheckpointManager of <workdir>/<name> or None, first epoch, the
    restored best metric or None). With `resume` and a checkpoint on disk,
    `state` is restored from the best one and training continues after the
    latest saved epoch, gated by the restored best metric."""
    if workdir is None:
        return None, 0, None
    ckpt = CheckpointManager(os.path.join(workdir, name), mode=mode)
    latest = ckpt.latest_step()
    if not resume or latest is None:
        return ckpt, 0, None
    ckpt.restore(state)
    if verbose:
        print(f"resumed from epoch {latest}", flush=True)
    return ckpt, latest + 1, ckpt.best_metric


def run_epoch(step_fn, batches, epoch: int, logger, prefetch: bool) -> dict:
    """One step per host batch of `batches` (gathered ahead on a worker
    thread when `prefetch`); appends a {"epoch", "step", "loss", "seconds"}
    row per step to logger.steps (`seconds`: until the step's outputs are
    ready) and returns the epoch's mean of each step metric."""
    it = maybe_prefetch(batches, enabled=prefetch)
    metrics = []
    try:
        for batch in it:
            t0 = time.perf_counter()
            m = block_on(step_fn(batch))
            seconds = time.perf_counter() - t0
            logger.steps.append({"epoch": epoch, "step": len(logger.steps),
                                 "loss": float(m["loss"]), "seconds": seconds})
            metrics.append(m)
    finally:
        it.close()
    return {k: float(np.mean([float(m[k]) for m in metrics])) for k in metrics[0]}


def snapshot(model) -> dict:
    """A host copy of the model's state dict (the best state so far)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
