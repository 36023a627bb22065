"""What both trainers share (training/coarse.py, training/fine.py): the
model they train, the epoch loop over prefetched host batches with each
step's host seconds, checkpoints with resume, and host copies of the best
state."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from text2loc_tpu_torch.data.prefetch import maybe_prefetch
from text2loc_tpu_torch.utils.checkpoint import CheckpointManager
from text2loc_tpu_torch.utils.profiling import block_on


def check_no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh: the port trains on one device; data "
                                  "parallelism waits for ROADMAP Queue 1 item 7")


def train_model(cfg, kind: str, device, model, fused_train, seed: int, pointnet_ckpt):
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
        print(f"grafted pretrained PointNet from {pointnet_ckpt}", flush=True)
    return model.to(device)


def open_checkpoints(workdir, name: str, mode: str, resume: bool, state):
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
