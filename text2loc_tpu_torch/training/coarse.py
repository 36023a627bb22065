"""The coarse retrieval trainer (port of text2loc_tpu/training/coarse.py:
train_coarse's epoch loop, serial, on one device).

Each epoch draws a permutation of the training poses from a numpy
generator seeded with cfg.train.seed, gathers batches with gather_coarse
(close-cell positives and triplet negatives from their own seeded
generators) and takes one step per batch. Evaluation, checkpoints, resume,
prefetching and meshes are not part of this trainer yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from text2loc_tpu_torch.convert import build_model, init_weights
from text2loc_tpu_torch.training import steps as steps_lib


def train_coarse(cfg, data_train, embedder, device="cuda", model=None, fused_train=None):
    """Train the retrieval towers for cfg.train.epochs epochs; returns
    (model, history) with one {"epoch", "step", "loss", "seconds"} row per
    step (`seconds`: host wall time of the step, ending when its loss is
    read back). `model` defaults to a CellRetrievalNetwork with seeded
    random weights and the training SA tokens `fused_train` (None:
    steps.default_fused_train); the compute dtype is cfg.model.train_dtype."""
    t = cfg.train
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype=cfg.model.train_dtype))
    device = torch.device(device)
    if model is None:
        model = init_weights(build_model(cfg, "coarse", fused_train=fused_train),
                             torch.Generator().manual_seed(t.seed))
    elif fused_train is not None:
        raise ValueError("fused_train is fixed when the model is built; pass one or "
                         "the other")
    model = model.to(device)
    n_train = data_train.num_poses
    steps_per_epoch = max(n_train // t.batch_size, 1)
    optimizer = steps_lib.make_optimizer(model.parameters(), cfg, steps_per_epoch)
    generator = torch.Generator(device=device).manual_seed(t.seed)
    step_fn = steps_lib.make_coarse_train_step(model, embedder, cfg, optimizer, generator)

    order_rng = np.random.default_rng(t.seed)
    close_rng = np.random.default_rng(t.seed + 7) if t.sample_close_cell else None
    neg_rng = (np.random.default_rng(t.seed + 13)
               if t.loss.ranking_loss == "triplet" else None)
    history = []
    for epoch in range(t.epochs):
        perm = order_rng.permutation(n_train)[: steps_per_epoch * t.batch_size]
        for start in range(0, len(perm), t.batch_size):
            batch = data_train.gather_coarse(
                perm[start:start + t.batch_size], cfg.model.object_size,
                sample_close_rng=close_rng, negative_rng=neg_rng)
            t0 = time.perf_counter()
            loss = float(step_fn(batch)["loss"])
            history.append({"epoch": epoch, "step": len(history), "loss": loss,
                            "seconds": time.perf_counter() - t0})
    return model, history
