"""Train steps of both stages (port of text2loc_tpu/training/steps.py):
batch preparation with on-device augmentation, the frozen-text lookup, both
towers' training forward, the loss, the backward and one Adam update, as
one plain Python function per step.

The model is in training mode (module.train()): every SA level whose
fused_train token is not "0" runs ops/sa_train.py (the CUDA kernels on the
card), the other layers their plain training paths. default_fused_train
gives a stage's tokens, as the JAX package's "auto" resolves them.
Augmentation and dropout draw from one explicit torch.Generator on the
model's device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from text2loc_tpu_torch.data import augment
from text2loc_tpu_torch.data.batch import FineBatch, ObjectSet, TextSet
from text2loc_tpu_torch.models.transformer import set_dropout_generator
from text2loc_tpu_torch.training import losses


class Optimizer(NamedTuple):
    """Adam (betas 0.9 / 0.999, eps 1e-8: optax.adam's) with its per-step
    learning-rate schedule."""

    adam: torch.optim.Adam
    schedule: torch.optim.lr_scheduler.LambdaLR

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.adam.step()
        self.schedule.step()


def make_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Factor of the base learning rate at update i: a staircase decay by
    lr_gamma per epoch ("exponential") or per lr_step epochs ("step")."""
    t = cfg.train
    if t.lr_scheduler == "exponential":
        every = max(steps_per_epoch, 1)
    elif t.lr_scheduler == "step":
        every = max(steps_per_epoch * t.lr_step, 1)
    else:
        raise ValueError(t.lr_scheduler)
    gamma = t.lr_gamma
    return lambda i: gamma ** (i // every)


def make_optimizer(params, cfg, steps_per_epoch: int, lr=None) -> Optimizer:
    """Adam over `params` at cfg.train.learning_rate with the per-epoch
    schedule, or at a fixed `lr`."""
    base = cfg.train.learning_rate if lr is None else lr
    adam = torch.optim.Adam(params, lr=base, betas=(0.9, 0.999), eps=1e-8)
    factor = make_lr_schedule(cfg, steps_per_epoch) if lr is None else (lambda i: 1.0)
    return Optimizer(adam, torch.optim.lr_scheduler.LambdaLR(adam, factor))


# What the JAX package's TEXT2LOC_FUSED_SA_TRAIN "auto" resolves to per
# stage (its training/steps.py:130-141) for an f32 body on the 3-level
# ladder: per SA level, "0" the plain path, "1" the recompute kernel, "e32"
# the f32 edge cache (in the port the same function and kernels as "1").
# The JAX auto also degrades "e"/"e32" to "1" above an HBM budget for the
# cached edges; the port caches no edges, so that budget has nothing to
# bound and is not carried over.
COARSE_FUSED_TRAIN_AUTO = ("e32", "e32", "1")
FINE_FUSED_TRAIN_AUTO = ("0", "e32", "e32")


def default_fused_train(cfg, kind: str) -> tuple:
    """The training SA tokens of stage `kind` ("coarse" or "fine"): the
    stage auto for an f32 body on the 3-level ladder, else the JAX module
    default (the last level "1", the others "0")."""
    auto = COARSE_FUSED_TRAIN_AUTO if kind == "coarse" else FINE_FUSED_TRAIN_AUTO
    n = len(cfg.model.pointnet.sa_mlps)
    body = cfg.model.body_dtype or cfg.model.train_dtype
    if n == len(auto) and body == "float32":
        return auto
    return ("0",) * (n - 1) + ("1",)


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}


def embed_text_batch(embedder, batch: dict) -> TextSet:
    """TextSet of a batch: the table lookup of its hint triples."""
    return embedder.embed(batch["hint_dir"], batch["hint_color"], batch["hint_label"],
                          sentence_mask=batch.get("sentence_mask"))


def _object_set(batch: dict, xyz, rgb, prefix: str = "") -> ObjectSet:
    return ObjectSet(
        xyz=xyz, rgb=rgb, center=batch[prefix + "center"].float(),
        color=batch[prefix + "color"].float(),
        num_points=batch[prefix + "num_points"].float(),
        class_idx=batch[prefix + "class_idx"].long(),
        color_idx=batch[prefix + "color_idx"].long(),
        mask=batch[prefix + "mask"].bool())


def prepare_coarse_batch(batch: dict, embedder, cfg, generator, train: bool):
    """(ObjectSet, TextSet) of a device batch: flips, hint shuffling and the
    point transform (train), then the frozen-text lookup."""
    t = cfg.train
    if train and t.flip_poses:
        batch = augment.flip_coarse(batch, generator)
    if train and t.shuffle_hints:
        batch = augment.shuffle_hints(batch, generator)
    xyz, rgb = augment.point_cloud_transform(
        batch["xyz"].float(), batch["rgb"].float(), generator,
        num_points=cfg.model.pointnet.num_points, augment=train and t.pc_augment)
    return _object_set(batch, xyz, rgb), embed_text_batch(embedder, batch)


def prepare_negative_objects(batch: dict, cfg, generator) -> ObjectSet:
    """ObjectSet of a triplet batch's `neg_*` cell (no flip: the negative
    has no geometric relation to the hints)."""
    xyz, rgb = augment.point_cloud_transform(
        batch["neg_xyz"].float(), batch["neg_rgb"].float(), generator,
        num_points=cfg.model.pointnet.num_points, augment=cfg.train.pc_augment)
    return _object_set(batch, xyz, rgb, prefix="neg_")


def prepare_fine_batch(batch: dict, embedder, cfg, generator, train: bool) -> FineBatch:
    if train and cfg.train.fine_flip_poses:
        batch = augment.flip_coarse(batch, generator)
    xyz, rgb = augment.point_cloud_transform(
        batch["xyz"].float(), batch["rgb"].float(), generator,
        num_points=cfg.model.pointnet.num_points,
        augment=train and cfg.train.pc_augment)
    return FineBatch(objects=_object_set(batch, xyz, rgb),
                     text=embed_text_batch(embedder, batch),
                     target=batch["target"].float(),
                     pose_in_cell=batch["pose_in_cell"].float())


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_coarse_train_step(model, embedder, cfg, optimizer: Optimizer,
                           generator: torch.Generator) -> Callable:
    """step(host batch of gather_coarse) -> {"loss"}: one Adam update of the
    retrieval towers (anchor = text, positive = cell)."""
    device = _device(model)
    embedder = embedder.to(device)
    set_dropout_generator(model, generator)
    is_triplet = cfg.train.loss.ranking_loss == "triplet"
    pair_loss = None if is_triplet else losses.make_retrieval_loss(cfg.train.loss)

    def step(batch: dict) -> dict:
        model.train()
        b = to_device(batch, device)
        objects, text = prepare_coarse_batch(b, embedder, cfg, generator, train=True)
        optimizer.zero_grad()
        cell_emb, text_emb = model(objects, text)
        if is_triplet:
            # The negative tower pass runs after the positive one, so the BN
            # running statistics see both batches.
            neg_emb = model.encode_objects(prepare_negative_objects(b, cfg, generator))
            loss = losses.triplet_margin_loss(text_emb, cell_emb, neg_emb,
                                              cfg.train.loss.margin)
        else:
            loss = pair_loss(text_emb, cell_emb)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def make_fine_train_step(model, embedder, cfg, optimizer: Optimizer,
                         generator: torch.Generator) -> Callable:
    """step(host batch of gather_fine) -> {"loss", "pose_error"}: one Adam
    update of the fine regressor, loss = offset_lambda * MSE(pred, target)."""
    device = _device(model)
    embedder = embedder.to(device)
    set_dropout_generator(model, generator)

    def step(batch: dict) -> dict:
        model.train()
        fb = prepare_fine_batch(to_device(batch, device), embedder, cfg, generator,
                                train=True)
        optimizer.zero_grad()
        pred = model(fb.objects, fb.text)
        loss = cfg.train.offset_lambda * torch.mean((pred - fb.target) ** 2)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(),
                "pose_error": losses.pose_error(pred.detach(), fb.target)}

    return step
