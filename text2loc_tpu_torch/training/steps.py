"""Train steps of both stages (port of text2loc_tpu/training/steps.py):
batch preparation with on-device augmentation, the frozen-text lookup, both
towers' training forward, the loss, the backward and one Adam update, as
one plain Python function per step; the fine stage's warm-up optimizer
(the JAX training/fine.py's make_fine_optimizer), its eval forward, and
TrainState, what a checkpoint holds.

The model is in training mode (module.train()): every SA level whose
fused_train token is not "0" runs ops/sa_train.py (the CUDA kernels on the
card), the other layers their plain training paths. default_fused_train
gives a stage's tokens, as the JAX package's "auto" resolves them.
Augmentation and dropout draw from one explicit torch.Generator on the
model's device.

With a data-parallel `mesh` (parallel/mesh.py; parallel/train.py binds
it) a step takes this rank's rows of the global batch and computes as a
single device would on the whole batch: every random tensor is drawn at
the global batch's shape from the generator every rank holds alike and
cut to the rank's rows; the BatchNorm and training SA statistics are
global (parallel/mesh.use_mesh); the loss is this rank's share of the
global loss (training/losses.py); the parameter gradients are summed over
the ranks (not averaged) in one all-reduce, with the reported metrics, and
every rank takes the same Adam step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from text2loc_tpu_torch.data import augment
from text2loc_tpu_torch.data.batch import FineBatch, ObjectSet, TextSet
from text2loc_tpu_torch.models.transformer import set_dropout_generator
from text2loc_tpu_torch.parallel.mesh import all_reduce_, use_mesh
from text2loc_tpu_torch.training import losses
from text2loc_tpu_torch.utils import debug


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


class TrainState(NamedTuple):
    """What a checkpoint holds of a trainer: the model (parameters and
    BatchNorm running statistics) and its optimizer (Adam's moments and
    step counts, the schedule's position)."""

    model: torch.nn.Module
    optimizer: Optimizer

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "adam": self.optimizer.adam.state_dict(),
                "schedule": self.optimizer.schedule.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.adam.load_state_dict(state["adam"])
        self.optimizer.schedule.load_state_dict(state["schedule"])


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


def make_fine_optimizer(params, cfg, steps_per_epoch: int) -> Optimizer:
    """Adam for the fine stage: the constant cfg.train.warmup_lr for
    warmup_epochs x steps_per_epoch updates, then the staircase schedule
    counted from that boundary (optax.join_schedules' count); without a
    warm-up, make_optimizer. The schedule gives the learning rate itself
    (Adam's base rate is 1), so every rate is the schedule's value."""
    t = cfg.train
    warm = t.warmup_epochs * steps_per_epoch
    if warm <= 0:
        return make_optimizer(params, cfg, steps_per_epoch)
    main = make_lr_schedule(cfg, steps_per_epoch)
    adam = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)

    def rate(i):
        return t.warmup_lr if i < warm else t.learning_rate * main(i - warm)

    return Optimizer(adam, torch.optim.lr_scheduler.LambdaLR(adam, rate))


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


def prepare_coarse_batch(batch: dict, embedder, cfg, generator, train: bool, mesh=None):
    """(ObjectSet, TextSet) of a device batch: flips, hint shuffling and the
    point transform (train), then the frozen-text lookup. Under `mesh` the
    batch is this rank's rows and the draws are the global batch's."""
    t = cfg.train
    if train and t.flip_poses:
        batch = augment.flip_coarse(batch, generator, mesh)
    if train and t.shuffle_hints:
        batch = augment.shuffle_hints(batch, generator, mesh)
    xyz, rgb = augment.point_cloud_transform(
        batch["xyz"].float(), batch["rgb"].float(), generator,
        num_points=cfg.model.pointnet.num_points, augment=train and t.pc_augment,
        mesh=mesh)
    return _object_set(batch, xyz, rgb), embed_text_batch(embedder, batch)


def prepare_negative_objects(batch: dict, cfg, generator, mesh=None) -> ObjectSet:
    """ObjectSet of a triplet batch's `neg_*` cell (no flip: the negative
    has no geometric relation to the hints)."""
    xyz, rgb = augment.point_cloud_transform(
        batch["neg_xyz"].float(), batch["neg_rgb"].float(), generator,
        num_points=cfg.model.pointnet.num_points, augment=cfg.train.pc_augment,
        mesh=mesh)
    return _object_set(batch, xyz, rgb, prefix="neg_")


def prepare_fine_batch(batch: dict, embedder, cfg, generator, train: bool,
                       mesh=None) -> FineBatch:
    if train and cfg.train.fine_flip_poses:
        batch = augment.flip_coarse(batch, generator, mesh)
    xyz, rgb = augment.point_cloud_transform(
        batch["xyz"].float(), batch["rgb"].float(), generator,
        num_points=cfg.model.pointnet.num_points,
        augment=train and cfg.train.pc_augment, mesh=mesh)
    return FineBatch(objects=_object_set(batch, xyz, rgb),
                     text=embed_text_batch(embedder, batch),
                     target=batch["target"].float(),
                     pose_in_cell=batch["pose_in_cell"].float())


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _backward_and_update(model, optimizer: Optimizer, loss, mesh, sums=()) -> list:
    """The backward of `loss` and one Adam step. Under `mesh` the parameter
    gradients and the metric tensors `sums` are summed over the ranks in
    one all-reduce first (the metrics returned summed). With
    utils/debug.enable_nan_debugging, the loss is checked before the
    backward and the gradients before the update."""
    if debug.nan_debugging():
        debug.check_loss(loss.detach(), model, mesh)
    loss.backward()
    sums = [s.detach().reshape(()).float() for s in sums]
    if mesh is not None:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]
                                     + [s.reshape(1) for s in sums]), mesh)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        sums = list(flat[at:])
    if debug.nan_debugging():
        debug.check_grads(model)
    optimizer.step()
    return sums


def make_coarse_train_step(model, embedder, cfg, optimizer: Optimizer,
                           generator: torch.Generator, mesh=None) -> Callable:
    """step(host batch of gather_coarse) -> {"loss"}: one Adam update of the
    retrieval towers (anchor = text, positive = cell). With a data-parallel
    `mesh` the batch is this rank's rows (parallel/mesh.shard_batch) and
    the loss the global one."""
    device = _device(model)
    embedder = embedder.to(device)
    set_dropout_generator(model, generator)
    is_triplet = cfg.train.loss.ranking_loss == "triplet"
    pair_loss = None if is_triplet else losses.make_retrieval_loss(cfg.train.loss)

    def step(batch: dict) -> dict:
        model.train()
        b = to_device(batch, device)
        with use_mesh(model, mesh):
            objects, text = prepare_coarse_batch(b, embedder, cfg, generator, train=True,
                                                 mesh=mesh)
            optimizer.zero_grad()
            cell_emb, text_emb = model(objects, text)
            if is_triplet:
                # The negative tower pass runs after the positive one, so the
                # BN running statistics see both batches.
                neg_emb = model.encode_objects(prepare_negative_objects(b, cfg, generator,
                                                                        mesh))
                loss = losses.triplet_margin_loss(text_emb, cell_emb, neg_emb,
                                                  cfg.train.loss.margin, mesh=mesh)
            else:
                loss = pair_loss(text_emb, cell_emb, mesh=mesh)
            (total,) = _backward_and_update(model, optimizer, loss, mesh, [loss])
        return {"loss": total}

    return step


def make_fine_train_step(model, embedder, cfg, optimizer: Optimizer,
                         generator: torch.Generator, mesh=None) -> Callable:
    """step(host batch of gather_fine) -> {"loss", "pose_error"}: one Adam
    update of the fine regressor, loss = offset_lambda * MSE(pred, target).
    `mesh` as make_coarse_train_step's."""
    device = _device(model)
    embedder = embedder.to(device)
    set_dropout_generator(model, generator)
    lam = cfg.train.offset_lambda

    def step(batch: dict) -> dict:
        model.train()
        with use_mesh(model, mesh):
            fb = prepare_fine_batch(to_device(batch, device), embedder, cfg, generator,
                                    train=True, mesh=mesh)
            optimizer.zero_grad()
            pred = model(fb.objects, fb.text)
            if mesh is None:
                loss = lam * torch.mean((pred - fb.target) ** 2)
                err = losses.pose_error(pred.detach(), fb.target)
            else:
                # This rank's share of the global mean; the pose error's
                # share likewise, summed with the gradients.
                n = pred.numel() * mesh.size
                loss = lam * torch.sum((pred - fb.target) ** 2) / n
                err = torch.linalg.vector_norm(pred.detach() - fb.target[..., :2],
                                               dim=-1).sum() / (pred.shape[0] * mesh.size)
            total, err = _backward_and_update(model, optimizer, loss, mesh, [loss, err])
        return {"loss": total, "pose_error": err}

    return step


def make_fine_forward(model, embedder, cfg) -> Callable:
    """forward(host batch of gather_fine) -> [B, 2] positions: the fine
    model in eval mode (BN running statistics, no dropout), no gradients."""
    device = _device(model)
    embedder = embedder.to(device)

    @torch.no_grad()
    def forward(batch: dict) -> torch.Tensor:
        model.eval()
        fb = prepare_fine_batch(to_device(batch, device), embedder, cfg, None, train=False)
        return model(fb.objects, fb.text)

    return forward
