"""The fine position-regressor trainer and its CLI (port of
text2loc_tpu/training/fine.py: make_fine_optimizer (in training/steps.py),
eval_fine, train_fine, main).

* loss = offset_lambda x MSE(pred, target), in training/steps.py's step;
* a warm-up of warmup_epochs at the constant warmup_lr before the
  staircase schedule (steps.make_fine_optimizer);
* Prototype-based Map Cloning: each batch's draw from the precomputed
  tables (data/pmc.py sample_pmc), in the JAX trainer's order of draws;
* best-val gating by the mean pose error, checkpoints (utils/checkpoint.py)
  and resume;
* data parallelism over a `mesh` as in training/coarse.py (--dp under
  torchrun), the MSE's mean over the global batch.

CLI (the coarse trainer's flags, plus --pmc_prob and --fine_flip_poses):
    python -m text2loc_tpu_torch.training.fine --synthetic --device cpu --epochs 1
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from text2loc_tpu_torch.data.pmc import sample_pmc
from text2loc_tpu_torch.parallel.train import replicate_state
from text2loc_tpu_torch.training import loop
from text2loc_tpu_torch.training import steps as steps_lib
from text2loc_tpu_torch.utils.logging import MetricLogger
from text2loc_tpu_torch.utils.profiling import StageTimer


def eval_fine(data, model, embedder, cfg, batch_size: int = 64, forward=None) -> float:
    """Mean pose error on a split: each pose against its best cell, L2 in
    normalized cell units, with the model's current weights in eval mode.
    The last batch is padded to `batch_size` by repeating its poses
    (np.resize). Pass a prebuilt `forward` (steps.make_fine_forward) when
    calling in a loop."""
    if forward is None:
        forward = steps_lib.make_fine_forward(model, embedder, cfg)
    n = data.num_poses
    errs = []
    for s in range(0, n, batch_size):
        idx = np.arange(s, min(s + batch_size, n))
        full = np.resize(idx, batch_size)
        batch = data.gather_fine(full, cfg.model.pad_size)
        pred = forward(batch).float().cpu().numpy()
        errs.extend(np.linalg.norm(pred - batch["target"], axis=-1)[: len(idx)])
    return float(np.mean(errs))


def train_fine(cfg, data_train, data_val, embedder, workdir: Optional[str] = None,
               mesh=None, eval_every: int = 1, resume: bool = False, data_test=None,
               pointnet_ckpt: Optional[str] = None, device="cuda", model=None,
               prefetch: bool = True):
    """Train the fine regressor for cfg.train.epochs epochs; returns
    (best_state, model, logger): the state dict at the best validation pose
    error (the final one without validation), the model with those weights
    loaded, and the MetricLogger (per-epoch rows; per-step rows in
    logger.steps).

    `model` defaults to a CrossMatch with seeded random weights
    (loop.train_model); the compute dtype is cfg.model.train_dtype.
    `workdir`: checkpoints in <workdir>/fine_ckpt and the metrics log;
    `resume` continues from them. `prefetch`: gather the host batches on a
    worker thread (the same draws and results as without). `mesh`: a
    parallel.mesh.Mesh to train over, as train_coarse's."""
    t = cfg.train
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=cfg.model.train_dtype))
    device = loop.trainer_device(mesh, device)
    main = loop.is_main(mesh)
    model = loop.train_model(cfg, "fine", device, model, None, t.seed, pointnet_ckpt,
                             verbose=main)
    n_train = data_train.num_poses
    steps_per_epoch = max(n_train // t.batch_size, 1)
    optimizer = steps_lib.make_fine_optimizer(model.parameters(), cfg, steps_per_epoch)
    generator = torch.Generator(device=device).manual_seed(t.seed)
    step_fn = steps_lib.make_fine_train_step(model, embedder, cfg, optimizer, generator,
                                             mesh=mesh)
    state = steps_lib.TrainState(model, optimizer)

    logger = MetricLogger(os.path.join(workdir, "fine_metrics.jsonl")
                          if workdir and main else None, quiet=not main)
    ckpt, start_epoch, resumed_best = loop.open_checkpoints(workdir, "fine_ckpt", "min",
                                                            resume, state, verbose=main)
    if mesh is not None:
        replicate_state(state, mesh)
    timer = StageTimer()
    order_rng = np.random.default_rng(t.seed + 1)
    best_val = np.inf if resumed_best is None else float(resumed_best)
    # Saves are gated on improvement, so the restored state is the best.
    best_state = loop.snapshot(model) if resumed_best is not None else None
    eval_forward = steps_lib.make_fine_forward(model, embedder, cfg)
    for epoch in range(start_epoch, t.epochs):
        perm = order_rng.permutation(n_train)[: steps_per_epoch * t.batch_size]

        def epoch_batches(perm=perm):
            # On the prefetch worker, in order: order_rng's PMC draws advance
            # as in the serial loop, and the next epoch's permutation is
            # drawn only after this generator is consumed.
            for bstart in range(0, len(perm), t.batch_size):
                idx = perm[bstart:bstart + t.batch_size]
                cell_idx, hint_obj = sample_pmc(data_train, idx, order_rng, t.pmc_prob)
                yield data_train.gather_fine(idx, cfg.model.pad_size,
                                             cell_indices=cell_idx, hint_obj_idx=hint_obj)

        with timer.stage("train_epoch"):
            row = loop.run_epoch(step_fn, loop.local_rows(epoch_batches(), mesh), epoch,
                                 logger, prefetch)
        if data_val is not None and (epoch + 1) % eval_every == 0:
            with timer.stage("eval_val"):
                val_err = eval_fine(data_val, model, embedder, cfg, forward=eval_forward)
            row["val_pose_error"] = val_err
            if val_err < best_val:
                best_val = val_err
                best_state = loop.snapshot(model)
                if ckpt is not None:
                    loop.save_checkpoint(ckpt, epoch, state, val_err, mesh)
        logger.log(epoch, **row)

    if main:
        print(timer.report(), flush=True)
    if best_state is None:
        best_state = loop.snapshot(model)
    model.load_state_dict(best_state)
    if data_test is not None:
        test_err = eval_fine(data_test, model, embedder, cfg, forward=eval_forward)
        if main:
            print(f"test pose_error: {test_err:0.4f}", flush=True)
    if workdir is not None and main:
        logger.plot(os.path.join(workdir, "fine_metrics.png"))
        if ckpt is not None:
            ckpt.close()
    return best_state, model, logger


def main(argv=None):
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.models.text_embedding import make_embedder
    from text2loc_tpu_torch.training.coarse import (_apply_overrides, _load_data, _parse,
                                                    _run_context, build_argparser)

    ap = build_argparser()
    ap.add_argument("--pmc_prob", type=float, default=None)
    ap.add_argument("--fine_flip_poses", choices=("on", "off"), default=None,
                    help="pose-flip augmentation of the fine stage (default on; "
                         "'off' is the reference recipe)")
    args = _parse(ap, argv)
    cfg = _apply_overrides(Config().validate(), args)
    cfg, data_train, data_val, data_test = _load_data(cfg, args)
    # After _load_data: --synthetic rebuilds cfg from small_test_config.
    train = cfg.train
    if args.pmc_prob is not None:
        train = dataclasses.replace(train, pmc_prob=args.pmc_prob)
    if args.fine_flip_poses is not None:
        train = dataclasses.replace(train, fine_flip_poses=args.fine_flip_poses == "on")
    cfg = cfg.replace(train=train)
    cfg, embedder = make_embedder(cfg, args.text_table)
    with _run_context(args) as mesh:
        return train_fine(cfg, data_train, data_val, embedder, workdir=args.workdir,
                          mesh=mesh, resume=args.resume, data_test=data_test,
                          pointnet_ckpt=args.pointnet_ckpt, device=args.device)


if __name__ == "__main__":
    main()
