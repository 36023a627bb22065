"""The coarse retrieval trainer and its CLI (port of
text2loc_tpu/training/coarse.py: train_coarse, build_argparser,
_apply_overrides, _load_data, main).

Each epoch draws a permutation of the training poses from a numpy
generator seeded with cfg.train.seed, gathers batches with gather_coarse
(close-cell positives and triplet negatives from their own seeded
generators) on a prefetch worker and takes one step per batch; every
`eval_every` epochs it evaluates retrieval on the validation split
(evaluation/retrieval.eval_retrieval), keeps the best state by the mean
recall and checkpoints it.

With a data-parallel `mesh` (parallel/mesh.py) every rank runs
train_coarse alike: the same host batches from the seed, each rank's rows
of them per step, the global-batch loss (parallel/train.py); rank 0 alone
prints, logs and writes checkpoints.

CLI (--synthetic: synthetic scenes at the small test config; --base_path:
the KITTI360Pose train / val / test splits, converted once into
--array_cache by data/ingest.py; --dp N: N ranks under torchrun, one per
card, NCCL, or gloo with --device cpu; --debug_nans: utils/debug.py):
    python -m text2loc_tpu_torch.training.coarse --synthetic --device cpu --epochs 1
    python -m text2loc_tpu_torch.training.coarse --base_path DATA \
        --array_cache DATA/arrays --workdir W
    torchrun --nproc_per_node 4 -m text2loc_tpu_torch.training.coarse --dp 4 \
        --base_path DATA --array_cache DATA/arrays --workdir W
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from text2loc_tpu_torch.evaluation.retrieval import eval_retrieval
from text2loc_tpu_torch.parallel.train import replicate_state
from text2loc_tpu_torch.training import loop
from text2loc_tpu_torch.training import steps as steps_lib
from text2loc_tpu_torch.utils.logging import MetricLogger
from text2loc_tpu_torch.utils.profiling import StageTimer


def train_coarse(cfg, data_train, data_val, embedder, workdir: Optional[str] = None,
                 mesh=None, eval_every: int = 1, resume: bool = False, data_test=None,
                 pointnet_ckpt: Optional[str] = None, eval_train: bool = False,
                 device="cuda", model=None, fused_train=None, prefetch: bool = True):
    """Train the retrieval towers for cfg.train.epochs epochs; returns
    (best_state, model, logger): the state dict at the best validation
    recall (the final one without validation), the model with those
    weights loaded, and the MetricLogger (per-epoch rows; per-step rows
    with each step's host seconds in logger.steps).

    `model` defaults to a CellRetrievalNetwork with seeded random weights
    and the training SA tokens `fused_train` (loop.train_model); the
    compute dtype is cfg.model.train_dtype. `data_test` is evaluated once,
    on the best state. `eval_train`: also evaluate retrieval on the
    training split.
    `pointnet_ckpt`: a reference-layout PointNet .pth grafted into the
    object tower before training. `workdir`: checkpoints in
    <workdir>/coarse_ckpt and the metrics log; `resume` continues from
    them. `prefetch`: gather the host batches on a worker thread (the same
    draws and results as without). `mesh`: a parallel.mesh.Mesh to train
    over (the module docstring; `device` is then the mesh's, and
    cfg.train.batch_size the global batch, a multiple of the mesh size)."""
    t = cfg.train
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=cfg.model.train_dtype))
    device = loop.trainer_device(mesh, device)
    main = loop.is_main(mesh)
    model = loop.train_model(cfg, "coarse", device, model, fused_train, t.seed,
                             pointnet_ckpt, verbose=main)
    n_train = data_train.num_poses
    steps_per_epoch = max(n_train // t.batch_size, 1)
    optimizer = steps_lib.make_optimizer(model.parameters(), cfg, steps_per_epoch)
    generator = torch.Generator(device=device).manual_seed(t.seed)
    step_fn = steps_lib.make_coarse_train_step(model, embedder, cfg, optimizer, generator,
                                               mesh=mesh)
    state = steps_lib.TrainState(model, optimizer)
    eval_embedder = embedder.to(device)

    def evaluate(data):
        model.eval()
        return eval_retrieval(data, model, eval_embedder, cfg, device=device)

    logger = MetricLogger(os.path.join(workdir, "coarse_metrics.jsonl")
                          if workdir and main else None, quiet=not main)
    ckpt, start_epoch, resumed_best = loop.open_checkpoints(workdir, "coarse_ckpt", "max",
                                                            resume, state, verbose=main)
    if mesh is not None:
        replicate_state(state, mesh)
    timer = StageTimer()
    order_rng = np.random.default_rng(t.seed)
    close_rng = np.random.default_rng(t.seed + 7) if t.sample_close_cell else None
    neg_rng = (np.random.default_rng(t.seed + 13)
               if t.loss.ranking_loss == "triplet" else None)
    best_val = -np.inf if resumed_best is None else float(resumed_best)
    # Saves are gated on improvement, so the restored state is the best.
    best_state = loop.snapshot(model) if resumed_best is not None else None
    for epoch in range(start_epoch, t.epochs):
        perm = order_rng.permutation(n_train)[: steps_per_epoch * t.batch_size]

        def epoch_batches(perm=perm):
            # On the prefetch worker, in order: the close-cell and negative
            # draws advance as in the serial loop.
            for bstart in range(0, len(perm), t.batch_size):
                yield data_train.gather_coarse(
                    perm[bstart:bstart + t.batch_size], cfg.model.object_size,
                    sample_close_rng=close_rng, negative_rng=neg_rng)

        with timer.stage("train_epoch"):
            row = loop.run_epoch(step_fn, loop.local_rows(epoch_batches(), mesh), epoch,
                                 logger, prefetch)
        if eval_train and (epoch + 1) % eval_every == 0:
            with timer.stage("eval_train"):
                tr_acc, _, _ = evaluate(data_train)
            row.update({f"train_recall@{k}": v for k, v in tr_acc.items()})
        if data_val is not None and (epoch + 1) % eval_every == 0:
            with timer.stage("eval_val"):
                acc, _, _ = evaluate(data_val)
            # Best gating: the mean recall over the configured k values.
            val_acc = float(np.mean(list(acc.values())))
            row.update({f"val_recall@{k}": v for k, v in acc.items()})
            row["val_acc"] = val_acc
            if val_acc > best_val:
                best_val = val_acc
                best_state = loop.snapshot(model)
                if ckpt is not None:
                    loop.save_checkpoint(ckpt, epoch, state, val_acc, mesh)
        logger.log(epoch, **row)

    if main:
        print(timer.report(), flush=True)
    if best_state is None:
        best_state = loop.snapshot(model)
    model.load_state_dict(best_state)
    if data_test is not None:
        acc, acc_close, _ = evaluate(data_test)
    if data_test is not None and main:
        print("test recall: " + "  ".join(f"R@{k}={v:0.4f}" for k, v in acc.items())
              + "  close: " + "  ".join(f"@{k}={v:0.4f}" for k, v in acc_close.items()),
              flush=True)
    if workdir is not None and main:
        logger.plot(os.path.join(workdir, "coarse_metrics.png"))
        if ckpt is not None:
            ckpt.close()
    return best_state, model, logger


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--base_path", default=None, help="KITTI360Pose pickle root")
    ap.add_argument("--array_cache", default=None, help="npz cache dir for ingest")
    ap.add_argument("--workdir", default=None,
                    help="checkpoints (<workdir>/{coarse,fine}_ckpt, the port's own "
                         "torch.save files) and the metrics log")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--learning_rate", type=float, default=None)
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks (0=off); run under torchrun "
                         "--nproc_per_node DP")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic scenes at the small test config")
    ap.add_argument("--debug_nans", action="store_true",
                    help="autograd anomaly mode; a non-finite loss or gradient raises, "
                         "naming the parameter")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --workdir")
    ap.add_argument("--eval_train", action="store_true",
                    help="also evaluate train-split recall every epoch")
    ap.add_argument("--text_table", default=None,
                    help="frozen T5 table .npz; default: the compositional stand-in")
    ap.add_argument("--pointnet_ckpt", default=None,
                    help="reference-layout PointNet .pth to graft before training")
    ap.add_argument("--body_dtype", default=None, choices=("float32", "bfloat16"),
                    help="compute dtype of the ObjectEncoder/PointNet body (default: "
                         "the train dtype, float32)")
    return ap


def _parse(ap: argparse.ArgumentParser, argv):
    """The CLI's arguments. --dp N runs as N processes under torchrun: a
    different WORLD_SIZE raises."""
    args = ap.parse_args(argv)
    world = os.environ.get("WORLD_SIZE")
    if args.dp and (world is None or int(world) != args.dp):
        raise ValueError(
            f"--dp {args.dp} runs as {args.dp} processes under torchrun (torchrun "
            f"--nproc_per_node {args.dp} -m text2loc_tpu_torch.training.<coarse|fine> "
            f"--dp {args.dp} ...); this process has WORLD_SIZE={world}")
    return args


@contextlib.contextmanager
def _run_context(args):
    """The process-wide settings of one CLI run, undone on exit: anomaly
    mode and the step checks under --debug_nans, and --dp's mesh (yielded;
    None without --dp) over cuda:LOCAL_RANK with NCCL, or the CPU with gloo
    under --device cpu, its process group destroyed on exit."""
    from text2loc_tpu_torch.parallel.mesh import make_mesh
    from text2loc_tpu_torch.utils.debug import enable_nan_debugging

    if args.debug_nans:
        enable_nan_debugging()
    mesh = None
    try:
        if args.dp:
            mesh = make_mesh(args.dp, device="cpu" if args.device == "cpu" else None)
        yield mesh
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
        if args.debug_nans:
            enable_nan_debugging(False)


def _apply_overrides(cfg, args):
    train = cfg.train
    for name in ("epochs", "batch_size", "learning_rate"):
        v = getattr(args, name)
        if v is not None:
            train = dataclasses.replace(train, **{name: v})
    cfg = cfg.replace(train=train)
    if args.body_dtype:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, body_dtype=args.body_dtype))
    return cfg


def _load_data(cfg, args):
    """(cfg, train, val, test): with --synthetic, three 8-cell scenes at the
    small test config (with the flags' overrides); else the train, val and
    test splits of --base_path, converted once into --array_cache, with
    `cfg` as given."""
    if args.synthetic:
        from text2loc_tpu_torch.config import small_test_config
        from text2loc_tpu_torch.data.arrays import MultiSceneArrays
        from text2loc_tpu_torch.data.synthetic import make_scene

        cfg = _apply_overrides(small_test_config(), args)

        def split(seed):
            return MultiSceneArrays([make_scene(
                scene_name=f"{seed:04d}", num_cells=8, num_poses=32,
                object_slots=cfg.model.object_size,
                num_points=cfg.model.pointnet.num_points,
                num_mentioned=cfg.model.num_mentioned, seed=seed)])

        return cfg, split(0), split(1), split(2)
    if not args.base_path:
        raise ValueError("--base_path or --synthetic required")
    from text2loc_tpu_torch.data.ingest import load_dataset

    return (cfg, *(load_dataset(args.base_path, name, out_dir=args.array_cache)
                   for name in ("train", "val", "test")))


def main(argv=None):
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.models.text_embedding import make_embedder

    args = _parse(build_argparser(), argv)
    cfg = _apply_overrides(Config().validate(), args)
    cfg, data_train, data_val, data_test = _load_data(cfg, args)
    cfg, embedder = make_embedder(cfg, args.text_table)
    with _run_context(args) as mesh:
        return train_coarse(cfg, data_train, data_val, embedder, workdir=args.workdir,
                            mesh=mesh, resume=args.resume, data_test=data_test,
                            pointnet_ckpt=args.pointnet_ckpt, eval_train=args.eval_train,
                            device=args.device)


if __name__ == "__main__":
    main()
