"""Both trainers of the port on one CUDA card, with and without prefetch.

    python3 scripts/probe_torch_trainers.py [--epochs 2]

Run from the root of a checkout. It trains at chip_smoke.py's phase-8
configuration (the default Config, f32 body, batch 32, a synthetic map of
32 cells and 96 poses, a 32-pose validation split of the same cells, PMC
tables on the map's grid neighbours with pmc_prob 0.5; seeded random
weights, the same for every run) and prints one JSON line per run, in the
order prefetch on, off, off, on:

* coarse / fine: each step's host seconds as the trainer records them
  (logger.steps: the step dispatched and its loss read back), the median
  of the steps after each run's first, the run's wall seconds;

then one line of the pieces around the steps, each timed alone:

* gather_coarse_ms / gather_fine_ms: one host batch (gather_fine with its
  sample_pmc draw), the work the prefetch worker takes off the step;
* eval_retrieval_ms / eval_fine_ms: one validation evaluation;
* checkpoint_save_ms / checkpoint_restore_ms: the fine trainer's state
  (model, Adam, schedule) through utils/checkpoint.CheckpointManager;
* plot_ms: MetricLogger.plot of a trained run's rows (None where
  matplotlib is absent), which a trainer with a workdir calls at its end.

The card's name and power limit come first. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of fn(), the card synchronized around it."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_trainers: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.pmc import sample_pmc
    from text2loc_tpu_torch.evaluation.retrieval import eval_retrieval
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.ops import _cuda
    from text2loc_tpu_torch.training import steps
    from text2loc_tpu_torch.training.coarse import train_coarse
    from text2loc_tpu_torch.training.fine import eval_fine, train_fine
    from text2loc_tpu_torch.utils.checkpoint import CheckpointManager

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.library()
    dev = torch.device("cuda", 0)
    cfg = smoke._train_cfg(batch_size=32, epochs=args.epochs)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, pmc_prob=0.5))
    data = smoke._train_map(cfg, num_poses=96)
    data_pmc = MultiSceneArrays([smoke._with_pmc(data.scenes[0], smoke.SEED + 7)])
    val = smoke._val_map(cfg, num_poses=32)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)
    weights = {kind: init_weights(build_model(cfg, kind), torch.Generator().manual_seed(
        smoke.SEED + 2)).state_dict() for kind in ("coarse", "fine")}

    def fresh(kind):
        model = build_model(cfg, kind)
        model.load_state_dict(weights[kind])
        return model.to(dev)

    for prefetch in (True, False, False, True):
        row = {"prefetch": prefetch}
        for kind, train, data_k in (("coarse", train_coarse, data), ("fine", train_fine,
                                                                      data_pmc)):
            model = fresh(kind)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, log = train(cfg, data_k, val, emb, device=dev, model=model,
                              prefetch=prefetch)
            torch.cuda.synchronize()
            step_ms = [r["seconds"] * 1e3 for r in log.steps]
            row[kind] = {"step_ms": step_ms,
                         "median_step_ms_after_first": statistics.median(step_ms[1:]),
                         "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)

    rng = np.random.default_rng(0)
    idx = np.arange(32)
    coarse_model, fine_model = fresh("coarse").eval(), fresh("fine")
    emb_dev = emb.to(dev)
    forward = steps.make_fine_forward(fine_model, emb, cfg)
    opt = steps.make_fine_optimizer(fine_model.parameters(), cfg, steps_per_epoch=3)
    sum(p.sum() for p in fine_model.parameters()).backward()
    opt.step()                                   # Adam's moments in the state
    state = steps.TrainState(fine_model, opt)
    with tempfile.TemporaryDirectory(prefix="t2l_probe_") as d:
        mgr = CheckpointManager(d, mode="min")
        counter = iter(range(10 ** 6))

        def save():
            s = next(counter)
            assert mgr.save(s, state, -float(s))     # each save beats the last

        save_ms = _ms(save)
        restore_ms = _ms(lambda: mgr.restore(state))
        ckpt_mb = max(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
                      if f.endswith(".pt")) / 1e6
    _, _, log = train_fine(cfg, data_pmc, val, emb, device=dev, model=fresh("fine"))
    with tempfile.TemporaryDirectory(prefix="t2l_probe_plot_") as d:
        t0 = time.perf_counter()
        plotted = log.plot(os.path.join(d, "fine_metrics.png"))
        plot_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({
        "gather_coarse_ms": _ms(lambda: data.gather_coarse(idx, cfg.model.object_size)),
        "gather_fine_ms": _ms(lambda: data_pmc.gather_fine(
            idx, cfg.model.pad_size, *sample_pmc(data_pmc, idx, rng, 0.5))),
        "eval_retrieval_ms": _ms(lambda: eval_retrieval(val, coarse_model, emb_dev, cfg,
                                                        device=dev)),
        "eval_fine_ms": _ms(lambda: eval_fine(val, fine_model, emb, cfg, forward=forward)),
        "checkpoint_save_ms": save_ms, "checkpoint_restore_ms": restore_ms,
        "checkpoint_mb": ckpt_mb,
        "plot_ms": plot_ms if plotted else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
