#!/usr/bin/env python
"""Accuracy of the port's inference SA modes on trained weights, on the card.

The port's twin of scripts/validate_kernels.py, with the same protocol and
modes table: train coarse and fine with the port's trainers
(training/coarse.train_coarse, training/fine.train_fine) at the full
`Config()` shapes on a synthetic scene (f32 training, constant learning
rate, no fine warm-up, as the JAX script's one-epoch schedule), then
evaluate the SAME trained weights under every mode with run_pipeline in the
bf16 serving configuration, on unseen poses over the same map. A mode is a
pair of build_model arguments (`sa_mode`, `approx_neighbors`) in place of
the JAX script's environment variables; "exact" is the plain nearest-K
path ("off") and always runs first, as the baseline. Reports per mode:

* coarse retrieval recall@k (at the first threshold),
* end-to-end localization recall, the k=1 row over the thresholds,
* fine throughput (`fine_qps`) and the evaluation's wall seconds (the
  baseline's evaluation runs once before, untimed, as a warm-up),
* agreement with "exact": top-1 retrieval agreement and the mean
  |delta position| in metres over the (pose, candidate) pairs that
  retrieved the same cell.

On the card the kernel library's build (or load) time of this process is
reported first: a library built by an earlier process for the same sources
is found under build/ and loaded, not rebuilt (ops/_cuda.py).

Output: one JSON line per mode, then the whole report as one JSON object on
the last line (and in --out).

    python3 scripts/validate_kernels_torch.py [--steps 400] [--out report.json]

`--small --device cpu` runs the small test config on a tiny scene (the CPU
test of this script).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# scripts/validate_kernels.py's table, as the port's model arguments.
MODES = {
    "exact": dict(sa_mode="off", approx_neighbors=False),
    "gather_exact": dict(sa_mode="gather", approx_neighbors=False),
    "gather_approx": dict(sa_mode="gather", approx_neighbors=True),
    "fused_full": dict(sa_mode="full"),
    "fused_mixed": dict(sa_mode="full,full,all"),
    "fused_all": dict(sa_mode="all"),
    "fused_first": dict(sa_mode="first"),
    "fused_first_mixed": dict(sa_mode="first,first,all"),
    "fused_exact": dict(sa_mode="1"),
    "approx_knn": dict(sa_mode="off", approx_neighbors=True),
}


def _scenes(cfg, small: bool):
    """(train, held-out) maps: one synthetic scene, and unseen poses over
    the same cells (the JAX script's split)."""
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.synthetic import make_scene

    m = cfg.model
    cells, poses, held = (6, 2 * cfg.train.batch_size, 8) if small else (64, 512, 256)

    def mk(n, pose_seed=None):
        return make_scene("0000", num_cells=cells, num_poses=n,
                          object_slots=max(m.object_size, m.pad_size),
                          num_points=m.pointnet.num_points, num_mentioned=m.num_mentioned,
                          seed=0, pose_seed=pose_seed)

    return MultiSceneArrays([mk(poses)]), MultiSceneArrays([mk(held, pose_seed=7)])


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _agreement(base, r, data) -> dict:
    agree = base["retrievals"][:, 0] == r["retrievals"][:, 0]
    same = base["retrievals"] == r["retrievals"]
    if not same.any():
        return {"top1_agreement": float(agree.mean()), "mean_abs_dpos_m": None}
    import numpy as np

    d = np.linalg.norm((base["pos_in_cells"] - r["pos_in_cells"])[same], axis=-1)
    sizes = np.broadcast_to(data.cell_size[r["retrievals"]], same.shape)[same]
    return {"top1_agreement": float(agree.mean()), "mean_abs_dpos_m": float((d * sizes).mean())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400,
                    help="train steps of each stage (whole epochs of the trainers)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--modes", nargs="*", default=list(MODES), choices=list(MODES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="the small test config on a 6-cell scene (CPU tests)")
    args = ap.parse_args(argv)
    modes = ["exact"] + [m for m in args.modes if m != "exact"]

    import torch

    from text2loc_tpu_torch.config import Config, small_test_config
    from text2loc_tpu_torch.convert import build_model
    from text2loc_tpu_torch.evaluation.pipeline import run_pipeline
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.training.coarse import train_coarse
    from text2loc_tpu_torch.training.fine import train_fine

    dev = torch.device(args.device)
    report = {"device": _card() if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        from text2loc_tpu_torch.ops import _cuda

        cached = (_cuda.BUILD_ROOT / _cuda.source_hash() / _cuda.LIB_NAME).exists()
        t0 = time.perf_counter()
        _cuda.library()
        report["build"] = {"seconds": time.perf_counter() - t0, "found_built": cached}
        print(json.dumps({"build": report["build"]}), flush=True)

    cfg = (small_test_config() if args.small else Config()).validate()
    train_data, val_data = _scenes(cfg, args.small)
    spe = max(train_data.num_poses // cfg.train.batch_size, 1)
    epochs = max(math.ceil(args.steps / spe), 1)
    cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, learning_rate=args.lr, epochs=epochs,
                                  warmup_epochs=0),
        eval=dataclasses.replace(cfg.eval, top_k=(1, 3, 5, 10)))
    m = cfg.model
    embedder = HintTextEmbedder.compositional(m.text_embed_dim, m.max_hint_tokens)

    t0 = time.perf_counter()
    coarse_state, _, clog = train_coarse(cfg, train_data, None, embedder, device=dev,
                                         prefetch=False)
    fine_state, _, flog = train_fine(cfg, train_data, None, embedder, device=dev,
                                     prefetch=False)
    report["train"] = {"steps": epochs * spe, "epochs": epochs,
                       "seconds": time.perf_counter() - t0,
                       "coarse_loss": clog.history["loss"][-1],
                       "fine_loss": flog.history["loss"][-1]}
    print(json.dumps({"train": report["train"]}), flush=True)

    # The sweep runs the bf16 serving configuration on the trained weights.
    ecfg = cfg.replace(model=dataclasses.replace(m, dtype="bfloat16"))
    results, base = {}, None
    for mode in modes:
        towers = []
        for kind, state in (("coarse", coarse_state), ("fine", fine_state)):
            model = build_model(ecfg, kind, **MODES[mode])
            model.load_state_dict(state)
            towers.append(model.to(dev).eval())
        if base is None:      # warm-up of the baseline: allocator, cuBLAS
            run_pipeline(val_data, *towers, embedder, ecfg, device=dev, verbose=False)
        t0 = time.perf_counter()
        r = run_pipeline(val_data, *towers, embedder, ecfg, device=dev, verbose=False)
        entry = {
            **MODES[mode],
            "coarse_recall": {k: row[ecfg.eval.threshs[0]] for k, row in r["coarse"].items()},
            "loc_recall_top1": {t: r["fine"][1][t] for t in ecfg.eval.threshs},
            "fine_qps": r["fine_qps"],
            "eval_seconds": time.perf_counter() - t0,
        }
        base = base or r
        entry.update(_agreement(base, r, val_data))
        results[mode] = entry
        print(json.dumps({mode: entry}), flush=True)
    report["modes"] = results
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
