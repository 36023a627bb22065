"""Where the time of the port's coarse-to-fine evaluation goes on one CUDA
card, per inference SA mode.

    python3 scripts/profile_torch_pipeline.py [--reps 3] [--modes off first ...]
        [--out build/profile_torch_pipeline.txt]

Run from the root of a checkout. It builds the evaluation that chip_smoke.py
drives (the default Config, bf16, a synthetic map of 2 scenes x 32 cells
with 128 poses, top-10, seeded random weights) and, for each SA mode,
profiles its two stages with torch.profiler after a warm-up:

* coarse: run_coarse (the gallery through PointNet2 and the coarse tower,
  the queries through the text trunk, top-k, the center-guess table);
* fine: run_fine on the coarse stage's retrievals (each distinct retrieved
  cell through PointNet2 and the CCT's object block, each query's hints,
  cct_tail per pair, the table).

For each (mode, stage) it prints one JSON line: wall_ms (host clock without
the profiler, mean of --reps calls ending in a synchronize), device_ms,
busy_ms, idle_share (1 - busy_ms / wall_ms), device_ops, sa_ms (the
inference SA kernels' device time, SA_KERNELS) and the largest device ops. The
profiler's tables go to --out. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
from torch.autograd import DeviceType

from profile_torch_serve import REPO, SEED, build_map, device_summary, profiled, timed

MODES = ("off", "first", "full", "gather", "exact", "all", "full,full,all")
# The inference SA level's kernels: the tile kernel's selections
# (csrc/sa_select_tc.cuh).
SA_KERNELS = ("sa_select_first_kernel", "sa_select_bisect_kernel", "sa_gather_kernel",
              "sa_exact_kernel", "sa_all_kernel")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--modes", nargs="*", default=list(MODES))
    parser.add_argument("--out", default=os.path.join(REPO, "build",
                                                      "profile_torch_pipeline.txt"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_pipeline: no CUDA device", file=sys.stderr)
        return 2

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.evaluation.pipeline import run_coarse, run_fine
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _cuda.library()
    cfg = Config()
    data = build_map(cfg)
    gen = torch.Generator().manual_seed(SEED)
    state = {kind: init_weights(build_model(cfg, kind), gen).state_dict()
             for kind in ("coarse", "fine")}
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens, device=dev)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for mode in args.modes:
            models = {}
            for kind in ("coarse", "fine"):
                model = build_model(cfg, kind, sa_mode=mode)
                model.load_state_dict(state[kind])
                models[kind] = model.to(dev).eval()
            _, retrievals = run_coarse(data, models["coarse"], emb, cfg, dev)
            stages = {
                "coarse": lambda: run_coarse(data, models["coarse"], emb, cfg, dev),
                "fine": lambda: run_fine(data, retrievals, models["fine"], emb, cfg,
                                         device=dev),
            }
            for stage, fn in stages.items():
                fn()                                 # warm-up
                wall = timed(fn, args.reps)
                prof, wall_prof = profiled(fn, 1)
                s = device_summary(prof, 1)
                sa_ms = sum(evt.time_range.end - evt.time_range.start
                            for evt in prof.events()
                            if evt.device_type == DeviceType.CUDA
                            and any(k in evt.name for k in SA_KERNELS)) / 1e3
                print(json.dumps({"mode": mode, "stage": stage, "wall_ms": wall,
                                  "wall_ms_profiled": wall_prof,
                                  "idle_share": 1.0 - s["busy_ms"] / wall,
                                  "sa_ms": sa_ms, **s}), flush=True)
                f.write(f"== {mode} {stage}\n")
                f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                                  row_limit=30))
                f.write("\n")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "out": os.path.relpath(args.out, REPO)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
