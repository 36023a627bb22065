"""Where the time of the port's cached serve goes on one CUDA card.

    python3 scripts/profile_torch_serve.py [--reps 20] [--out chiprun_out/profile_torch_serve.txt]

Run from the root of a checkout. It builds the serve that chip_smoke.py
drives (the default Config, bf16, a synthetic map of 2 scenes x 32 cells,
seeded random weights) and profiles three phases with torch.profiler:

* build: the Localizer's construction (gallery, fine cache, sentence
  tables), its wall time over 3 builds;
* batch1, batch64: `reps` requests of 1 and of 64 queries, after a warm-up.

For each phase it prints one JSON line, per request for the batches:

* wall_ms: the host clock over the phase without the profiler, and
  wall_ms_profiled with it;
* device_ms: the summed durations of the device's kernels and copies;
* busy_ms: their union on the device's timeline;
* idle_share: 1 - busy_ms / wall_ms, the device's idle share of the
  phase without the profiler (the device ops take the same time with it);
* device_ops: the number of kernels and copies;
* top: the largest device ops by summed time, with their counts.

The profiler's full tables go to --out. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEED = 0
BATCHES = (1, 64)


def build_map(cfg):
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.synthetic import make_scene

    m = cfg.model
    return MultiSceneArrays([
        make_scene(f"{i:04d}", num_cells=32, num_poses=64,
                   object_slots=m.object_size, num_points=m.pointnet.num_points,
                   num_mentioned=m.num_mentioned, seed=SEED + i)
        for i in range(2)
    ])


def device_summary(prof, per: int, top: int = 8) -> dict:
    """Device ops of one profile: summed and union time (ms), count, and the
    largest ops by summed time; totals divided by `per`."""
    spans, by_name = [], collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        by_name[evt.name][0] += (end - start) / 1e3
        by_name[evt.name][1] += 1
    busy_us, reach = 0.0, -float("inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    largest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device_ms": sum(ms for ms, _ in by_name.values()) / per,
        "busy_ms": busy_us / 1e3 / per,
        "device_ops": len(spans) / per,
        "top": [{"name": name[:80], "ms": ms / per, "count": n / per}
                for name, (ms, n) in largest],
    }


def timed(fn, reps: int) -> float:
    """Host milliseconds per call of fn() over `reps` calls, ending in a
    device synchronize."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def profiled(fn, reps: int):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed(fn, reps)
    return prof, wall


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                      "profile_torch_serve.txt"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.ops import _cuda
    from text2loc_tpu_torch.serving import Localizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _cuda.library()
    cfg = Config()
    data = build_map(cfg)
    gen = torch.Generator().manual_seed(SEED)
    coarse = init_weights(build_model(cfg, "coarse"), gen)
    fine = init_weights(build_model(cfg, "fine"), gen)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)

    def build():
        return Localizer(data, coarse, fine, emb, cfg, top_k=10, device=dev)

    build()                                   # warm-up: allocator, cuBLAS handles
    wall = timed(build, 3)
    prof, wall_prof = profiled(build, 1)
    phases = [("build", 1, wall, wall_prof, prof)]
    loc = build()
    for b in BATCHES:
        q = np.arange(b) % data.num_poses
        query = (data.hint_dir[q], data.hint_color[q], data.hint_label[q],
                 data.hint_mask[q])

        def request(query=query):
            return loc.localize(*query)

        request()
        wall = timed(request, args.reps)
        prof, wall_prof = profiled(request, args.reps)
        phases.append((f"batch{b}", args.reps, wall, wall_prof, prof))

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for name, per, wall, wall_prof, prof in phases:
            s = device_summary(prof, per)
            print(json.dumps({"phase": name, "per": "request" if per > 1 else "call",
                              "wall_ms": wall, "wall_ms_profiled": wall_prof,
                              "idle_share": 1.0 - s["busy_ms"] / wall, **s}),
                  flush=True)
            f.write(f"== {name} ({per} calls)\n")
            f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                              row_limit=40))
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
