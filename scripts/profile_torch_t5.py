"""Where the time of the port's online T5 encoder goes on one CUDA card.

    python3 scripts/profile_torch_t5.py [--reps 10] [--out chiprun_out/profile_torch_t5.txt]

Run from the root of a checkout. It builds the encoder that chip_smoke.py's
phase 15 drives (T5-large widths, 24 layers, f32, seeded random weights at
HF's initialisation scales, the vendored tiny tokenizer, T = 16) and
profiles `T5OnlineEncoder.encode` of 48 and of 8 styled sentences with
torch.profiler, after a warm-up. For each batch it prints one JSON line, per
call:

* tokenize_ms: the host tokenizer alone;
* wall_ms: the host clock over encode without the profiler, and
  wall_ms_profiled with it;
* device_ms, busy_ms, idle_share, device_ops, top: as
  scripts/profile_torch_serve.py defines them.

The profiler's full tables go to --out. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from profile_torch_serve import device_summary, profiled, timed  # noqa: E402

BATCHES = (48, 8)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                      "profile_torch_t5.txt"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_t5: no CUDA device", file=sys.stderr)
        return 2

    from chip_smoke import SEED, T5_LARGE, t5_state_dict
    from text2loc_tpu_torch import constants as C
    from text2loc_tpu_torch import text_styles
    from text2loc_tpu_torch.assets import load_tiny_tokenizer
    from text2loc_tpu_torch.models import t5_encoder as T5

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sd = t5_state_dict(T5_LARGE, SEED + 15)
    params, cfg = T5.convert_t5_encoder({k: v.numpy() for k, v in sd.items()})
    del sd
    tokenizer = load_tiny_tokenizer()
    enc = T5.T5OnlineEncoder(params, cfg, tokenizer, max_tokens=16, device=dev)
    del params
    rng = np.random.default_rng(SEED)
    sentences = [text_styles.render_styled_hint(int(rng.integers(C.NUM_DIRECTIONS)),
                                                int(rng.integers(C.NUM_COLORS)),
                                                int(rng.integers(C.NUM_CLASSES)), rng)
                 for _ in range(max(BATCHES))]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for b in BATCHES:
            batch = sentences[:b]

            def call(batch=batch):
                return enc.encode(batch)

            call()
            t = time.perf_counter()
            for _ in range(args.reps):
                tokenizer(batch, max_length=16)
            tokenize_ms = (time.perf_counter() - t) * 1e3 / args.reps
            wall = timed(call, args.reps)
            prof, wall_prof = profiled(call, args.reps)
            s = device_summary(prof, args.reps)
            print(json.dumps({"phase": f"encode{b}", "per": "call", "tokenize_ms": tokenize_ms,
                              "wall_ms": wall, "wall_ms_profiled": wall_prof,
                              "idle_share": 1.0 - s["busy_ms"] / wall, **s}), flush=True)
            f.write(f"== encode{b} ({args.reps} calls)\n")
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
