"""Where the time of the port's prep goes on one CUDA card.

    python3 scripts/profile_torch_prep.py [--out chiprun_out/profile_torch_prep.txt]

Run from the root of a checkout. It writes chip_smoke.py's synthetic
KITTI-360 drive (phase 17: 4 windows of 1,050,000 raw points over 400 m)
and runs the port's prep CLI on the card at its defaults (prep/prepare.py,
--array_dir included) four times, each from a fresh copy of the raw scene
(the prep caches the objects in it):

* warm-up: not reported (CUDA context, allocator);
* timed: the stage seconds and counts that prepare_scene returns;
* profiled: under torch.profiler, wall_s, device_ms (the summed durations
  of the device's kernels and copies), busy_ms (their union on the
  device's timeline), idle_share = 1 - busy / wall of the timed run, the
  number of device ops and the largest by summed time;
* cprofile: under cProfile, the host functions with the most time of
  their own (tottime, seconds).

One JSON line each, then the card's name and power limit. The profiler's
table goes to --out. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

SEED = 17


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                      "profile_torch_prep.txt"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_prep: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from profile_torch_serve import device_summary
    from text2loc_tpu_torch.prep import prepare

    with tempfile.TemporaryDirectory() as tmp:
        source = os.path.join(tmp, "source")
        raw_points = chip_smoke._write_raw_scene(source, SEED)

        def run(tag):
            raw, out = os.path.join(tmp, tag), os.path.join(tmp, f"{tag}_out")
            shutil.copytree(source, raw)
            argv = ["--path_in", raw, "--path_out", os.path.join(out, "data"),
                    "--scene_name", chip_smoke.PREP_SCENE,
                    "--array_dir", os.path.join(out, "arrays")]
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                stats = prepare.main(argv)
            torch.cuda.synchronize()
            stats["wall_s"] = time.perf_counter() - t
            return stats

        run("warm")
        timed = run("timed")
        print(json.dumps({"run": "timed", "raw_points": raw_points, **timed}), flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled = run("profiled")
        s = device_summary(prof, 1, top=12)
        print(json.dumps({"run": "profiled", "wall_s": profiled["wall_s"],
                          "idle_share": 1.0 - s["busy_ms"] / 1e3 / timed["wall_s"], **s}),
              flush=True)
        host = cProfile.Profile()
        host.enable()
        run("cprofile")
        host.disable()
        rows = sorted(pstats.Stats(host).stats.items(), key=lambda kv: -kv[1][2])[:15]
        print(json.dumps({"run": "cprofile", "top": [
            {"function": f"{os.path.relpath(f, REPO) if f.startswith(REPO) else f}:{line} {name}",
             "calls": nc, "tottime_s": tt, "cumtime_s": ct}
            for (f, line, name), (_, nc, tt, ct, _) in rows]}), flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "out": os.path.relpath(args.out, REPO)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
