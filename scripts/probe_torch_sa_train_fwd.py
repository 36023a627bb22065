"""Split the training SA level's forward on the card into its passes, at
the coarse train step's three levels.

    python3 scripts/probe_torch_sa_train_fwd.py [--root DIR] [--reps 10]

`--root` names the checkout whose text2loc_tpu_torch is timed (default:
the one holding this script), e.g. a parent commit unpacked with `git
archive` beside the working tree. The inputs are chip_smoke.py's (896
clouds of 256 points, FPS centers, the exact nearest-32 ball query, seeded
random u, sv and weights). For each level, compute dtype (f32, bf16) and
kernel (sa_train_fwd; sa_train_e_fwd, e rounded to bf16) it prints one
JSON line:

- `fwd_ms`: ops/sa_train.forward_cuda, the three passes with the BN
  finalization between them; `plain_ms`: the plain forward;
- `stages`: ms of each pass alone with its reduce launch (`stats1`,
  `stats2`, `out`) and of the two reduce launches alone (`reduce`);
- each pass's plan (Level.fwd_plan, "1" "2" "3"): `rows`, the tile
  height (stats1 takes no tiles: 0), `resident` (W2 held in shared memory),
  `blocks_per_sm` (the occupancy query's), `blocks` (the grid), and for the
  two passes that form z `tiles`: (tiles, mean filled rows), from the
  masks, as the kernels pack the edges. A checkout from before the plan
  (`--root`) gives its one layout of 8 x rpt rows and 2 blocks per SM.

Each time is the median of `--reps` by CUDA events after a warm-up. The
first line is the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

SEED = 3
LEVELS = [(256, 128, 32, 64, 0.2), (128, 64, 128, 128, 0.3), (64, 32, 256, 256, 0.4)]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_sa_train_fwd: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from text2loc_tpu_torch.ops import cuda_fps, cuda_sa_train, sa_train
    from text2loc_tpu_torch.ops.ballquery import ball_query_knn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    n, k = 32 * 28, 32
    pts = torch.randn(n, 256, 3, generator=gen) * torch.rand(n, 1, 3, generator=gen)
    pts = pts - pts.mean(dim=1, keepdim=True)
    pts = (pts / pts.abs().amax(dim=(1, 2), keepdim=True) * 0.999999).to(dev).contiguous()
    _, xyz = cuda_fps.farthest_point_sampling_cuda(pts, 128)
    obj = (torch.arange(n, device=dev) % 28) < 21
    pos = pts
    for p, s, h1, h2, radius in LEVELS:
        ctr = xyz[:, :s].contiguous()
        idx, maskm = ball_query_knn(pos, ctr, radius, k)
        idx = idx.to(torch.int32).contiguous()
        maskf = maskm & obj[:, None, None]

        def rand(shape, scale, mean=0.0):
            return (torch.randn(shape, generator=gen) * scale + mean).to(dev)

        u, sv, w2 = rand((n, p, h1), 1.0), rand((n, s, h1), 0.5), rand((h1, h2), h1 ** -0.5)
        b2, be1, be2 = rand(h2, 0.1), rand(h1, 0.1), rand(h2, 0.1)
        g1, g2 = rand(h1, 0.1, 1.0), rand(h2, 0.1, 1.0)
        for dt in (torch.float32, torch.bfloat16):
            for name, cache in (("sa_train_fwd", None), ("sa_train_e_fwd", torch.bfloat16)):
                level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dt, cache)
                _, _, aux1, aux2 = sa_train.forward_cuda(level, b2, g1, be1, g2, be2, maskf,
                                                         1e-5)
                fwd_ms = cuda_ms(lambda: sa_train.forward_cuda(level, b2, g1, be1, g2, be2,
                                                               maskf, 1e-5), args.reps)
                plain_ms = cuda_ms(lambda: sa_train.sa_train_plain(
                    u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf, compute_dtype=dt,
                    cache_dtype=cache), args.reps)
                if hasattr(level, "fwd_plan"):
                    passes = (1, 2, 3)
                    plan = {str(i): level.fwd_plan(i) for i in passes}
                    grid = {i: level.fwd_blocks(i) for i in passes}
                    layout = {"rows": {i: v[0] for i, v in plan.items()},
                              "resident": {i: v[1] for i, v in plan.items()},
                              "blocks_per_sm": {i: v[3] for i, v in plan.items()},
                              "blocks": {str(i): grid[i] for i in passes},
                              "tiles": {str(i): level.fwd_tiles(i) for i in (2, 3)}}
                else:
                    grid = {1: level.blocks, 2: level.blocks}
                    layout = {"rows": 8 * level.rpt(), "resident": 0,
                              "blocks_per_sm": cuda_sa_train.FWD_BLOCKS_PER_SM,
                              "blocks": level.blocks, "tiles": level.fwd_tiles()}
                parts = [torch.zeros(grid[i], 2, h, device=dev) for i, h in ((1, h1), (2, h2))]
                stages = {
                    "stats1": cuda_ms(lambda: level.stats(1, aux1, aux2), args.reps),
                    "stats2": cuda_ms(lambda: level.stats(2, aux1, aux2), args.reps),
                    "out": cuda_ms(lambda: level.out(aux1, aux2), args.reps),
                    "reduce": cuda_ms(lambda: [level._reduce(level.kernel_fwd, t)
                                               for t in parts], args.reps),
                }
                print(json.dumps({
                    "root": root, "kernel": name, "level": f"P={p} S={s} H={h1}->{h2}",
                    "edges": int(maskm.sum().item()), "dtype": str(dt).split(".")[-1],
                    "fwd_ms": fwd_ms, "plain_ms": plain_ms, "stages": stages, **layout}),
                    flush=True)
        pos = ctr
    return 0


if __name__ == "__main__":
    sys.exit(main())
