"""Split the training SA level's backward on the card into its passes, at
the coarse train step's three levels.

    python3 scripts/probe_torch_sa_train_bwd.py [--root DIR] [--reps 10]

`--root` names the checkout whose text2loc_tpu_torch is timed (default:
the one holding this script), e.g. a parent commit unpacked with `git
archive` beside the working tree. The inputs are chip_smoke.py's (896
clouds of 256 points, FPS centers, the exact nearest-32 ball query, seeded
random u, sv, weights and cotangent). For each level, compute dtype (f32,
bf16) and kernel (sa_train_bwd; sa_train_e_bwd, e rounded to bf16) it
prints one JSON line:

- `bwd_ms`: ops/sa_train.backward_cuda, the three passes with the
  correction sums between them;
- `stages`: ms of each pass alone with its reduce launches (`stats`,
  `mid`, `in`) and of the reduce launches alone (`reduce`);
- per pass (1 stats, 2 mid, 3 in): `rows`, the tile height; `tiles`,
  `mean_rows`, the tiles of edge rows the pass walks and their mean count
  of filled rows, from the masks and the tile height (computed on the
  host, as the kernels pack the edges); `blocks`, the grid; `resident`,
  whether W2 sits in shared memory (null for the kernels before the tensor
  core design, which read W2 from device memory);
- `blocks_per_sm`, `smem`: per pass, what
  cudaOccupancyMaxActiveBlocksPerMultiprocessor gives the kernel and its
  dynamic shared memory (null for the kernels before the tensor core
  design).

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


def tile_stats(maskm, maskf, rows: int, max_centers: int):
    """(tiles, mean filled rows) for a version without Level.bwd_tiles:
    each cloud's centers packed in order into tiles of `rows` edge rows and
    at most `max_centers` centers, an edge kept where it is valid in either
    mask."""
    kept = (maskm | maskf).sum(-1).cpu()                 # [N, S]
    n, s = kept.shape
    used = torch.zeros(n, dtype=torch.long)
    taken = torch.zeros(n, dtype=torch.long)
    tiles = torch.full((n,), 1 if s else 0, dtype=torch.long)
    for j in range(s):
        c = kept[:, j]
        new = (used + c > rows) | (taken == max_centers)
        tiles += new.long()
        used = torch.where(new, c, used + c)
        taken = torch.where(new, torch.ones_like(taken), taken + 1)
    total = int(tiles.sum())
    return total, float(kept.sum()) / max(total, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_sa_train_bwd: needs a CUDA card", file=sys.stderr)
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
        dout = rand((n, s, h2), 1.0)
        for dt in (torch.float32, torch.bfloat16):
            for name, cache in (("sa_train_bwd", None), ("sa_train_e_bwd", torch.bfloat16)):
                level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dt, cache)
                _, stats, aux1, aux2 = sa_train.forward_cuda(level, b2, g1, be1, g2, be2,
                                                             maskf, 1e-5)
                n1 = stats[4]
                bwd_ms = cuda_ms(lambda: sa_train.backward_cuda(level, aux1, aux2, n1, dout),
                                 args.reps)
                # The passes alone, each fed what the one before it gives.
                acc2 = level.bwd_stats(aux1, aux2, dout)
                aux2b = aux2.clone()
                aux2b[4], aux2b[5] = acc2[0] / n1, acc2[1] / n1
                acc1 = level.bwd_mid(aux1, aux2b, dout)[0]
                aux1b = aux1.clone()
                aux1b[4], aux1b[5] = acc1[0] / n1, acc1[1] / n1
                blocks = (level.bwd_blocks if hasattr(level, "bwd_blocks")
                          else lambda pid: level.blocks)
                parts = [torch.zeros(blocks(pid), *shape, device=dev) for pid, shape in
                         ((1, (2, h2)), (2, (2, h1)), (2, (h1, h2)), (2, (h2,)))]
                stages = {
                    "stats": cuda_ms(lambda: level.bwd_stats(aux1, aux2, dout), args.reps),
                    "mid": cuda_ms(lambda: level.bwd_mid(aux1, aux2b, dout), args.reps),
                    "in": cuda_ms(lambda: level.bwd_in(aux1b, aux2b, dout), args.reps),
                    "reduce": cuda_ms(lambda: [level._reduce(level.kernel_bwd, t)
                                               for t in parts], args.reps),
                }
                new = hasattr(level, "bwd_plan")
                plan = (level.bwd_plan if new
                        else lambda pid: (8 * level.rpt(pid == 3), None, None, None))
                tiles = {pid: level.bwd_tiles(pid) if new
                         else tile_stats(maskm, maskf, plan(pid)[0], 8) for pid in (1, 2, 3)}
                print(json.dumps({
                    "root": root, "kernel": name, "level": f"P={p} S={s} H={h1}->{h2}",
                    "edges": int(maskm.sum().item()), "dtype": str(dt).split(".")[-1],
                    "bwd_ms": bwd_ms, "stages": stages,
                    "blocks": {str(pid): blocks(pid) for pid in (1, 2, 3)},
                    "rows": {str(pid): plan(pid)[0] for pid in (1, 2, 3)},
                    "resident": {str(pid): plan(pid)[1] for pid in (1, 2, 3)},
                    "tiles": {str(pid): tiles[pid][0] for pid in tiles},
                    "mean_rows": {str(pid): tiles[pid][1] for pid in tiles},
                    "blocks_per_sm": {str(pid): plan(pid)[3] for pid in (1, 2, 3)},
                    "smem": {str(pid): plan(pid)[2] for pid in (1, 2, 3)}}), flush=True)
        pos = ctr
    return 0


if __name__ == "__main__":
    sys.exit(main())
