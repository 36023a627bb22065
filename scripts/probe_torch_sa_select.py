"""Time the inference SA level on the card in one selection (`sa_select_first`,
`sa_select_bisect`, `sa_gather`, `sa_exact`, `sa_all`, all on the
tensor-core tile kernel of csrc/sa_select_tc.cuh) at chip_smoke.py's three
gallery levels.

    python3 scripts/probe_torch_sa_select.py
        [--selection first|gather|all|bisect|exact] [--root DIR] [--reps 10]
        [--layouts] [--bisect_iters 12]

`--selection` (default first): "first" and "bisect" time
ops/cuda_pointconv.sa_select_cuda with that selection (bisect:
`--bisect_iters` rounds);
"gather" sa_gather_cuda over the exact and the approximate ball query's
neighbours (two lines a level); "all" and "exact" set_abstraction_cuda
with select_k False and True. `--root` names the checkout whose
text2loc_tpu_torch is timed (default: the one holding this script), e.g. a
parent commit unpacked with `git archive` beside the working tree; run
parent, change, change, parent in one call to compare two trees on one
card. The cases are the smoke's: 1792 clouds of 256 points (a 64-cell
gallery), their FPS ladder's prefixes as centers, K = 32, the levels P=256
S=128 6->32->64, P=128 S=64 67->128->128 and P=64 S=32 131->256->256 of
Config(), in bf16 and f32, inputs made from a seed as the smoke makes them
(x, pos, feat = concat(x, pos); "all" reads x and the rows of W1 for x).
For each it prints one JSON line:

- `ms`: one wrapper call per CUDA event pair, median of `--reps`, as
  chip_smoke.py times it;
- `kernel_ms`: 50 wrapper calls between two events, queued behind a device
  sleep so that the host's dispatch is off the span, divided by 50
  (chip_smoke.kernel_ms);
- `plain_ms`: the plain version (ops/pointconv), timed as `ms`;
- `edges`: the valid edges of the case;
- `plan`: the tile kernel's plan (tile rows, W2 resident, shared bytes,
  blocks per SM, column slices, the row map's budget of "all"; null where
  the checkout runs the selection on an older template) and `ptxas`: the
  instantiation's registers and spill bytes from the build's ptxas output,
  where the checkout runs the selection on the tile kernel (null otherwise).

`--layouts` (a selection the checkout runs on the tile kernel) adds, per case,
`layouts`: the kernel alone (no launch count) on every tile layout it
takes at the level, {"rows,resident,budget": [blocks per SM, ms]}, ms
timed as `ms` on the persistent grid of that layout's occupancy, the
plan's choice among them.

The first line is the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
SOURCE = {"first": ("sa_select.cu", "sa_select_first_kernel"),
          "bisect": ("sa_select_bisect.cu", "sa_select_bisect_kernel"),
          "gather": ("sa_gather.cu", "sa_gather_kernel"),
          "exact": ("sa_exact.cu", "sa_exact_kernel"), "all": ("sa_all.cu", "sa_all_kernel")}


def tiled(cp, selection):
    """Whether the checkout runs the selection on the tile kernel (with a plan)."""
    return selection in getattr(cp, "TILE_KERNELS", {})


def ptxas_of(_cuda, cp, selection, dt, h1, h2):
    """Registers and spill bytes of the level's kernel instantiation on the
    tile kernel (None where the checkout runs it on an older template)."""
    if not tiled(cp, selection):
        return None
    source, kernel = SOURCE[selection]
    # The tile kernel's second template argument is its width class.
    second = cp.width_class(h1, h2)
    tag = ("If" if dt == torch.float32 else "I13__nv_bfloat16") + f"Li{second}E"
    for name, info in _cuda.ptxas_report(source).items():
        if kernel in name and tag in name:
            return info
    return None


def layout_times(smoke, _cuda, cp, selection, a, dt, reps, iters):
    """{"rows,resident,budget": [blocks per SM, ms]} of the kernel alone on
    every tile layout it takes for the case's tile-entry arguments `a`
    (feat, pos, ctr, idx, mask, w1, wp, ab1, w2, ab2, radius, k, s)."""
    feat, pos, ctr, idx, mask, w1, wp, ab1, w2, ab2, radius, k, s = a
    # The bisection's rounds follow r2 where the entry takes them (every
    # selection on the tile kernel).
    r2 = (ctypes.c_float(radius * radius),) + ((iters,) if tiled(cp, "bisect") else ())
    n, p, c = feat.shape
    h1, h2 = w1.shape[1], w2.shape[1]
    lib, code = _cuda.library(), _cuda.DTYPE_CODE[dt]
    out = torch.empty((n, s, h2), dtype=dt, device=feat.device)
    sms = _cuda.sm_count(feat.device.index)
    ptrs = tuple(None if t is None else _cuda.ptr(t)
                 for t in (feat, pos, ctr, idx, mask, w1, wp, ab1, w2, ab2, out))
    times = {}
    for rows, resident, _, budget in cp.tile_layouts(p, s, c, h1, h2, k, dt, selection):
        occ = ctypes.c_int(0)
        getattr(lib, f"t2l_sa_{selection}_occupancy")(p, s, c, h1, h2, k, rows, resident,
                                                      budget, code, ctypes.byref(occ))
        if occ.value < 1:
            continue
        args = (*ptrs, n, p, s, c, h1, h2, k, *r2, rows, resident, budget,
                min(n, sms * occ.value), code)
        times[f"{rows},{resident},{budget}"] = [occ.value, smoke.cuda_ms(
            lambda args=args: _cuda.launch(cp.TILE_KERNELS[selection], f"t2l_sa_{selection}",
                                           *args, count=False), reps)]
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--selection", default="first", choices=tuple(SOURCE))
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--layouts", action="store_true",
                    help="time the kernel alone on every tile layout it takes")
    ap.add_argument("--bisect_iters", type=int, default=12,
                    help="rounds of threshold bisection of selection bisect")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_sa_select: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # This checkout's chip_smoke.py (its timers and inputs), whatever --root is.
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from text2loc_tpu_torch.ops import _cuda
    from text2loc_tpu_torch.ops import cuda_pointconv as cp
    from text2loc_tpu_torch.ops import pointconv as pc
    from text2loc_tpu_torch.ops.ballquery import ball_query_knn, squared_distances
    from text2loc_tpu_torch.ops.fps import farthest_point_sampling_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    n, k, sel, iters = 64 * 28, 32, args.selection, args.bisect_iters
    pts = smoke._clouds(gen, n, 256, dev)
    xyz = farthest_point_sampling_plain(pts, 128)[1]
    has_plan = hasattr(cp, "tile_plan")
    for dt in (torch.bfloat16, torch.float32):
        pos = pts
        for lp, s, cin, h1, h2, radius in smoke.SA_LEVELS:
            ctr = xyz[:, :s].contiguous()
            x = smoke._rand(gen, (n, lp, cin - 3), 1.0, dev).to(dt)
            feat = torch.cat([x, pos.to(dt)], -1).contiguous()
            w1 = smoke._rand(gen, (cin, h1), cin ** -0.5, dev).to(dt)
            w2 = smoke._rand(gen, (h1, h2), h1 ** -0.5, dev).to(dt)
            ab1 = torch.stack([smoke._rand(gen, h1, 0.1, dev, 1.0),
                               smoke._rand(gen, h1, 0.1, dev)]).contiguous()
            ab2 = torch.stack([smoke._rand(gen, h2, 0.1, dev, 1.0),
                               smoke._rand(gen, h2, 0.1, dev)]).contiguous()
            wx, wp = w1[:cin - 3].contiguous(), w1[cin - 3:].contiguous()
            cases = []
            if sel in ("first", "bisect"):
                a = (feat, pos, ctr, w1, wp, ab1, w2, ab2, radius, k)
                edges = (ball_query_knn(pos, ctr, radius, k, first=True)[1] if sel == "first"
                         else pc.first_k(pc.bisect_mask(
                             squared_distances(pos, ctr),
                             squared_distances(pos, ctr) <= radius * radius,
                             radius * radius, k, iters), k)[1])
                kw = {"selection": sel, "bisect_iters": iters}
                cases.append(("", lambda a=a: cp.sa_select_cuda(*a, **kw),
                              lambda a=a: pc.sa_select_plain(*a, **kw),
                              int(edges.sum()),
                              (feat, pos, ctr, None, None, w1, wp, ab1, w2, ab2, radius, k, s)))
            elif sel == "gather":
                for approx in (False, True):
                    idx, mask = ball_query_knn(pos, ctr, radius, k, approx=approx)
                    idx = idx.to(torch.int32).contiguous()
                    a = (feat, ctr, idx, mask, w1, wp, ab1, w2, ab2)
                    cases.append(("approx " if approx else "exact ",
                                  lambda a=a: cp.sa_gather_cuda(*a),
                                  lambda a=a: pc.sa_gather_plain(*a), int(mask.sum()),
                                  (feat, None, ctr, idx, mask, w1, wp, ab1, w2, ab2, 0.0, k,
                                   s)))
            else:
                a = (x, pos, ctr, wx, wp, ab1, w2, ab2, radius, k)
                sk = sel == "exact"
                inr = (squared_distances(pos, ctr) <= radius * radius).sum(-1)
                cases.append(("", lambda a=a, sk=sk: cp.set_abstraction_cuda(*a, select_k=sk),
                              lambda a=a, sk=sk: pc.set_abstraction_plain(*a, select_k=sk),
                              int((inr.clamp(max=k) if sk else inr).sum()),
                              (x, pos, ctr, None, None, wx, wp, ab1, w2, ab2, radius, k, s)))
            c = cin - 3 if sel in ("all", "exact") else cin
            on_tiles = has_plan and tiled(cp, sel)
            plan = cp.tile_plan(lp, s, c, h1, h2, k, dt, sel) if on_tiles else None
            for tag, call, plain, edges, targs in cases:
                print(json.dumps({
                    "root": root, "selection": sel,
                    "case": f"{tag}P={lp} S={s} {cin}->{h1}->{h2}",
                    "dtype": str(dt).split(".")[-1], "edges": edges,
                    "ms": smoke.cuda_ms(call, args.reps),
                    "kernel_ms": smoke.kernel_ms(call, args.reps),
                    "plain_ms": smoke.cuda_ms(plain, args.reps),
                    "plan": None if plan is None else plan._asdict(),
                    "ptxas": ptxas_of(_cuda, cp, sel, dt, h1, h2) if has_plan else None,
                    **({"layouts": layout_times(smoke, _cuda, cp, sel, targs, dt, args.reps,
                                                iters)}
                       if args.layouts and on_tiles else {})}),
                      flush=True)
            pos = ctr
    return 0


if __name__ == "__main__":
    sys.exit(main())
