"""Time the inference SA level with "first" selection on the card
(`sa_select_first`) at chip_smoke.py's three gallery levels.

    python3 scripts/probe_torch_sa_select.py [--root DIR] [--reps 10] [--layouts]

`--root` names the checkout whose text2loc_tpu_torch is timed (default: the
one holding this script), e.g. a parent commit unpacked with `git archive`
beside the working tree; run parent, change, change, parent in one call to
compare two trees on one card. The cases are the smoke's: 1792 clouds of 256
points (a 64-cell gallery), their FPS ladder's prefixes as centers, K = 32,
the levels P=256 S=128 6->32->64, P=128 S=64 67->128->128 and P=64 S=32
131->256->256 of Config(), in bf16 and f32, inputs made from a seed as the
smoke makes them. For each it prints one JSON line:

- `ms`: one wrapper call (ops/cuda_pointconv.sa_select_cuda) per CUDA event
  pair, median of `--reps`, as chip_smoke.py times it;
- `kernel_ms`: 50 wrapper calls between two events, queued behind a device
  sleep so that the host's dispatch is off the span, divided by 50
  (chip_smoke.kernel_ms);
- `plain_ms`: ops/pointconv.sa_select_plain, timed as `ms`;
- `edges`: the valid edges (selected neighbours) of the case;
- `plan`: the kernel's plan (tile rows, W2 resident, shared bytes, blocks
  per SM, column slices) and `ptxas`: its instantiation's registers and
  spill bytes from the build's ptxas output, where the checkout has a plan
  (null before the tensor-core kernel).

`--layouts` (a checkout with a plan) adds, per case, `layouts`: the
kernel alone (no launch count) on every tile layout it takes at the level,
{"rows,resident": [blocks per SM, ms]}, ms timed as `ms` on the persistent
grid of that layout's occupancy, the plan's choice among them.

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


def ptxas_of(_cuda, cp, dt, h1, h2):
    """Registers and spill bytes of the level's kernel instantiation."""
    tag = ("If" if dt == torch.float32 else "I13__nv_bfloat16") + f"Li{cp.width_class(h1, h2)}E"
    for name, info in _cuda.ptxas_report("sa_select.cu").items():
        if "sa_select_first_kernel" in name and tag in name:
            return info
    return None


def layout_times(smoke, _cuda, cp, a, s, dt, reps):
    """{"rows,resident": [blocks per SM, ms]} of the kernel alone on every
    tile layout it takes for the case's arguments `a`."""
    feat, pos, ctr, w1, wp, ab1, w2, ab2, radius, k = a
    n, p, c = feat.shape
    h1, h2 = w1.shape[1], w2.shape[1]
    lib, code = _cuda.library(), _cuda.DTYPE_CODE[dt]
    out = torch.empty((n, s, h2), dtype=dt, device=feat.device)
    sms = _cuda.sm_count(feat.device.index)
    times = {}
    for rows, resident, _ in cp.first_layouts(p, s, c, h1, h2, k, dt):
        occ = ctypes.c_int(0)
        lib.t2l_sa_select_occupancy(p, s, c, h1, h2, k, rows, resident, code,
                                    ctypes.byref(occ))
        if occ.value < 1:
            continue
        args = (*(_cuda.ptr(t) for t in (feat, pos, ctr, w1, wp, ab1, w2, ab2, out)),
                n, p, s, c, h1, h2, k, ctypes.c_float(radius * radius), rows, resident,
                min(n, sms * occ.value), code)
        times[f"{rows},{resident}"] = [occ.value, smoke.cuda_ms(
            lambda args=args: _cuda.launch(cp.KERNEL_FIRST, "t2l_sa_select_first", *args,
                                           count=False), reps)]
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--layouts", action="store_true",
                    help="time the kernel alone on every tile layout it takes")
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
    from text2loc_tpu_torch.ops.ballquery import ball_query_knn
    from text2loc_tpu_torch.ops.fps import farthest_point_sampling_plain
    from text2loc_tpu_torch.ops.pointconv import sa_select_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    n, k = 64 * 28, 32
    pts = smoke._clouds(gen, n, 256, dev)
    xyz = farthest_point_sampling_plain(pts, 128)[1]
    has_plan = hasattr(cp, "first_plan")
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
            a = (feat, pos, ctr, w1, w1[cin - 3:].contiguous(), ab1, w2, ab2, radius, k)

            def call(a=a):
                return cp.sa_select_cuda(*a, selection="first")

            plan = cp.first_plan(lp, s, cin, h1, h2, k, dt) if has_plan else None
            print(json.dumps({
                "root": root, "case": f"P={lp} S={s} {cin}->{h1}->{h2}",
                "dtype": str(dt).split(".")[-1],
                "edges": int(ball_query_knn(pos, ctr, radius, k, first=True)[1].sum()),
                "ms": smoke.cuda_ms(call, args.reps),
                "kernel_ms": smoke.kernel_ms(call, args.reps),
                "plain_ms": smoke.cuda_ms(lambda a=a: sa_select_plain(*a), args.reps),
                "plan": None if plan is None else plan._asdict(),
                "ptxas": ptxas_of(_cuda, cp, dt, h1, h2) if has_plan else None,
                **({"layouts": layout_times(smoke, _cuda, cp, a, s, dt, args.reps)}
                   if args.layouts and has_plan else {})}),
                  flush=True)
            pos = ctr
    return 0


if __name__ == "__main__":
    sys.exit(main())
