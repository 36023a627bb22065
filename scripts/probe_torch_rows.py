"""Time the row gather (`gather_rows`, `gather_rows_scatter`) and farthest-
point sampling (`fps`) on the card at chip_smoke.py's shapes.

    python3 scripts/probe_torch_rows.py [--root DIR] [--reps 10]

`--root` names the checkout whose text2loc_tpu_torch is timed (default:
the one holding this script), e.g. a parent commit unpacked with `git
archive` beside the working tree; run parent, change, change, parent in
one call to compare two trees on one card. The inputs and timers are this
checkout's chip_smoke.py's, so two checkouts are timed alike on the same
data. Cases: FPS over the smoke's 1792 clouds of 256 points to 128 samples
and the coarse train step's 896; the gather at the smoke's gallery shapes
(1792 clouds; P, Q, C of the three SA levels with mode off) in bf16 and
f32, and at its probe shapes (896 clouds) in f32, with the scatter-add at
the probe shapes. For each case one JSON line:

- `ms`: one wrapper call per CUDA event pair, median of `--reps`, as
  chip_smoke.py times it (the host's dispatch inside);
- `kernel_ms`: chip_smoke.py's kernel_ms, 50 wrapper calls queued behind a
  device sleep between two events, divided by 50 (the dispatch outside);
- `host_us`: the wrapper's host time a call, microseconds: 100 calls by
  the host's clock without waiting for the card, median of `--reps`;
- `plain_ms`: the plain PyTorch version; `library_ms`: one PyTorch call for
  the same function (torch.gather, scatter_add_), none for FPS;
- `bound_ms` and `bound_by`: the smoke's bound (bytes over 3.35 TB/s or
  FLOPs over 67 TFLOP/s f32, the larger); FPS also `chain_floor_ms`, a model
  of its dependent chain: S - 1 rounds of 100 cycles at the card's largest
  SM clock;
- `equal`: the kernel's output bit-equal to the plain version's (the
  scatter-add: two calls bit-equal);
- `plan`: the checkout's launch plan, where it has one.

Before them, one line with each source's registers and spills per kernel
from the build's ptxas output. The first line is the card's nvidia-smi name
and power limit.
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
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_rows: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # This checkout's chip_smoke.py (its timers and inputs), whatever --root is.
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from text2loc_tpu_torch.ops import _cuda, cuda_fps, cuda_gather, fps, gather

    print(_smi("name,power.limit"), flush=True)
    max_clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.library()
    print(json.dumps({"root": root, "ptxas": {src: _cuda.ptxas_report(src)
                                              for src in ("fps.cu", "gather_rows.cu")}}),
          flush=True)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(smoke.SEED)
    reps = args.reps

    def host_us(fn, calls=100):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    def emit(case, dtype, fn, plain, work, equal, library=None, plan=None, **extra):
        op_s, byte_s = smoke.bound(*work)
        print(json.dumps({
            "root": root, "case": case, "dtype": str(dtype).split(".")[-1],
            "ms": smoke.cuda_ms(fn, reps), "kernel_ms": smoke.kernel_ms(fn, reps),
            "host_us": host_us(fn),
            "plain_ms": smoke.cuda_ms(plain, reps),
            "library_ms": smoke.cuda_ms(library, reps) if library else None,
            "bound_ms": max(op_s, byte_s) * 1e3,
            "bound_by": "operations" if op_s >= byte_s else "bytes", **extra,
            "equal": equal, "plan": dataclasses.asdict(plan) if plan else None}), flush=True)

    p, s = 256, 128
    for n in (64 * 28, 32 * 28):
        pts = smoke._clouds(gen, n, p, dev)
        idx, xyz = cuda_fps.farthest_point_sampling_cuda(pts, s)
        want_idx, want_xyz = fps.farthest_point_sampling_plain(pts, s)
        emit(f"fps {n}x{p}->{s}", torch.float32,
             lambda pts=pts: cuda_fps.farthest_point_sampling_cuda(pts, s),
             lambda pts=pts: fps.farthest_point_sampling_plain(pts, s),
             (8.0 * n * (s - 1) * p, n * p * 12 + n * s * 16, torch.float32),
             torch.equal(idx, want_idx) and torch.equal(xyz, want_xyz),
             plan=cuda_fps.fps_plan(p, s) if hasattr(cuda_fps, "fps_plan") else None,
             chain_floor_ms=(s - 1) * 100 / max_clock_hz * 1e3)

    def gather_case(n, p, q, c, dt, tag):
        values = smoke._rand(gen, (n, p, c), 1.0, dev).to(dt)
        idx = torch.randint(0, p, (n, q), generator=gen).to(torch.int32).to(dev)
        full = idx.long()[..., None].expand(n, q, c)
        es = values.element_size()
        got = cuda_gather.gather_rows_cuda(values, idx)
        plan = (cuda_gather.gather_plan(n, p, q, c * es, sms=sms)
                if hasattr(cuda_gather, "gather_plan") else None)
        emit(f"gather_rows {tag} N={n} P={p} Q={q} C={c}", dt,
             lambda: cuda_gather.gather_rows_cuda(values, idx),
             lambda: gather.gather_rows_plain(values, idx),
             (0.0, n * p * c * es + n * q * 4 + n * q * c * es, torch.float32),
             torch.equal(got, gather.gather_rows_plain(values, idx)),
             library=lambda: torch.gather(values, 1, full), plan=plan)
        return idx, full

    for dt in (torch.bfloat16, torch.float32):
        for p, q, c in smoke.GATHER_GALLERY:
            gather_case(64 * 28, p, q, c, dt, "gallery")
    for p, q, c in smoke.GATHER_PROBE:
        n = 32 * 28
        idx, full = gather_case(n, p, q, c, torch.float32, "probe")
        g = smoke._rand(gen, (n, q, c), 1.0, dev)
        got = cuda_gather.scatter_rows_cuda(g, idx, p)
        again = cuda_gather.scatter_rows_cuda(g, idx, p)
        emit(f"gather_rows_scatter probe N={n} P={p} Q={q} C={c}", torch.float32,
             lambda: cuda_gather.scatter_rows_cuda(g, idx, p),
             lambda: gather.scatter_rows_plain(g, idx, p),
             (1.0 * n * q * c, n * q * c * 4 + n * q * 4 + n * p * c * 4, torch.float32),
             torch.equal(got, again),
             library=lambda: torch.zeros((n, p, c), device=dev).scatter_add_(1, full, g))
    return 0


if __name__ == "__main__":
    sys.exit(main())
