"""Split the fused feed-forward block's time on the card (`ffn_addln`,
d <= 256) into the kernel, the wrapper's host dispatch and its extra device
ops.

    python3 scripts/probe_torch_ffn_addln.py [--root DIR] [--reps 10]

`--root` names the checkout whose text2loc_tpu_torch is timed (default:
the one holding this script), e.g. a parent commit unpacked with `git
archive` beside the working tree; run parent, change, change, parent in
one call to compare two trees on one card. The shapes are chip_smoke.py's
three fused cases (the CCT over 640 x 16 rows at D=128, F=512; obj_inter at
D=256, F=512; the coarse inter head at D=256, F=1024), a batch-1 serve
request's three (the inter head over 6 rows, the CCT's hint and object
layers over the top-10 cells, 60 and 160 rows) and the batch-64 request's
CCT hint layer (3840 rows). Inputs as the smoke makes them: bf16 or f32
activations, f32 weights (as the model passes its parameters). For each
shape and dtype it prints one JSON line:

- `ms`: one wrapper call (ops/cuda_ffn.ffn_addln_cuda) per CUDA event pair,
  median of `--reps`, as chip_smoke.py times it: the host dispatch is
  inside it;
- `kernel_ms`: the fused kernel alone on inputs prepared as the kernel
  takes them (weights pre-cast where the kernel needs that),
  chip_smoke.py's kernel_ms: 50 back-to-back launches between two events,
  divided by 50, queued behind a device sleep so that the host's dispatch
  is outside;
- `device_ops`: device ops (kernels and copies) per wrapper call, from
  torch.profiler over `--reps` calls (a window with none taken again);
- `plain_ms`: ops/ffn.ffn_addln_plain, timed as `ms`;
- `plan`: the fused plan's tile rows, cluster and blocks, where the
  checkout plans one.

The inputs and timers are this checkout's chip_smoke.py's, so two
checkouts are timed alike. A checkout whose cuda_ffn has no fused_plan
(the fused kernel before its redesign) is timed through its own C entry,
on weights cast beforehand.

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
# (name, rows, D, F)
SMOKE = [("cct", 640 * 16, 128, 512), ("obj_inter", 64 * 28, 256, 512),
         ("inter head", 64 * 6, 256, 1024)]
REQUEST = [("req inter head", 6, 256, 1024), ("req cct hint", 60, 128, 512),
           ("req cct obj", 160, 128, 512), ("req64 cct hint", 3840, 128, 512)]


def device_ops(fn, reps: int) -> float:
    """Device ops per fn() under torch.profiler over `reps` calls; a window
    in which the profiler recorded no device op at all (it happens on the
    card) is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = sum(e.device_type == DeviceType.CUDA for e in prof.events())
        if ops:
            break
    return ops / reps


def bare_kernel(smoke, cuda_ffn, args):
    """fn() launching the kernel alone, with no count and no host-side
    preparation: the redesigned entry (chip_smoke._fused_ffn_fn, which takes
    the weights as the model gives them), or the earlier C entry
    t2l_ffn_addln on pre-cast weights."""
    if hasattr(cuda_ffn, "fused_plan"):
        return smoke._fused_ffn_fn(args)
    from text2loc_tpu_torch.ops import _cuda

    x, w1, b1, w2, b2, g, be = args
    dt = x.dtype
    d, f = w1.shape
    w1c, w2c, out = w1.to(dt).contiguous(), w2.to(dt).contiguous(), torch.empty_like(x)
    fn = _cuda.library().t2l_ffn_addln
    rest = (x.numel() // d, d, f, ctypes.c_float(1e-5), _cuda.DTYPE_CODE[dt])

    def run():
        fn(*(_cuda.ptr(t) for t in (x, w1c, b1, w2c, b2, g, be, out)), *rest,
           torch.cuda.current_stream().cuda_stream)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_ffn_addln: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # This checkout's chip_smoke.py (its timers and inputs), whatever --root is.
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from text2loc_tpu_torch.ops import _cuda, cuda_ffn
    from text2loc_tpu_torch.ops.ffn import ffn_addln_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.library()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED)
    for dt in (torch.bfloat16, torch.float32):
        for name, rows, d, f in SMOKE + REQUEST:
            a = smoke._ffn_args(gen, dev, dt, rows, d, f)

            def call(a=a):
                return cuda_ffn.ffn_addln_cuda(*a)

            plan = (cuda_ffn.fused_plan(rows, d, f, dt, sms=sms)
                    if hasattr(cuda_ffn, "fused_plan") else None)
            print(json.dumps({
                "root": root, "case": f"{name} R={rows} D={d} F={f}",
                "dtype": str(dt).split(".")[-1], "route": cuda_ffn.route(d, f, dt),
                "plan": None if plan is None else [plan.rows, plan.cluster, plan.blocks],
                "ms": smoke.cuda_ms(call, args.reps),
                "kernel_ms": smoke.kernel_ms(bare_kernel(smoke, cuda_ffn, a), args.reps),
                "device_ops": device_ops(call, args.reps),
                "plain_ms": smoke.cuda_ms(lambda a=a: ffn_addln_plain(*a), args.reps)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
