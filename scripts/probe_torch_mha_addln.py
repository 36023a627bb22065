"""Split the attention block's time on the card (`mha_addln`, d <= 256, and
`mha_addln_tiled`, the tiled chain) into the kernels, the wrapper's host
dispatch and its extra device ops.

    python3 scripts/probe_torch_mha_addln.py [--root DIR] [--reps 10] [--cases all|fused|tiled]

`--root` names the checkout whose text2loc_tpu_torch is timed (default:
the one holding this script), e.g. a parent commit unpacked with `git
archive` beside the working tree. The shapes (`--cases fused`) are
chip_smoke.py's six fused cases (B = 640 or 64) and a batch-1 serve
request's eight blocks, six
shapes: the coarse inter head and the layer-0 hint block at B = 1, the CCT
blocks over the top-10 cells at B = 10. Two more shapes that the fused
block took before its redesign and the tiled chain takes after it:
self-attention over 48 keys at D=128 (both dtypes), cross-attention of 56
queries over 8 keys at D=256 (f32; bf16 stays fused). `--cases tiled`:
chip_smoke.py's three tiled cases at E=1024 (the intra stack, 1584
sentences of 16 tokens; self 128x128 and cross 16x600 at B=16, which take
the attention core's two sweeps), each line also with its stages'
`kernel_ms` (`project_ms`, `core_ms`, `out_addln_ms`: the stage wrappers of
ops/cuda_mha.py on the plain stages' inputs, as the smoke checks them; in
f32, where the products read the weights' TF32 split, `split_ms`, the
split of the four weights alone (ops/cuda_split.split_t_cuda), which the
whole call's `kernel_ms` includes and the stages' exclude).
Inputs as the smoke makes them:
bf16 or f32 activations, f32 weights (as the model passes its
parameters), a bool key mask with a quarter of the keys padded. For each
shape and dtype it prints one JSON line:

- `ms`: one wrapper call (ops/cuda_mha.mha_addln_cuda) per CUDA event
  pair, median of `--reps`, as chip_smoke.py times it: the host dispatch
  is inside it;
- `kernel_ms`: the fused kernel alone on inputs prepared as the kernel
  takes them (weights pre-cast where the kernel needs that), chip_smoke.py's
  kernel_ms: 50 back-to-back launches between two events, divided by 50,
  queued behind a device sleep so that the host's dispatch is outside;
  where `route` is "tiled", the whole wrapper call timed so (the chain's
  kernels and its casts, without the host's dispatch);
- `device_ops`: device ops (kernels and copies) per wrapper call, from
  torch.profiler over `--reps` calls;
- `stock_ms`: the port's fused_attn="0" block (chip_smoke.py's
  _stock_attention_fn), timed as `ms`.

The inputs, timers and yardstick are this checkout's chip_smoke.py's, so
two checkouts are timed alike. A checkout whose cuda_mha has no
launch_fused (the fused kernel before its redesign) is timed through its
own C entry, on weights cast and a key bias built beforehand.

The first line is the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
HEADS = 4
# (name, B, Lq, Lk, D, self-attention, one sample with every key masked)
SMOKE = [("cct obj cross", 640, 16, 6, 128, False, False),
         ("cct hint cross", 640, 6, 16, 128, False, False),
         ("cct obj self", 640, 16, 16, 128, True, False),
         ("cct hint self", 64, 6, 6, 128, True, True),
         ("obj_inter", 64, 28, 28, 256, True, False),
         ("inter head", 64, 6, 6, 256, True, False)]
REQUEST = [("req inter head", 1, 6, 6, 256, True, False),
           ("req hint pre", 1, 6, 6, 128, True, False),
           ("req obj cross", 10, 16, 6, 128, False, False),
           ("req hint cross", 10, 6, 16, 128, False, False),
           ("req obj self", 10, 16, 16, 128, True, False),
           ("req hint self", 10, 6, 6, 128, True, False)]
MOVED = [("moved self 48", 9, 48, 48, 128, True, False),
         ("moved cross 56x8", 64, 56, 8, 256, False, False)]
TILED = [("intra E=1024", 1584, 16, 16, 1024, True, False),
         ("long self", 16, 128, 128, 1024, True, True),
         ("long cross", 16, 16, 600, 1024, False, True)]


def device_ops(fn, reps: int) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events()) / reps


def bare_kernel(smoke, cuda_mha, args):
    """fn() launching the kernel alone, with no count and no host-side
    preparation: the redesigned entry (cuda_mha.launch_fused, which takes
    the weights and the mask as the model gives them), or the earlier C
    entry t2l_mha_addln on pre-cast weights and a pre-built key bias."""
    if hasattr(cuda_mha, "launch_fused"):
        return smoke._fused_attention_fn(args)
    from text2loc_tpu_torch.ops import _cuda
    from text2loc_tpu_torch.ops.mha import key_bias

    x, kv, wq, bq, wk, bk, wv, bv, wo, bo, g, be, mask = args
    out = torch.empty_like(x)
    dt = x.dtype
    b, lq, d = x.shape
    lk = kv.shape[1]
    mats = [t.to(dt).contiguous() for t in (wq, wk, wv, wo)]
    kb = key_bias(mask, b, lk, x.device).contiguous()
    ptrs = [_cuda.ptr(t) for t in (x, kv, kb, mats[0], bq, mats[1], bk, mats[2], bv,
                                   mats[3], bo, g, be, out)]
    fn = _cuda.library().t2l_mha_addln
    rest = (b, lq, lk, d, HEADS, ctypes.c_float(1.0 / math.sqrt(d // HEADS)),
            ctypes.c_float(1e-5), int(kv is x), _cuda.DTYPE_CODE[dt])

    def run():
        fn(*ptrs, *rest, torch.cuda.current_stream().cuda_stream)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", choices=("all", "fused", "tiled"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_mha_addln: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # This checkout's chip_smoke.py (its timers and inputs), whatever --root is.
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from text2loc_tpu_torch.ops import _cuda, cuda_mha, mha
    try:
        from text2loc_tpu_torch.ops.cuda_split import split_t_cuda as split_t
    except ImportError:   # a checkout whose f32 products read the weights as given
        split_t = None

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    cases = ((SMOKE + REQUEST + MOVED if args.cases != "tiled" else [])
             + (TILED if args.cases != "fused" else []))
    for dt in (torch.bfloat16, torch.float32):
        for name, b, lq, lk, d, self_attn, empty in cases:
            a = smoke._attention_args(gen, dev, dt, b, lq, lk, d, self_attn, empty)
            route = cuda_mha.route(lq, lk, d, HEADS, dt, self_attn=self_attn)

            def call(a=a):
                return cuda_mha.mha_addln_cuda(*a, num_heads=HEADS)

            bare = bare_kernel(smoke, cuda_mha, a) if route == "fused" else call
            stages = {}
            if (name, b, lq, lk, d, self_attn, empty) in TILED:
                x, kv, wq, bq, wk, bk, wv, bv, wo, bo, g, be, mask = a
                q, k, v = mha.mha_project_plain(x, kv, wq, bq, wk, bk, wv, bv, num_heads=HEADS)
                o = mha.mha_core_plain(q, k, v, mask, num_heads=HEADS)
                # In f32, where the products read the weights' TF32 split:
                # the split alone, and the stages on a split made beforehand.
                proj, out, timed = {}, {}, []
                if split_t is not None and dt == torch.float32:
                    hi, lo = split_t([wq, wk, wv, wo])
                    n3 = 3 * d * d
                    proj, out = {"split": (hi[:n3], lo[:n3])}, {"split": (hi[n3:], lo[n3:])}
                    timed.append(("split_ms", lambda: split_t([wq, wk, wv, wo])))
                timed += [
                    ("project_ms", lambda: cuda_mha.tiled_project_cuda(
                        x, kv, wq, bq, wk, bk, wv, bv, num_heads=HEADS, **proj)),
                    ("core_ms", lambda: cuda_mha.tiled_core_cuda(q, k, v, mask,
                                                                 num_heads=HEADS)),
                    ("out_addln_ms", lambda: cuda_mha.tiled_out_addln_cuda(x, o, wo, bo, g,
                                                                           be, **out))]
                stages = {key: smoke.kernel_ms(fn, args.reps) for key, fn in timed}
            print(json.dumps({
                "root": root, "case": f"{name} B={b} Lq={lq} Lk={lk} D={d}",
                "dtype": str(dt).split(".")[-1], "route": route,
                "ms": smoke.cuda_ms(call, args.reps),
                "kernel_ms": smoke.kernel_ms(bare, args.reps),
                "device_ops": device_ops(call, args.reps),
                "stock_ms": smoke.cuda_ms(smoke._stock_attention_fn(a, dt), args.reps),
                "plain_ms": smoke.cuda_ms(lambda a=a: mha.mha_addln_plain(*a, num_heads=HEADS),
                                          args.reps), **stages}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
